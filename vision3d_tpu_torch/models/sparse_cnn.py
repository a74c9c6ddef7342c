"""SpMiddleFHD sparse middle extractors (port of
``vision3d_tpu/models/sparse_cnn.py``) on three representations, for
inference and for training. Four blocks of submanifold + strided convs take
voxel features at grid (41, 1600, 1408) ZYX down to (2, 200, 176), then
collapse z into a (ny, nx, C*D) BEV map; channels 4 -> 16 -> 32 -> 64 ->
64, BN eps 1e-3.

``SpMiddleFHD.forward`` is one loop over the blocks: cut over to a dense
volume at ``cfg.dense_from_stage`` (``train_dense_from_stage`` in
training), plan the stage (one ``StagePlan``), run the submanifold convs
and the strided conv, collect the scales. Each representation does those
steps (``densify``, ``plan``, ``subm``, ``down``), ``to_bev`` and
``to_voxel_sparse`` its own way. The conv modules hold only parameters and
geometry, and every conv ends in the one epilogue ``bn_relu``.

- ``SparseTensor`` (voxel backend), key-sorted (B, N, C): z-window
  rulebooks on the ``zwin_conv`` kernel; in training full-tap rulebooks on
  ``gather_gemm`` (forward and dX) and ``gather_rows`` (dW's regather).
- ``ColumnTensor`` (``sparse_backend = "column"``, ``ops/column_sparse.py``):
  sparse in BEV, dense in z, flat z-major (B, Ncol, D*C) rows; BEV-column
  rulebooks through ``ColumnConvFn``; one-pass BN statistics in training.
- ``DenseTensor``: (B, C, D, H, W) feats in channels-last-3d memory (cuDNN's
  layout) and (B, D, H, W) occupancy; cuDNN conv3d masked to the exact
  spconv active set, trained by autograd.

One state dict serves every representation. Weights keep the JAX layout
(K*Cin, Cout), K = (dz*ky + dy)*kx + dx.
"""

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.ops import bn_relu as epilogue
from vision3d_tpu_torch.ops import column_sparse as csp
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops.column_conv import ColumnConvFn
from vision3d_tpu_torch.ops.zwin_conv import zwin_conv
from vision3d_tpu_torch.parallel.mesh import global_sum
from vision3d_tpu_torch.training.profiler import annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class StagePlan:
    """A stage's rulebooks: ``subm`` (z-window (start, pattern), full-tap rows
    if ``train``, BEV rows on columns); on voxels the strided conv's ``down``,
    its transpose ``down_t`` (``train`` only), the output ``keys``, ``mask``."""
    stage: int
    train: bool = False
    subm: object = None
    down: object = None
    down_t: torch.Tensor = None
    keys: torch.Tensor = None
    mask: torch.Tensor = None


@dataclass
class SparseTensor:
    feats: torch.Tensor  # (B, N, C)
    keys: torch.Tensor   # (B, N) int32, sorted, sentinel-padded
    mask: torch.Tensor   # (B, N) bool
    grid: tuple

    @property
    def coords(self):
        """(B, N, 3) ZYX coords (zeros at padding)."""
        return sp.keys_to_coords(torch.where(self.mask, self.keys, 0), self.grid)

    def densify(self, cfg, si, train, keep_keys, diag):
        if train:
            return dense_from_sparse(self, keep_keys)
        x, diag[f"stage{si}_densify_dropped"] = dense_from_sparse_cols(
            self, cfg.stage_column_capacity(si), keep_keys)
        return x

    def plan(self, cfg, si, conv, has_subm, train, diag):
        args = (self.keys, self.mask, self.grid, conv.kernel, conv.stride, conv.pad,
                conv.out_cap)
        subm = (3, 3, 3) if has_subm else None
        rbt = None
        with annotate("plan"):
            if train:
                rb, rbd, rbt, ok, om, ndrop = sp.plan_stage_train_batched(
                    *args, subm_kernel=subm)
            else:
                rb, rbd, ok, om, ndrop = sp.plan_stage_batched(
                    *args, subm_kernel=subm, subm_col_cap=cfg.stage_column_capacity(si),
                    down_col_cap=conv.out_col_cap)
        diag[f"stage{si + 1}_dropped"] = ndrop   # output sites the capacity cut
        return StagePlan(si, train, rb, rbd, rbt, ok, om)

    def subm(self, conv, plan):
        # in training a full-tap rulebook: conv-as-backward autograd function
        return replace(self, feats=bn_relu(
            conv.bn,
            sp.SubmConvFn.apply(self.feats, plan.subm, conv.weight, conv.cdt)
            if plan.train else zwin_conv(self.feats, *plan.subm, conv.weight, conv.kernel,
                                         conv.cdt),
            self.mask))

    def down(self, conv, plan, diag):
        return SparseTensor(feats=bn_relu(
            conv.bn,
            sp.DownConvFn.apply(self.feats, plan.down, plan.down_t, conv.weight, conv.cdt)
            if plan.train else zwin_conv(self.feats, *plan.down, conv.weight, conv.kernel,
                                         conv.cdt),
            plan.mask), keys=plan.keys, mask=plan.mask, grid=conv.out_grid(self.grid))

    def to_bev(self):
        dense = sp.to_dense(self.feats, self.keys, self.mask, self.grid)  # (B, D, H, W, C)
        b, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)

    def to_voxel_sparse(self, cap=None):
        return self


@dataclass
class ColumnTensor:
    """Column-sparse tensor: the channel count rides along as ``c``."""
    feats: torch.Tensor  # (B, Ncol, D*C) flat z-major rows
    zmask: torch.Tensor  # (B, Ncol, D) bool
    keys: torch.Tensor   # (B, Ncol) int32 sorted BEV keys y*W + x
    mask: torch.Tensor   # (B, Ncol) bool
    grid: tuple
    c: int = 4

    def to_voxel_sparse(self, cap: int) -> SparseTensor:
        """The active sites as a voxel-sparse tensor of capacity ``cap``,
        float32, in column-major key order (``ColumnTensor.to_voxel_sparse``,
        vision3d_tpu/models/sparse_cnn.py:61). The sites are gathered before
        the cast, so a bf16 tensor is not copied whole to float32; each
        site is read once, so the gather's backward is a scatter into
        zeros."""
        b, n, _ = self.feats.shape
        f4 = self.feats.reshape(b, n, self.grid[0], self.c)
        f, k, m = csp.columns_to_voxels(f4, self.zmask, self.keys, self.mask,
                                        self.grid, cap)
        return SparseTensor(feats=f.float(), keys=k, mask=m, grid=self.grid)

    def densify(self, cfg, si, train, keep_keys, diag):
        return dense_from_columns(self, keep_keys=keep_keys,
                                  voxel_cap=cfg.stage_voxel_capacity(si))

    def plan(self, cfg, si, conv, has_subm, train, diag):
        if not has_subm:
            return StagePlan(si, train)
        with annotate("plan"):
            rb = csp.build_bev_rulebook_batched(self.keys, self.mask, self.grid[1:],
                                                (3, 3), (1, 1), (1, 1))
        return StagePlan(si, train, rb)

    def subm(self, conv, plan):
        # a subm conv's rulebook is its own transpose: dX runs over it
        out = ColumnConvFn.apply(self.feats, plan.subm, plan.subm, conv.weight, conv.kernel,
                                 self.grid[0], self.c, 1, conv.kernel[0] // 2, conv.cdt)
        site = self.zmask & self.mask[..., None]
        y = bn_relu(conv.bn, out.reshape(*site.shape, -1), site, dtype=conv.cdt,
                    one_pass=True)
        return replace(self, feats=y.reshape(*site.shape[:2], -1), c=conv.weight.shape[1])

    def down(self, conv, plan, diag):
        """Plans (after the submanifold convs) and runs the strided conv."""
        out_grid = conv.out_grid(self.grid)
        kyx, syx, pyx = conv.kernel[1:], conv.stride[1:], conv.pad[1:]
        in_hw, out_hw = self.grid[1:], out_grid[1:]
        with annotate("plan"):
            if kyx == (1, 1) and syx == (1, 1):
                # BEV-identity down conv (the (3, 1, 1) stage): same column set
                ok, om = self.keys, self.mask
                ndrop = torch.zeros_like(self.keys[:, 0])
            else:
                ok, om, ndrop = csp.downsample_bev_columns(
                    self.keys, self.mask, in_hw, kyx, syx, pyx, conv.out_col_cap, out_hw)
            rb = csp.build_bev_rulebook_batched(self.keys, self.mask, in_hw, kyx, syx, pyx,
                                                out_keys=ok, out_mask=om, out_hw=out_hw)
            # the transposed rulebook only serves the backward's dX
            rbt = (csp.transpose_bev_rulebook_batched(self.keys, self.mask, in_hw, kyx, syx,
                                                      pyx, ok, om, out_hw)
                   if torch.is_grad_enabled() and self.feats.requires_grad else None)
        of = ColumnConvFn.apply(self.feats, rb, rbt, conv.weight, conv.kernel, self.grid[0],
                                self.c, conv.stride[0], conv.pad[0], conv.cdt)
        oz = csp.column_occupancy_batched(self.zmask, rb, conv.kernel, conv.stride[0],
                                          conv.pad[0])
        diag[f"stage{plan.stage + 1}_columns_dropped"] = ndrop   # output columns cut
        site = oz & om[..., None]
        y = bn_relu(conv.bn, of.reshape(*site.shape, -1), site, dtype=conv.cdt,
                    one_pass=True)
        return ColumnTensor(feats=y.reshape(*site.shape[:2], -1), zmask=oz, keys=ok,
                            mask=om, grid=out_grid, c=conv.weight.shape[1])

    def to_bev(self):
        return csp.columns_to_bev_batched(self.feats, self.zmask, self.keys, self.mask,
                                          self.grid, self.c)


@dataclass
class DenseTensor:
    """``keys`` / ``mask`` (the compact key set, as a SparseTensor's) ride
    along only when a consumer needs the sparse form (PV-RCNN's scales)."""
    feats: torch.Tensor  # (B, C, D, H, W), channels-last-3d memory
    occ: torch.Tensor    # (B, D, H, W) bool: the exact spconv active set
    grid: tuple
    keys: torch.Tensor = None   # (B, N) int32
    mask: torch.Tensor = None   # (B, N) bool

    def to_voxel_sparse(self, cap=None) -> SparseTensor:
        """The features at the kept key set (``cap`` unused), float32, zero
        at padding. The volume is z-major, so column-major key (y*W + x)*D + z
        reads raster row z*H*W + y*W + x (``DenseTensor.to_voxel_sparse``,
        vision3d_tpu/models/sparse_cnn.py:107, its non-hwdc branch)."""
        d, h, w = self.grid
        b, c = self.feats.shape[:2]
        flat = self.feats.permute(0, 2, 3, 4, 1).reshape(b, d * h * w, c)
        k = torch.where(self.mask, self.keys, 0).long()
        raster = (k % d) * (h * w) + k // d
        bidx = torch.arange(b, device=k.device)[:, None]
        f = torch.where(self.mask[..., None], flat[bidx, raster].float(), 0.0)
        return SparseTensor(feats=f, keys=self.keys, mask=self.mask, grid=self.grid)

    def densify(self, cfg, si, train, keep_keys, diag):
        return self

    def plan(self, cfg, si, conv, has_subm, train, diag):
        return StagePlan(si, train)

    def subm(self, conv, plan):
        return replace(self, feats=bn_relu(
            conv.bn, _dense_conv(self.feats, conv.weight, conv.kernel, (1, 1, 1), (1, 1, 1),
                                 conv.cdt),
            self.occ, channel_dim=1, dtype=conv.cdt))

    def down(self, conv, plan, diag):
        of = bn_relu(
            conv.bn,
            _dense_conv(self.feats, conv.weight, conv.kernel, conv.stride, conv.pad, conv.cdt),
            oz := dense_dilate_occ(self.occ, conv.kernel, conv.stride, conv.pad),
            channel_dim=1, dtype=conv.cdt)
        okeys = omask = None
        if self.keys is not None:
            with annotate("plan"):
                okeys, omask, _ = sp.downsample_active_set(
                    self.keys, self.mask, self.grid, conv.kernel, conv.stride, conv.pad,
                    conv.out_cap)
        return DenseTensor(feats=of, occ=oz, grid=conv.out_grid(self.grid), keys=okeys,
                           mask=omask)

    def to_bev(self):
        b, c, d, h, w = self.feats.shape
        f = torch.where(self.occ[:, None], self.feats, 0.0)
        return f.reshape(b, c * d, h, w).permute(0, 2, 3, 1)


def from_voxels(feats, coords, mask, grid) -> SparseTensor:
    f, k, m = sp.make_sorted(feats, coords, mask, grid)
    return SparseTensor(feats=f, keys=k, mask=m, grid=grid)


def from_voxels_columns(feats, coords, mask, grid, ncol_cap: int):
    """Returns (ColumnTensor, n_dropped (B,) int32: active columns the
    capacity ``ncol_cap`` truncated)."""
    f, z, k, m, ndrop = csp.columns_from_voxels_batched(feats, coords, mask,
                                                        grid, ncol_cap)
    return ColumnTensor(feats=f, zmask=z, keys=k, mask=m, grid=grid,
                        c=feats.shape[-1]), ndrop


def dense_from_columns(ct: ColumnTensor, keep_keys: bool = False,
                       voxel_cap: int = 0) -> DenseTensor:
    """ColumnTensor -> DenseTensor cutover for the dense late stages: a BEV
    slot map, then every cell fetches its column's flat (D*C) row (a miss
    reads a zero row), and one transpose into the z-major
    channels-last-3d layout (``dense_from_columns``,
    vision3d_tpu/models/sparse_cnn.py:270). Where the rows take a
    gradient, the fetch is ``sp.DensifyFn`` on the ``gather_rows`` kernel:
    each column row is read by one cell, its own, so its gradient is one
    gather there. ``keep_keys`` carries the voxel keys and mask of
    ``ct.to_voxel_sparse(voxel_cap or Ncol * D)`` along (PV-RCNN's scales):
    column-major keys, which ``DenseTensor.to_voxel_sparse`` reads back
    from the z-major volume; JAX's volume is (B, H, W, D, C) there
    (``hwdc``), whose raster row is the key itself."""
    d, h, w = ct.grid
    b, n, _ = ct.feats.shape
    hw, c = h * w, ct.c
    dev = ct.feats.device
    slot = torch.full((b, hw + 1), n, dtype=torch.int64, device=dev)
    slot.scatter_(1, torch.where(ct.mask, ct.keys, hw).long(),
                  torch.arange(n, device=dev).expand(b, n))
    slot = (slot[:, :hw] + torch.arange(b, device=dev)[:, None] * (n + 1)).reshape(-1)
    table = F.pad(ct.feats, (0, 0, 0, 1)).reshape(b * (n + 1), d * c)
    if torch.is_grad_enabled() and table.requires_grad:
        own = torch.where(ct.mask, ct.keys, 0) + torch.arange(b, device=dev)[:, None] * hw
        rows = sp.DensifyFn.apply(table, slot.to(torch.int32),
                                  F.pad(own, (0, 1)).reshape(-1).to(torch.int32),
                                  F.pad(ct.mask, (0, 1)).reshape(-1))
    else:
        rows = table[slot]
    feats = rows.reshape(b, h, w, d, c).permute(0, 4, 3, 1, 2)
    zt = F.pad(ct.zmask, (0, 0, 0, 1)).reshape(b * (n + 1), d)
    occ = zt[slot].reshape(b, h, w, d).permute(0, 3, 1, 2).contiguous()
    keys = mask = None
    if keep_keys:
        vs = ct.to_voxel_sparse(voxel_cap or n * d)
        keys, mask = vs.keys, vs.mask
    return DenseTensor(
        feats=feats.contiguous(memory_format=torch.channels_last_3d),
        occ=occ, grid=ct.grid, keys=keys, mask=mask)


def dense_from_sparse(st: SparseTensor, keep_keys: bool = False) -> DenseTensor:
    """Densify a sparse tensor for the dense late stages of TRAINING, by
    one all-cells row gather (``dense_from_sparse``,
    vision3d_tpu/models/sparse_cnn.py:197): no column cap, no drop count.
    Each cell's source row is the row whose key is that cell (keys are
    unique), or the zero row N; the JAX code finds it from CSR records
    (colstart + popcount), here a scatter of row numbers into a z-major
    raster of the cells finds the same row. The gather is ``sp.DensifyFn``
    (the ``gather_rows`` kernel), whose backward is one gather at each
    row's own cell. ``keep_keys`` carries the input's keys and mask along."""
    d, h, w = st.grid
    b, n, c = st.feats.shape
    cells = d * h * w
    dev = st.feats.device
    k = torch.where(st.mask, st.keys, 0)
    own = (k % d) * (h * w) + k // d                      # z-major raster cell
    idx = torch.full((b, cells + 1), n, dtype=torch.int32, device=dev)
    idx.scatter_(1, torch.where(st.mask, own, cells).long(),
                 torch.arange(n, dtype=torch.int32, device=dev).expand(b, n))
    idx = idx[:, :cells]
    occ = (idx < n).reshape(b, d, h, w)
    bidx = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    table = F.pad(st.feats, (0, 0, 0, 1)).reshape(b * (n + 1), c)
    rows = sp.DensifyFn.apply(table, (idx + bidx * (n + 1)).reshape(-1),
                              F.pad(own + bidx * cells, (0, 1)).reshape(-1).to(torch.int32),
                              F.pad(st.mask, (0, 1)).reshape(-1))
    feats = rows.reshape(b, d, h, w, c).permute(0, 4, 1, 2, 3)
    return DenseTensor(feats=feats, occ=occ, grid=st.grid,
                       keys=st.keys if keep_keys else None,
                       mask=st.mask if keep_keys else None)


def dense_from_sparse_cols(st: SparseTensor, ncol_cap: int,
                           keep_keys: bool = False):
    """Densify a sparse tensor, keeping at most ``ncol_cap`` active BEV
    columns per sample (the lowest column keys, as
    ``vision3d_tpu.ops.sparse.build_col_compact`` keeps them).

    Returns (DenseTensor, ncol_dropped (B,) int32). Sites of dropped
    columns are absent from the dense volume; callers surface the count.
    ``keep_keys`` carries the input's keys and mask, all of them, along.
    """
    d, h, w = st.grid
    b, n, c = st.feats.shape
    dev = st.feats.device
    cell = st.keys // d
    first = st.mask.clone()
    first[:, 1:] &= cell[:, 1:] != cell[:, :-1]
    colslot = first.to(torch.int32).cumsum(dim=1) - 1
    ncol_dropped = (first.sum(dim=1) - ncol_cap).clamp(min=0).to(torch.int32)
    keep = st.mask & (colslot < ncol_cap)
    z = st.keys % d
    total = b * d * h * w
    bidx = torch.arange(b, device=dev)[:, None]
    # z-major raster (b, z, y, x): unique per kept site, drop row at total
    flat = torch.where(keep, (bidx * d + z) * (h * w) + torch.where(keep, cell, 0),
                       total).reshape(-1)
    dense = torch.zeros((total + 1, c), dtype=st.feats.dtype, device=dev)
    dense[flat] = st.feats.reshape(-1, c)
    occ = torch.zeros((total + 1,), dtype=torch.bool, device=dev)
    with annotate("sync"):
        occ[flat] = True
    feats = dense[:total].reshape(b, d, h, w, c).permute(0, 4, 1, 2, 3)
    occ = occ[:total].reshape(b, d, h, w)
    return DenseTensor(feats=feats, occ=occ, grid=st.grid,
                       keys=st.keys if keep_keys else None,
                       mask=st.mask if keep_keys else None), ncol_dropped


def dense_dilate_occ(occ, kernel, stride, pad):
    """spconv strided-conv active set: any active input in the window."""
    x = occ[:, None].to(torch.float32)
    return F.max_pool3d(x, kernel, stride, pad)[:, 0] > 0


def _dense_conv(x, weight, kernel, stride, pad, cdt):
    """conv3d (cross-correlation, as JAX's conv_general_dilated) in the
    compute dtype, the (K*Cin, Cout) weight read as (Cout, Cin, kz, ky, kx);
    the result stays in the compute dtype (``bn_relu`` reads it as is)."""
    wk = weight.reshape(*kernel, -1, weight.shape[1]).permute(4, 3, 0, 1, 2)
    wk = wk.to(cdt).contiguous(memory_format=torch.channels_last_3d)
    return F.conv3d(x.to(cdt), wk, stride=stride, padding=pad)


class MaskedBatchNorm(nn.Module):
    """Batch norm over the channel axis that ignores and zeroes masked-off
    rows (eps 1e-3). In training mode the statistics are the masked mean
    and the BIASED variance of the batch (count clamped to 1), also for
    the running update, with momentum 0.01 in torch's convention (flax
    0.99), as ``vision3d_tpu/models/sparse_cnn.py:405-413``; under a
    process group they are the global batch's (the sums and the count
    all-reduced, then the centred sum: two passes, as JAX computes them).
    Parameters use torch's names; ``convert.py`` maps flax's
    scale/bias/mean/var onto them."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, mask, channel_dim=-1):
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        m = mask.unsqueeze(channel_dim)
        if self.training:
            axes = [a for a in range(x.dim()) if a != channel_dim % x.dim()]
            w = m.to(x.dtype)
            sums = global_sum(torch.cat([(x * w).sum(dim=axes), w.sum()[None]]))
            n = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / n
            var = global_sum(((x - mean.view(shape)).square() * w).sum(dim=axes)) / n
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
             * self.weight.view(shape) + self.bias.view(shape))
        return torch.where(m, y, 0.0)


def bn_relu(bn: MaskedBatchNorm, x, site, channel_dim=-1, dtype=torch.float32,
            one_pass=False):
    """Every conv's epilogue: masked batch norm, ReLU, zero off the active
    ``site``s, rounded to ``dtype``, on the pre-activation ``x`` (float32,
    or a dense stage's compute dtype), read as float32. In eval mode on the
    card it is kernel K4 (``ops/bn_relu.bn_relu``: one pass, over ``x`` in
    place where its dtype is ``dtype``; the same bits as the chain below).
    Otherwise ``x`` is dropped after the batch norm: passed as a temporary,
    a dense stage's is freed before the ReLU pass. Training statistics are
    ``MaskedBatchNorm``'s, or with ``one_pass`` (columns, channels last)
    ``MaskedBatchNormFlat``'s (vision3d_tpu/models/sparse_cnn.py:443-453):
    masked mean (count clamped to 1), variance max(E[x^2] - mean^2, 0), both
    also the running update's, then x * g + (bias - mean * g), g = weight /
    sqrt(var + eps); under a process group the two sums and the count are
    global (one all-reduce)."""
    if not bn.training and x.device.type == "cuda":
        return epilogue.bn_relu(x, site, bn.running_mean, bn.running_var, bn.weight,
                                bn.bias, bn.eps, channel_dim, dtype)
    m = site.unsqueeze(channel_dim)
    x = x.float()
    if one_pass and bn.training:
        w = m.to(x.dtype)
        xm = x * w
        c = x.shape[-1]
        axes = tuple(range(x.dim() - 1))
        sums = global_sum(torch.cat([xm.sum(dim=axes), (xm * x).sum(dim=axes),
                                     site.sum().to(x.dtype)[None]]))
        cnt = sums[-1].clamp(min=1.0)
        mean = sums[:c] / cnt
        var = (sums[c:2 * c] / cnt - mean.square()).clamp(min=0.0)
        with torch.no_grad():
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
        g = torch.rsqrt(var + bn.eps) * bn.weight
        y = x * g + (bn.bias - mean * g)
    else:
        y = bn(x, site, channel_dim)
    del x
    return torch.where(m, F.relu(y), 0.0).to(dtype)


class SubMConv(nn.Module):
    """Submanifold conv: output sites == input sites (run by ``<tensor>.subm``)."""

    def __init__(self, cin: int, cout: int, dtype: str = "float32"):
        super().__init__()
        self.kernel = (3, 3, 3)
        self.cdt = _DTYPES[dtype]
        self.weight = nn.Parameter(torch.zeros(27 * cin, cout))
        self.bn = MaskedBatchNorm(cout)


class SparseConvDown(nn.Module):
    """Strided conv: a new, coarser active set (run by ``<tensor>.down``)."""

    def __init__(self, cin, cout, kernel, stride, pad, out_cap, out_col_cap,
                 dtype="float32"):
        super().__init__()
        self.kernel, self.stride, self.pad = kernel, stride, pad
        self.out_cap = out_cap
        self.out_col_cap = out_col_cap  # output columns, column backend
        self.cdt = _DTYPES[dtype]
        kv = kernel[0] * kernel[1] * kernel[2]
        self.weight = nn.Parameter(torch.zeros(kv * cin, cout))
        self.bn = MaskedBatchNorm(cout)

    def out_grid(self, grid):
        return sp.out_grid_shape(grid, self.kernel, self.stride, self.pad)


def to_bev(x) -> torch.Tensor:
    """Collapse z: -> dense BEV (B, H, W, C*D), channels c-major over
    (C, D) as the reference's ``view(N, C*D, H, W)``. The result is an
    NHWC view of an NCHW-contiguous map (``.permute(0, 3, 1, 2)`` is free)."""
    return x.to_bev()


def to_global(st: SparseTensor, cfg: Config, stride: int):
    """Voxel indices -> metric xyz of each voxel's ORIGIN corner (not its
    centre), as the reference and ``vision3d_tpu/models/sparse_cnn.py:666``
    compute it: xyz = flip(zyx) * voxel_size * stride + offset, rounded as
    XLA's CPU code fuses it (one multiply-add: the float64 product of the
    coordinate and the float32 step is exact, so one float64 sum rounded
    to float32 is the fused result). Returns (xyz (B, N, 3), feats, mask),
    xyz zero at padding."""
    vs = torch.tensor(cfg.voxel_size, dtype=torch.float32) * stride
    off = torch.tensor(cfg.grid_bounds[:3], dtype=torch.float32)
    coords = st.coords.flip(-1).double()
    with annotate("sync"):
        vs, off = vs.double().to(coords.device), off.double().to(coords.device)
    xyz = (coords * vs + off).float()
    return torch.where(st.mask[..., None], xyz, 0.0), st.feats, st.mask


class SpMiddleFHD(nn.Module):
    """Reference channel plan: per block 2-3 subm convs then a strided
    conv; 4 -> 16 -> 32 -> 64 -> 64."""

    block_scales = False

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        subm, down = [], []
        cin = cfg.c_in
        for si, (chans, spec) in enumerate(self.block_specs()):
            for ch in chans:
                subm.append(SubMConv(cin, ch, dt))
                cin = ch
            down.append(SparseConvDown(cin, spec["features"], spec["kernel"],
                                       spec["stride"], spec["pad"],
                                       cfg.stage_voxel_capacity(si + 1),
                                       cfg.stage_column_capacity(si + 1), dt))
            cin = spec["features"]
        self.subm = nn.ModuleList(subm)
        self.down = nn.ModuleList(down)

    def block_specs(self):
        """Per block, the submanifold convs' widths and the strided conv's
        geometry; block i's strided conv keeps stage i + 1's capacities."""
        return [
            ([16, 16], dict(features=32, kernel=(3, 3, 3), stride=(2, 2, 2),
                            pad=(1, 1, 1))),
            ([32, 32], dict(features=64, kernel=(3, 3, 3), stride=(2, 2, 2),
                            pad=(1, 1, 1))),
            ([64, 64, 64], dict(features=64, kernel=(3, 3, 3), stride=(2, 2, 2),
                                pad=(0, 1, 1))),
            ([64, 64, 64], dict(features=64, kernel=(3, 1, 1), stride=(2, 1, 1),
                                pad=(0, 0, 0))),
        ]

    def bev_channels(self) -> int:
        """Width of the BEV map ``to_bev`` makes: the last stage's features
        times its z extent."""
        grid = self.cfg.grid_shape_zyx
        for _, spec in self.block_specs():
            grid = sp.out_grid_shape(grid, spec["kernel"], spec["stride"], spec["pad"])
        return self.block_specs()[-1][1]["features"] * grid[0]

    def forward(self, st, need_scales: bool = False):
        """st: a SparseTensor or a ColumnTensor. Returns (bev (B, H, W, C*D),
        diagnostics {name: (B,) int32}): ``stage{1..}_dropped``, the output
        sites each sparse voxel stage's capacity cut; in inference
        ``stage{i}_densify_dropped``, the sites the cutover's column cap cut;
        on columns ``stage{1..}_columns_dropped``, the output columns cut.
        ``need_scales`` (PV-RCNN's set abstraction) adds the SparseTensors at
        strides 1, 2, 4 and 8: the input, then stages 0-2's outputs (with
        ``block_scales`` each block's after its submanifold convs), read as
        voxels as vision3d_tpu/models/sparse_cnn.py:797-806 reads them."""
        cfg, train = self.cfg, self.training
        dense_from = cfg.train_dense_from_stage if train else cfg.dense_from_stage
        diag = {}
        x = st
        scales = [] if self.block_scales else [st]
        subm = iter(self.subm)
        for si, (chans, _) in enumerate(self.block_specs()):
            down = self.down[si]
            if si >= dense_from:
                x = x.densify(cfg, si, train, need_scales, diag)
            plan = x.plan(cfg, si, down, bool(chans), train, diag)
            for _ in chans:
                x = x.subm(next(subm), plan)
            if need_scales and self.block_scales:
                scales.append(x)
            x = x.down(down, plan, diag)
            del plan   # its rulebooks are freed before the next stage's are built
            if need_scales and not self.block_scales:
                scales.append(x)
        if not need_scales:
            return x.to_bev(), diag
        scales = [s.to_voxel_sparse(cfg.stage_voxel_capacity(i))
                  for i, s in enumerate(scales[:4])]
        return x.to_bev(), diag, scales


class SpMiddleFHDLite(SpMiddleFHD):
    """Strided-conv-only variant: no submanifold convs
    (vision3d_tpu/models/sparse_cnn.py:812)."""

    def block_specs(self):
        return [([], down) for _, down in super().block_specs()]


class VoxelBackBone8x(SpMiddleFHD):
    """Voxel R-CNN's 3D backbone (OpenPCDet ``backbones_3d/spconv_backbone.py``
    ``VoxelBackBone8x``, the port's own): two submanifold convs a block,
    16 -> 32 -> 64 -> 64, and a ``conv_out`` of 128 channels, kernel (3, 1, 1)
    and stride (2, 1, 1), so the BEV map is 256 wide. OpenPCDet's
    ``conv_input`` and ``conv1`` are the first block's two submanifold convs;
    its BN eps 1e-3 and momentum 0.01 are the blocks' own. The same plans,
    kernels and representations as ``SpMiddleFHD``. Its scales are
    ``x_conv1``-``x_conv4``: each block's output after its submanifold
    convs."""

    block_scales = True

    def block_specs(self):
        widths = ([16, 16], [32, 32], [64, 64], [64, 64])
        downs = [dict(spec, features=f) for (_, spec), f in
                 zip(super().block_specs(), (32, 64, 64, 128))]
        return list(zip(widths, downs))


CNN_FACTORY = dict(SpMiddleFHD=SpMiddleFHD, SpMiddleFHDLite=SpMiddleFHDLite,
                   VoxelBackBone8x=VoxelBackBone8x)
