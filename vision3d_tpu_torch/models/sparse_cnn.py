"""SpMiddleFHD sparse middle extractors (port of
``vision3d_tpu/models/sparse_cnn.py``): the voxel, column and dense
representations, for inference and for training.

Four blocks of submanifold + strided convs take voxel features at grid
(41, 1600, 1408) ZYX down to (2, 200, 176), then collapse z into a
(ny, nx, C*D) BEV map; channels 4 -> 16 -> 32 -> 64 -> 64, BN eps 1e-3.
Stages before ``cfg.dense_from_stage`` run sparse (key-sorted tensors,
z-window rulebooks, the ``zwin_conv`` CUDA kernel); later stages run as
dense masked volumes with cuDNN conv3d, exact spconv semantics recovered
by masking to the active set. In training mode (``module.training``) the
stages before ``cfg.train_dense_from_stage`` (default 4: all of them) run
sparse on full-tap rulebooks: every conv is the ``gather_gemm`` CUDA
kernel, forward and dX, and dW regathers its columns with the
``gather_rows`` kernel; the cutover to the dense stages is one all-cells
row gather whose backward is one gather (``dense_from_sparse``), and the
dense convs train by autograd through cuDNN.

With ``cfg.sparse_backend = "column"`` the input is a ``ColumnTensor``
(sparse in BEV, dense in z, ``ops/column_sparse.py``): the sparse stages
run BEV-column rulebooks and the ``column_conv`` CUDA kernel, and the
cutover to the dense stages is one row gather (``dense_from_columns``).
The column convs are ``ops.column_conv.ColumnConvFn``, whose backward
runs dX on the ``column_conv`` kernel over the transposed BEV rulebook
and dW by a ``gather_rows`` regather and one GEMM. The parameters are the same
whatever the representation, so one state dict serves both backends.

Layouts: a ``SparseTensor`` is (B, N, C); a ``ColumnTensor`` holds flat
z-major (B, Ncol, D*C) rows; a ``DenseTensor`` holds feats
as (B, C, D, H, W) in channels-last-3d memory (cuDNN's preferred layout;
the JAX package's hwdc/z-major choice was a TPU tactic) and occupancy as
(B, D, H, W). Weights keep the JAX layout (K*Cin, Cout),
K = (dz*ky + dy)*kx + dx.
"""

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch import nn

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.ops import column_sparse as csp
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops.column_conv import ColumnConvFn
from vision3d_tpu_torch.ops.zwin_conv import zwin_conv
from vision3d_tpu_torch.parallel.mesh import global_sum
from vision3d_tpu_torch.training.profiler import annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


@dataclass
class DenseTensor:
    """``keys`` / ``mask`` (the compact key set, as a SparseTensor's) ride
    along only when a consumer needs the sparse form (PV-RCNN's scales)."""
    feats: torch.Tensor  # (B, C, D, H, W), channels-last-3d memory
    occ: torch.Tensor    # (B, D, H, W) bool: the exact spconv active set
    grid: tuple
    keys: torch.Tensor = None   # (B, N) int32
    mask: torch.Tensor = None   # (B, N) bool

    def to_voxel_sparse(self) -> SparseTensor:
        """The features at the kept key set, float32, zero at padding. The
        volume is z-major, so column-major key (y*W + x)*D + z reads raster
        row z*H*W + y*W + x (``DenseTensor.to_voxel_sparse``,
        vision3d_tpu/models/sparse_cnn.py:107, its non-hwdc branch)."""
        d, h, w = self.grid
        b, c = self.feats.shape[:2]
        flat = self.feats.permute(0, 2, 3, 4, 1).reshape(b, d * h * w, c)
        k = torch.where(self.mask, self.keys, 0).long()
        raster = (k % d) * (h * w) + k // d
        bidx = torch.arange(b, device=k.device)[:, None]
        f = torch.where(self.mask[..., None], flat[bidx, raster].float(), 0.0)
        return SparseTensor(feats=f, keys=self.keys, mask=self.mask, grid=self.grid)


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


def _conv3d_weight(weight, kernel):
    """(K*Cin, Cout) -> (Cout, Cin, kz, ky, kx)."""
    kz, ky, kx = kernel
    cin = weight.shape[0] // (kz * ky * kx)
    return weight.reshape(kz, ky, kx, cin, weight.shape[1]).permute(4, 3, 0, 1, 2)


def _dense_conv(x, weight, kernel, stride, pad, cdt):
    """conv3d (cross-correlation, as JAX's conv_general_dilated) in the
    compute dtype; the result is returned as float32."""
    wk = _conv3d_weight(weight, kernel).to(cdt).contiguous(
        memory_format=torch.channels_last_3d)
    return F.conv3d(x.to(cdt), wk, stride=stride, padding=pad).float()


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


def _column_bn_relu(bn, out, site, cdt):
    """Masked BN + ReLU on the flat (B, N, D*C) f32 rows of a column conv,
    zeroed off the active sites (B, N, D) and rounded to the compute dtype
    (``MaskedBatchNormFlat`` with the parameters of ``MaskedBatchNorm``,
    vision3d_tpu/models/sparse_cnn.py:421, :506-510). In training mode the
    statistics are ``MaskedBatchNormFlat``'s (:443-453): the masked mean
    over the sites of (B, N, D) (count clamped to 1) and the one-pass
    variance max(E[x^2] - mean^2, 0), which also feed the running update
    at momentum 0.01; then x * g + (bias - mean * g), g = weight /
    sqrt(var + eps). Under a process group the two sums and the count are
    the global batch's (one all-reduce)."""
    b, n, d = site.shape
    x = out.reshape(b, n, d, -1)
    if bn.training:
        w = site[..., None].to(x.dtype)
        xm = x * w
        c = x.shape[-1]
        sums = global_sum(torch.cat([xm.sum(dim=(0, 1, 2)), (xm * x).sum(dim=(0, 1, 2)),
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
        y = bn(x, site)
    y = torch.where(site[..., None], F.relu(y), 0.0).to(cdt)
    return y.reshape(b, n, -1)


class SubMConv(nn.Module):
    """Submanifold conv: output sites == input sites."""

    def __init__(self, cin: int, cout: int, dtype: str = "float32"):
        super().__init__()
        self.kernel = (3, 3, 3)
        self.cdt = _DTYPES[dtype]
        self.weight = nn.Parameter(torch.zeros(27 * cin, cout))
        self.bn = MaskedBatchNorm(cout)

    def forward(self, x, rb=None):
        if isinstance(x, DenseTensor):
            out = _dense_conv(x.feats, self.weight, self.kernel, (1, 1, 1),
                              (1, 1, 1), self.cdt)
            out = self.bn(out, x.occ, channel_dim=1)
            out = torch.where(x.occ[:, None], F.relu(out), 0.0).to(self.cdt)
            return replace(x, feats=out)
        if isinstance(x, ColumnTensor):
            # a subm conv's rulebook is its own transpose: dX runs over it
            out = ColumnConvFn.apply(x.feats, rb, rb, self.weight, self.kernel,
                                     x.grid[0], x.c, 1, self.kernel[0] // 2, self.cdt)
            site = x.zmask & x.mask[..., None]
            return replace(x, feats=_column_bn_relu(self.bn, out, site, self.cdt),
                           c=self.weight.shape[1])
        if isinstance(rb, tuple):
            out = zwin_conv(x.feats, rb[0], rb[1], self.weight, self.kernel,
                            self.cdt)
        else:   # full-tap rulebook: conv-as-backward autograd function
            out = sp.SubmConvFn.apply(x.feats, rb, self.weight, self.cdt)
        out = self.bn(out, x.mask)
        return replace(x, feats=torch.where(x.mask[..., None], F.relu(out), 0.0))


class SparseConvDown(nn.Module):
    """Strided conv: a new, coarser active set."""

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

    def forward(self, x, plan=None):
        """x: a DenseTensor, or a SparseTensor with its stage plan (a
        ColumnTensor goes through ``forward_columns``)."""
        out_grid = sp.out_grid_shape(x.grid, self.kernel, self.stride, self.pad)
        if isinstance(x, DenseTensor):
            of = _dense_conv(x.feats, self.weight, self.kernel, self.stride,
                             self.pad, self.cdt)
            oz = dense_dilate_occ(x.occ, self.kernel, self.stride, self.pad)
            of = self.bn(of, oz, channel_dim=1)
            of = torch.where(oz[:, None], F.relu(of), 0.0).to(self.cdt)
            okeys = omask = None
            if x.keys is not None:
                with annotate("plan"):
                    okeys, omask, _ = sp.downsample_active_set(
                        x.keys, x.mask, x.grid, self.kernel, self.stride, self.pad,
                        self.out_cap)
            return DenseTensor(feats=of, occ=oz, grid=out_grid, keys=okeys,
                               mask=omask)
        if len(plan) == 4:   # training plan with the transpose rulebook
            rb, rbt, ok, om = plan
            of = sp.DownConvFn.apply(x.feats, rb, rbt, self.weight, self.cdt)
        else:
            rb, ok, om = plan
            of = zwin_conv(x.feats, rb[0], rb[1], self.weight, self.kernel,
                           self.cdt)
        of = self.bn(of, om)
        of = torch.where(om[..., None], F.relu(of), 0.0)
        return SparseTensor(feats=of, keys=ok, mask=om, grid=out_grid)

    def forward_columns(self, x: ColumnTensor):
        """The strided conv on a ColumnTensor: returns (ColumnTensor,
        columns_dropped (B,) int32: active output columns the column
        capacity truncated)."""
        out_grid = sp.out_grid_shape(x.grid, self.kernel, self.stride, self.pad)
        kyx, syx, pyx = self.kernel[1:], self.stride[1:], self.pad[1:]
        in_hw, out_hw = x.grid[1:], out_grid[1:]
        with annotate("plan"):
            if kyx == (1, 1) and syx == (1, 1):
                # BEV-identity down conv (the (3, 1, 1) stage): same column set
                ok, om = x.keys, x.mask
                ndrop = torch.zeros((x.keys.shape[0],), dtype=torch.int32,
                                    device=x.keys.device)
            else:
                ok, om, ndrop = csp.downsample_bev_columns(
                    x.keys, x.mask, in_hw, kyx, syx, pyx, self.out_col_cap, out_hw)
            rb = csp.build_bev_rulebook_batched(x.keys, x.mask, in_hw, kyx, syx, pyx,
                                                out_keys=ok, out_mask=om, out_hw=out_hw)
            # the transposed rulebook only serves the backward's dX
            rbt = (csp.transpose_bev_rulebook_batched(x.keys, x.mask, in_hw, kyx, syx,
                                                      pyx, ok, om, out_hw)
                   if torch.is_grad_enabled() and x.feats.requires_grad else None)
        of = ColumnConvFn.apply(x.feats, rb, rbt, self.weight, self.kernel, x.grid[0],
                                x.c, self.stride[0], self.pad[0], self.cdt)
        oz = csp.column_occupancy_batched(x.zmask, rb, self.kernel, self.stride[0],
                                          self.pad[0])
        site = oz & om[..., None]
        return ColumnTensor(feats=_column_bn_relu(self.bn, of, site, self.cdt),
                            zmask=oz, keys=ok, mask=om, grid=out_grid,
                            c=self.weight.shape[1]), ndrop


def to_bev(x) -> torch.Tensor:
    """Collapse z: -> dense BEV (B, H, W, C*D), channels c-major over
    (C, D) as the reference's ``view(N, C*D, H, W)``. The result is an
    NHWC view of an NCHW-contiguous map (``.permute(0, 3, 1, 2)`` is free)."""
    if isinstance(x, SparseTensor):
        dense = sp.to_dense(x.feats, x.keys, x.mask, x.grid)  # (B, D, H, W, C)
        b, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)
    if isinstance(x, ColumnTensor):
        return csp.columns_to_bev_batched(x.feats, x.zmask, x.keys, x.mask,
                                          x.grid, x.c)
    b, c, d, h, w = x.feats.shape
    f = torch.where(x.occ[:, None], x.feats, 0.0)
    return f.reshape(b, c * d, h, w).permute(0, 2, 3, 1)


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
    conv; 4 -> 16 -> 32 -> 64 -> 64. ``block_scales``: the scales
    ``need_scales`` returns are each block's submanifold output, not the
    input and the strided convs' outputs."""

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
                                       spec["out_cap"], spec["out_col_cap"], dt))
            cin = spec["features"]
        self.subm = nn.ModuleList(subm)
        self.down = nn.ModuleList(down)

    def block_specs(self):
        c = self.cfg
        return [
            ([16, 16], dict(features=32, kernel=(3, 3, 3), stride=(2, 2, 2),
                            pad=(1, 1, 1), out_cap=c.stage_voxel_capacity(1),
                            out_col_cap=c.stage_column_capacity(1))),
            ([32, 32], dict(features=64, kernel=(3, 3, 3), stride=(2, 2, 2),
                            pad=(1, 1, 1), out_cap=c.stage_voxel_capacity(2),
                            out_col_cap=c.stage_column_capacity(2))),
            ([64, 64, 64], dict(features=64, kernel=(3, 3, 3), stride=(2, 2, 2),
                                pad=(0, 1, 1), out_cap=c.stage_voxel_capacity(3),
                                out_col_cap=c.stage_column_capacity(3))),
            ([64, 64, 64], dict(features=64, kernel=(3, 1, 1), stride=(2, 1, 1),
                                pad=(0, 0, 0), out_cap=c.stage_voxel_capacity(4),
                                out_col_cap=c.stage_column_capacity(4))),
        ]

    def bev_channels(self) -> int:
        """Width of the BEV map ``to_bev`` makes: the last stage's features
        times its z extent."""
        grid = self.cfg.grid_shape_zyx
        for _, spec in self.block_specs():
            grid = sp.out_grid_shape(grid, spec["kernel"], spec["stride"], spec["pad"])
        return self.block_specs()[-1][1]["features"] * grid[0]

    def forward(self, st, need_scales: bool = False):
        """st: a SparseTensor or a ColumnTensor. Returns (bev (B, H, W,
        C*D), diagnostics {name: (B,) int32}). The stages from
        ``cfg.dense_from_stage`` on (in training mode
        ``cfg.train_dense_from_stage``) run dense. In training mode the
        sparse voxel stages are planned with ``sp.plan_stage_train_batched``
        and the cutover is ``dense_from_sparse`` (no column cap);
        ``stage{1..}_dropped`` count the active output sites each sparse
        stage's capacity truncated, and in inference
        ``stage{i}_densify_dropped`` the sites the cutover's column cap
        dropped. On a ColumnTensor ``stage{1..}_columns_dropped`` count
        the active output columns each sparse stage's column capacity
        truncated.

        ``need_scales`` (PV-RCNN's set abstraction) returns (bev,
        diagnostics, scales) with the four SparseTensors at strides 1, 2, 4
        and 8: the input, then the outputs of stages 0-2; with
        ``block_scales``, each block's output after its submanifold convs,
        on the same sites. A ColumnTensor
        scale i is read as voxels at ``cfg.stage_voxel_capacity(i)``, a
        dense stage's output at its compact key set (on the column backend
        the cutover's columns at that capacity, then each strided conv's
        active set), as vision3d_tpu/models/sparse_cnn.py:797-806."""
        cfg = self.cfg
        dense_from = (cfg.train_dense_from_stage if self.training
                      else cfg.dense_from_stage)
        diag = {}
        x = st
        scales = [] if self.block_scales else [st]
        li = 0
        for si, (chans, spec) in enumerate(self.block_specs()):
            if si >= dense_from and isinstance(x, SparseTensor) and self.training:
                x = dense_from_sparse(x, keep_keys=need_scales)
            elif si >= dense_from and isinstance(x, SparseTensor):
                x, cdrop = dense_from_sparse_cols(
                    x, cfg.stage_column_capacity(si), keep_keys=need_scales)
                diag[f"stage{si}_densify_dropped"] = cdrop
            elif si >= dense_from and isinstance(x, ColumnTensor):
                x = dense_from_columns(x, keep_keys=need_scales,
                                       voxel_cap=cfg.stage_voxel_capacity(si))
            rb = plan = None
            if isinstance(x, SparseTensor):
                args = (x.keys, x.mask, x.grid, spec["kernel"], spec["stride"],
                        spec["pad"], spec["out_cap"])
                subm = (3, 3, 3) if chans else None
                with annotate("plan"):
                    if self.training:
                        rb, rbd, rbt, ok, om, ndrop = sp.plan_stage_train_batched(
                            *args, subm_kernel=subm)
                        plan = (rbd, rbt, ok, om)
                    else:
                        rb, rbd, ok, om, ndrop = sp.plan_stage_batched(
                            *args, subm_kernel=subm,
                            subm_col_cap=cfg.stage_column_capacity(si),
                            down_col_cap=cfg.stage_column_capacity(si + 1))
                        plan = (rbd, ok, om)
                diag[f"stage{si + 1}_dropped"] = ndrop
            elif chans and isinstance(x, ColumnTensor):
                with annotate("plan"):
                    rb = csp.build_bev_rulebook_batched(x.keys, x.mask, x.grid[1:],
                                                        (3, 3), (1, 1), (1, 1))
            for _ in chans:
                x = self.subm[li](x, rb)
                li += 1
            if need_scales and self.block_scales:
                scales.append(x)
            if isinstance(x, ColumnTensor):
                x, diag[f"stage{si + 1}_columns_dropped"] = \
                    self.down[si].forward_columns(x)
            else:
                x = self.down[si](x, plan)
            if need_scales and not self.block_scales:
                scales.append(x)
        if not need_scales:
            return to_bev(x), diag
        scales = [s.to_voxel_sparse(cfg.stage_voxel_capacity(i))
                  if isinstance(s, ColumnTensor)
                  else s.to_voxel_sparse() if isinstance(s, DenseTensor) else s
                  for i, s in enumerate(scales[:4])]
        return to_bev(x), diag, scales


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
