"""Column-sparse tensors: sparse in BEV, dense in z (port of the batched
route of ``vision3d_tpu/ops/column_sparse.py``).

Every active BEV column is stored densely in z as one flat row:

    col_feats (B, Ncol, D*C)   zmask (B, Ncol, D)   col_keys (B, Ncol)

with ``col_keys`` the sorted BEV keys ``y*W + x`` (sentinel ``H*W`` on
padding slots) and ``col_mask = col_keys < H*W``. A 3x3x3 sparse conv is
then a gather of the 9 BEV-neighbour columns followed by a z-window
product per output z; the rulebook is per column, not per voxel. The
semantics are spconv's: submanifold convs are masked to the input's
active sites, strided convs activate any site with an active input in its
receptive field. Weights keep the shared ``(K*Cin, Cout)`` layout,
K = (dz*ky + dy)*kx + dx.

What is ported is each function's output contract. The JAX code keeps
rows flat and expands masks by matmuls to dodge the TPU's lane padding;
here a ``(B, N, D, C)`` view is free, and rulebooks come from
``torch.searchsorted`` on the sorted column keys.

``column_conv_dz`` is the plain version of the ``column_conv`` CUDA
kernel (``ops/column_conv.py``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.training.profiler import annotate


def bev_offsets(ky, kx):
    """Static (K2, 2) BEV offsets, (dy, dx) row-major."""
    return np.stack(np.meshgrid(np.arange(ky), np.arange(kx), indexing="ij"),
                    -1).reshape(-1, 2)


def columns_from_voxels_batched(feats, coords, mask, grid, ncol_cap):
    """Batched voxelizer output -> flat column tensor.

    feats (B, N, C), coords (B, N, 3) ZYX, mask (B, N) -> (col_feats
    (B, ncol_cap, D*C), zmask (B, ncol_cap, D), col_keys (B, ncol_cap)
    int32 ascending, col_mask, n_dropped (B,) int32).

    A column's slot is its rank among the active cells of a dense BEV
    occupancy grid, so columns are in ascending key order and the lowest
    keys are kept when ``ncol_cap`` binds (``n_dropped`` counts the rest),
    as ``columns_from_voxels_batched`` (vision3d_tpu/ops/column_sparse.py:215).
    """
    d, h, w = grid
    b, n, c = feats.shape
    hw = h * w
    dev = feats.device
    bev = torch.where(mask, coords[..., 1] * w + coords[..., 2], hw).long()
    occ = torch.zeros((b, hw + 1), dtype=torch.bool, device=dev)
    occ.scatter_(1, bev, True)
    occ = occ[:, :hw]
    rank = occ.to(torch.int32).cumsum(dim=1) - 1
    vcol = torch.gather(rank, 1, bev.clamp(max=hw - 1))
    vcol = torch.where(mask & (vcol < ncol_cap), vcol, ncol_cap)   # cap: trash slot

    col_keys = torch.full((b, ncol_cap + 1), hw, dtype=torch.int32, device=dev)
    col_keys.scatter_(1, vcol, torch.where(mask, bev, hw).to(torch.int32))
    col_keys = col_keys[:, :ncol_cap].contiguous()

    z = torch.where(mask, coords[..., 0], 0).long()
    site = vcol * d + z                                            # (B, N)
    zmask = torch.zeros((b, (ncol_cap + 1) * d), dtype=torch.bool, device=dev)
    zmask.scatter_(1, site, mask)
    col_feats = feats.new_zeros((b, (ncol_cap + 1) * d, c))
    col_feats.scatter_(1, site[..., None].expand(b, n, c),
                       torch.where(mask[..., None], feats, 0.0))
    n_dropped = (occ.sum(dim=1) - ncol_cap).clamp(min=0).to(torch.int32)
    return (col_feats[:, :ncol_cap * d].reshape(b, ncol_cap, d * c).contiguous(),
            zmask[:, :ncol_cap * d].reshape(b, ncol_cap, d).contiguous(),
            col_keys, col_keys < hw, n_dropped)


def build_bev_rulebook_batched(col_keys, col_mask, hw, kernel_yx,
                               stride_yx=(1, 1), pad_yx=(0, 0),
                               out_keys=None, out_mask=None, out_hw=None):
    """BEV neighbour-column rulebook (B, M*K2) int32 in [0, N]: the input
    column's slot, or N for a miss (out of the grid, inactive, padded
    output). K2 = ky*kx is minor, (dy, dx) row-major. Without ``out_*``
    the outputs are the inputs (submanifold). Contract of
    ``build_bev_rulebook_batched`` (vision3d_tpu/ops/column_sparse.py:60)."""
    if out_keys is None:
        out_keys, out_mask, out_hw = col_keys, col_mask, hw
    b, n = col_keys.shape
    h, w = hw
    ow = out_hw[1]
    oy = torch.where(out_mask, out_keys // ow, 0)
    ox = torch.where(out_mask, out_keys % ow, 0)
    with annotate("sync"):
        offs = torch.tensor(bev_offsets(*kernel_yx), dtype=torch.int32,
                            device=col_keys.device)
    ny = oy[..., None] * stride_yx[0] - pad_yx[0] + offs[:, 0]
    nx = ox[..., None] * stride_yx[1] - pad_yx[1] + offs[:, 1]
    ok = ((ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
          & out_mask[..., None]).reshape(b, -1)
    nkey = torch.where(ok, (ny * w + nx).reshape(b, -1), h * w)
    return torch.where(ok, sp.lookup_rows(col_keys, nkey, n), n).to(torch.int32)


def transpose_bev_rulebook_batched(col_keys, col_mask, hw, kernel_yx,
                                   stride_yx, pad_yx, out_keys, out_mask, out_hw):
    """Transpose of ``build_bev_rulebook_batched``'s rulebook, the K2 BEV
    taps in REVERSED order: entry (i, K2-1-k2) is the output column (its
    slot in ``out_keys``) that reads input column i at BEV offset k2,
    o = (i + pad - offset)/stride, or M where the stride does not divide,
    o is out of the grid or o is inactive. Returns (B, N*K2) int32 in
    [0, M]. The dX of a column conv is a column conv over this rulebook
    (``ops/column_conv.py``); for a submanifold conv (stride 1, a
    symmetric window) it equals the forward rulebook."""
    b, n = col_keys.shape
    m = out_keys.shape[1]
    w = hw[1]
    oh, ow = out_hw
    dev = col_keys.device
    y = torch.where(col_mask, col_keys // w, 0)[..., None]
    x = torch.where(col_mask, col_keys % w, 0)[..., None]
    with annotate("sync"):
        offs = torch.tensor(bev_offsets(*kernel_yx), dtype=torch.int32, device=dev)
    ty = y + pad_yx[0] - offs[:, 0]                                # (B, N, K2)
    tx = x + pad_yx[1] - offs[:, 1]
    oy = torch.div(ty, stride_yx[0], rounding_mode="floor")
    ox = torch.div(tx, stride_yx[1], rounding_mode="floor")
    ok = ((ty % stride_yx[0] == 0) & (tx % stride_yx[1] == 0) & (oy >= 0)
          & (oy < oh) & (ox >= 0) & (ox < ow) & col_mask[..., None]).reshape(b, -1)
    okey = torch.where(ok, (oy * ow + ox).reshape(b, -1), oh * ow)
    rows = torch.where(ok, sp.lookup_rows(out_keys, okey, m), m)
    return rows.reshape(b, n, -1).flip(-1).reshape(b, -1).to(torch.int32).contiguous()


def downsample_bev_columns(col_keys, col_mask, hw, kernel_yx, stride_yx,
                           pad_yx, out_cap, out_hw):
    """Active output column set of a BEV-strided conv, batched: candidates
    sorted, uniqued and compacted to ``out_cap`` in ascending key order
    (``downsample_bev_columns``, vision3d_tpu/ops/column_sparse.py:430).
    Returns (out_keys (B, out_cap) int32 sentinel-padded, out_mask,
    n_dropped (B,) int32: active output columns beyond the cap)."""
    b, n = col_keys.shape
    w = hw[1]
    oh, ow = out_hw
    sent = oh * ow
    dev = col_keys.device
    y = torch.where(col_mask, col_keys // w, 0)[:, None]
    x = torch.where(col_mask, col_keys % w, 0)[:, None]
    with annotate("sync"):
        offs = torch.tensor(bev_offsets(*kernel_yx), dtype=torch.int32, device=dev)
    ty = y + pad_yx[0] - offs[:, 0, None]                          # (B, K2, N)
    tx = x + pad_yx[1] - offs[:, 1, None]
    oy = torch.div(ty, stride_yx[0], rounding_mode="floor")
    ox = torch.div(tx, stride_yx[1], rounding_mode="floor")
    ok = ((ty % stride_yx[0] == 0) & (tx % stride_yx[1] == 0)
          & (oy >= 0) & (oy < oh) & (ox >= 0) & (ox < ow) & col_mask[:, None])
    okey = torch.where(ok, oy * ow + ox, sent).reshape(b, -1)
    skey = torch.sort(okey, dim=1).values
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first &= skey < sent
    rank = first.to(torch.int64).cumsum(dim=1) - 1
    keep = first & (rank < out_cap)
    out_keys = torch.full((b, out_cap + 1), sent, dtype=torch.int32, device=dev)
    out_keys.scatter_(1, torch.where(keep, rank, out_cap), skey.to(torch.int32))
    out_keys = out_keys[:, :out_cap].contiguous()
    n_dropped = (first.sum(dim=1) - out_cap).clamp(min=0).to(torch.int32)
    return out_keys, out_keys < sent, n_dropped


def conv_out_depth(d, kz, stride_z, pad_z):
    return (d + 2 * pad_z - kz) // stride_z + 1


def column_conv_dz(col_feats, rb_idx, weight, kernel, d, c, stride_z=1,
                   pad_z=0, compute_dtype=torch.float32):
    """Plain PyTorch column conv, the ``column_conv`` kernel's reference
    (``column_conv_dz``, vision3d_tpu/ops/column_sparse.py:105): gather the
    K2 neighbour rows (a miss reads a zero row), pad z, and per output z
    one product of the (K2*kz*C) window against the (k2, dz, c)-major
    weight.

    col_feats (B, N, D*C); rb_idx (B, M*K2) int32 with misses = N; weight
    (kz*K2*C, Cout). Returns (B, M, D_out*Cout) float32. Inputs are
    rounded to ``compute_dtype`` and the products summed in float32."""
    b, n, _ = col_feats.shape
    kz, ky, kx = kernel
    k2 = ky * kx
    m = rb_idx.shape[1] // k2
    cout = weight.shape[1]
    d_out = conv_out_depth(d, kz, stride_z, pad_z)
    dp = d + 2 * pad_z
    table = F.pad(col_feats.to(compute_dtype).reshape(b, n, d, c),
                  (0, 0, pad_z, pad_z, 0, 1))                      # (B, N+1, dp, C)
    base = torch.arange(b, device=col_feats.device)[:, None] * (n + 1)
    g = table.reshape(b * (n + 1), dp, c)[(rb_idx.long() + base).reshape(-1)]
    g = g.reshape(b * m, k2, dp, c)
    wperm = weight.to(compute_dtype).float().reshape(kz, k2, c, cout)
    wperm = wperm.transpose(0, 1).reshape(k2 * kz * c, cout)
    outs = [g[:, :, zo * stride_z: zo * stride_z + kz].float()
            .reshape(b * m, k2 * kz * c) @ wperm for zo in range(d_out)]
    return torch.stack(outs, dim=1).reshape(b, m, d_out * cout)


def column_occupancy_batched(zmask, rb_idx, kernel, stride_z=1, pad_z=0):
    """Output-site activity of a strided conv: any active input voxel in
    the receptive field (``column_occupancy_batched``,
    vision3d_tpu/ops/column_sparse.py:200). zmask (B, N, D) bool ->
    (B, M, D_out) bool."""
    b, n, d = zmask.shape
    kz, ky, kx = kernel
    k2 = ky * kx
    m = rb_idx.shape[1] // k2
    zt = F.pad(zmask, (pad_z, pad_z, 0, 1))                        # (B, N+1, dp)
    idx = rb_idx.long()[..., None].expand(b, m * k2, zt.shape[-1])
    col = torch.gather(zt, 1, idx).reshape(b, m, k2, -1).any(dim=2)
    return col.unfold(-1, kz, stride_z).any(dim=-1)


def expand_site_mask(zmask, c, dtype=torch.float32):
    """(B, N, D) bool site mask -> (B, N, D*C) flat multiplier."""
    b, n, d = zmask.shape
    return zmask[..., None].expand(b, n, d, c).reshape(b, n, d * c).to(dtype)


def columns_to_bev_batched(col_feats, zmask, col_keys, col_mask, grid, c):
    """Scatter flat columns into dense (B, H, W, C*D) BEV maps, (C, D)
    c-major as the reference's ``view(N, C*D, H, W)``
    (``columns_to_bev_batched``, vision3d_tpu/ops/column_sparse.py:278)."""
    d, h, w = grid
    b, n, _ = col_feats.shape
    feats = torch.where(zmask[..., None], col_feats.reshape(b, n, d, c), 0.0)
    flat = feats.transpose(2, 3).reshape(b, n, c * d)
    idx = torch.where(col_mask, col_keys, h * w).long()
    dense = col_feats.new_zeros((b, h * w + 1, c * d))
    dense.scatter_(1, idx[..., None].expand(b, n, c * d),
                   torch.where(col_mask[..., None], flat, 0.0))
    return dense[:, :h * w].reshape(b, h, w, c * d)


def columns_to_voxels(col_feats, zmask, col_keys, col_mask, grid, cap):
    """Column tensor -> voxel-sparse (feats (B, cap, C), keys, mask) with
    the active sites compacted in (column, z) order, which is the
    column-major key order ``(y*W + x)*D + z`` of ``ops/sparse.py``
    (``columns_to_voxels``, vision3d_tpu/ops/column_sparse.py:474, batched).
    col_feats (B, Ncol, D, C)."""
    d, h, w = grid
    b, ncol = col_keys.shape
    c = col_feats.shape[-1]
    site_mask = (zmask & col_mask[..., None]).reshape(b, -1)
    order = torch.sort((~site_mask).to(torch.int8), dim=1, stable=True).indices
    sel = order[:, :cap]
    valid = torch.gather(site_mask, 1, sel)
    feats = torch.gather(col_feats.reshape(b, ncol * d, c), 1,
                         sel[..., None].expand(b, sel.shape[1], c))
    ck = torch.gather(col_keys, 1, sel // d)
    keys = torch.where(valid, ck * d + (sel % d).to(torch.int32), d * h * w)
    return (torch.where(valid[..., None], feats, 0.0), keys.to(torch.int32),
            valid)
