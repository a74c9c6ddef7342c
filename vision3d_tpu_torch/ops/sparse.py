"""Key-sorted sparse voxel tensors and z-window rulebooks (port of the
subset of ``vision3d_tpu/ops/sparse.py`` that SECOND inference runs).

A sparse tensor is a fixed-capacity, key-sorted structure per sample:
``feats (B, N, C)``, ``keys (B, N)`` int32 column-major linear keys
(``(y*W + x)*D + z``, so one BEV column's voxels are consecutive) with a
sentinel past every real key on padding rows, and ``mask (B, N)``.

What is ported is each function's OUTPUT contract, not its TPU internals:
the JAX plan builds byte-plane record images, column caches and phase
barriers to suit the TPU's gather costs; here the rulebook comes straight
from the sorted keys with ``torch.searchsorted``. Convention for conv
arithmetic (torch/spconv): out[o] receives in[o*stride - pad + d] for
kernel offset d in [0, k).
"""

import numpy as np
import torch


def sentinel_key(grid) -> int:
    d, h, w = grid
    return d * h * w


def coords_to_keys(coords, grid):
    """(..., 3) int ZYX -> (...) column-major linear keys."""
    d, h, w = grid
    return (coords[..., 1] * w + coords[..., 2]) * d + coords[..., 0]


def keys_to_coords(keys, grid):
    d, h, w = grid
    return torch.stack([keys % d, keys // (w * d), (keys // d) % w], dim=-1)


def make_sorted(feats, coords, mask, grid):
    """Batched (B, N, ...) voxelizer output -> key-sorted (feats, keys, mask).
    The sort is stable, as ``jnp.argsort`` is."""
    keys = torch.where(mask, coords_to_keys(coords, grid).to(torch.int32),
                       sentinel_key(grid))
    keys, order = torch.sort(keys, dim=1, stable=True)
    feats = torch.gather(feats, 1, order[..., None].expand(feats.shape))
    return feats, keys, torch.gather(mask, 1, order)


def out_grid_shape(in_grid, kernel, stride, pad):
    """Static output spatial dims: (D + 2p - k)//s + 1 per axis."""
    return tuple(
        (in_grid[i] + 2 * pad[i] - kernel[i]) // stride[i] + 1 for i in range(3)
    )


def downsample_active_set(keys, mask, in_grid, kernel, stride, pad, out_cap):
    """Active output key set of a strided sparse conv, batched.

    An output site is active if any active input lies in its window (the
    spconv rule). Candidates are enumerated exactly (ceil(k/s) offsets per
    dim), sorted, uniqued and compacted to ``out_cap`` in ascending key
    order, so truncation drops the largest keys deterministically.

    Returns (out_keys (B, out_cap) int32 sentinel-padded, out_mask,
    n_dropped (B,) int32: true active sites beyond the cap).
    """
    b, n = keys.shape
    og = out_grid_shape(in_grid, kernel, stride, pad)
    s_out = sentinel_key(og)
    dev = keys.device
    coords = keys_to_coords(torch.where(mask, keys, 0), in_grid)  # (B, N, 3)

    cnt = [-(-k_ // s_) for k_, s_ in zip(kernel, stride)]
    joffs = np.stack(np.meshgrid(*[np.arange(c_) for c_ in cnt], indexing="ij"),
                     -1).reshape(-1, 3)
    stride_t = torch.tensor(stride, dtype=torch.int32, device=dev)
    pad_t = torch.tensor(pad, dtype=torch.int32, device=dev)
    kern_t = torch.tensor(kernel, dtype=torch.int32, device=dev)
    og_t = torch.tensor(og, dtype=torch.int32, device=dev)

    cp = (coords + pad_t)[:, None]                         # (B, 1, N, 3)
    d0 = cp % stride_t
    dd = d0 + torch.tensor(joffs, dtype=torch.int32, device=dev)[:, None] * stride_t
    o = torch.div(cp - dd, stride_t, rounding_mode="floor")  # (B, J, N, 3)
    ok = ((dd < kern_t).all(-1) & (o >= 0).all(-1) & (o < og_t).all(-1)
          & mask[:, None, :])
    okey = (o[..., 1] * og[2] + o[..., 2]) * og[0] + o[..., 0]
    okey = torch.where(ok, okey, s_out).reshape(b, -1)

    skey = torch.sort(okey, dim=1).values
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first &= skey < s_out
    rank = first.to(torch.int64).cumsum(dim=1) - 1
    keep = first & (rank < out_cap)
    out_keys = torch.full((b, out_cap + 1), s_out, dtype=torch.int32, device=dev)
    out_keys.scatter_(1, torch.where(keep, rank, out_cap), skey)
    out_keys = out_keys[:, :out_cap].contiguous()
    n_dropped = (first.sum(dim=1) - out_cap).clamp(min=0).to(torch.int32)
    return out_keys, out_keys < s_out, n_dropped


def zwin_rulebook(keys, mask, grid, out_keys, out_mask, out_grid, kernel,
                  stride=(1, 1, 1), pad=(0, 0, 0)):
    """Z-window rulebook: per (output site, BEV offset), the START row of
    the neighbor column's kz-window and a kz-bit presence pattern.

    Contract of ``csr_zwin_rulebook`` (vision3d_tpu/ops/sparse.py:1246):
    keys are column-major sorted, so a column's voxels with z in
    [z0, z0+kz) are consecutive rows from ``start = colstart +
    (active voxels of the column below max(z0, 0))``, which is exactly
    ``searchsorted(keys, cell*D + max(z0, 0))``. Bit dz of ``pattern`` is
    set iff z0+dz is active in that column. Misses (out-of-grid neighbor,
    empty window, padded site) get start = N and pattern 0.

    Returns (start (B, M*K2) int32, pattern (B, M*K2) int32), site-major.
    """
    b, n = keys.shape
    m = out_keys.shape[1]
    d, h, w = grid
    kz, ky, kx = kernel
    k2 = ky * kx
    assert kz <= 3, kz
    od, oh, ow = out_grid
    dev = keys.device
    ok = torch.where(out_mask, out_keys, 0)
    oz = ok % od
    oy = ok // (ow * od)
    ox = (ok // od) % ow

    offs = torch.tensor(
        np.stack(np.meshgrid(np.arange(ky), np.arange(kx), indexing="ij"), -1)
        .reshape(-1, 2), dtype=torch.int32, device=dev)
    ny = oy[..., None] * stride[1] - pad[1] + offs[:, 0]     # (B, M, K2)
    nx = ox[..., None] * stride[2] - pad[2] + offs[:, 1]
    okbev = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w) & out_mask[..., None]
    base = torch.where(okbev, ny * w + nx, 0) * d             # column key base
    z0 = (oz * stride[0] - pad[0])[..., None].expand(b, m, k2)

    start = torch.searchsorted(keys, (base + z0.clamp(min=0)).reshape(b, -1)
                               .contiguous()).reshape(b, m, k2)
    pattern = torch.zeros_like(start)
    for j in range(kz):
        row = start + j
        kj = torch.gather(keys, 1, row.clamp(max=n - 1).reshape(b, -1))
        rel = kj.reshape(b, m, k2) - base                     # z of candidate j
        dz = rel - z0
        hit = (row < n) & (rel >= 0) & (rel < d) & (dz >= 0) & (dz < kz)
        pattern |= torch.where(hit, torch.ones_like(dz) << dz.clamp(0, kz - 1), 0)
    pattern = torch.where(okbev, pattern, 0)
    start = torch.where(pattern > 0, start, n)
    return (start.reshape(b, -1).to(torch.int32),
            pattern.reshape(b, -1).to(torch.int32))


def plan_stage_batched(keys, mask, grid, down_kernel, down_stride, down_pad,
                       out_cap, subm_kernel=None):
    """Per-stage plan: the down conv's active output set plus the z-window
    rulebooks of the stage's submanifold convs and of its down conv.

    Returns (rb_subm or None, rb_down, out_keys, out_mask, n_dropped), each
    rulebook a (start, pattern) pair; n_dropped (B,) counts active output
    sites the capacity truncated. Output contract of
    ``plan_stage_batched`` (vision3d_tpu/ops/sparse.py:1460) where its
    column caches drop nothing (the JAX plan switches to full-tap rulebooks
    for D > 48; this one stays z-window for any D).
    """
    out_grid = out_grid_shape(grid, down_kernel, down_stride, down_pad)
    out_keys, out_mask, n_dropped = downsample_active_set(
        keys, mask, grid, down_kernel, down_stride, down_pad, out_cap)
    rbs = None
    if subm_kernel is not None:
        pad_s = tuple(s // 2 for s in subm_kernel)
        rbs = zwin_rulebook(keys, mask, grid, keys, mask, grid, subm_kernel,
                            (1, 1, 1), pad_s)
    rbd = zwin_rulebook(keys, mask, grid, out_keys, out_mask, out_grid,
                        down_kernel, down_stride, down_pad)
    return rbs, rbd, out_keys, out_mask, n_dropped


def zwin_taps(start, pattern, n, kz=3):
    """Per (site, BEV offset, dz): the input row of tap dz, or -1.

    Candidate j of a window is the j-th active voxel at z >= z0, so tap dz
    reads row ``start + popcount(pattern bits below dz)`` when bit dz is
    set; rows >= n read as zero (the JAX wrapper's padded zero rows).
    Returns (B, Q, kz) int64.
    """
    rows = []
    for dz in range(kz):
        below = pattern & ((1 << dz) - 1)
        j = sum((below >> i) & 1 for i in range(dz)) if dz else 0
        r = start.to(torch.int64) + j
        on = ((pattern >> dz) & 1).bool() & (r < n)
        rows.append(torch.where(on, r, -1))
    return torch.stack(rows, dim=-1)


def conv_zwin_apply(feats, start, pattern, weight, kernel,
                    compute_dtype=torch.float32):
    """Plain PyTorch z-window conv: the CUDA kernel's reference.

    feats (B, N, C); (start, pattern) from ``zwin_rulebook``; weight the
    shared (K*Cin, Cout) layout, K = (dz*ky+dy)*kx + dx. Returns
    (B, M, Cout) float32. Inputs are rounded to ``compute_dtype`` and the
    products summed in float32 (the JAX code's
    ``preferred_element_type=f32``).
    """
    b, n, c = feats.shape
    kz, ky, kx = kernel
    k2 = ky * kx
    m = start.shape[1] // k2
    cout = weight.shape[1]
    rows = zwin_taps(start, pattern, n, kz)                   # (B, M*K2, kz)
    fz = torch.cat([feats.to(compute_dtype).float(),
                    feats.new_zeros((b, 1, c), dtype=torch.float32)], dim=1)
    idx = torch.where(rows >= 0, rows, n).reshape(b, -1)
    g = torch.gather(fz, 1, idx[..., None].expand(b, idx.shape[1], c))
    # (B, M, K2, kz, C) -> tap order (dz, j2) of the shared weight layout
    g = g.reshape(b, m, k2, kz, c).transpose(2, 3).reshape(b * m, kz * k2 * c)
    w = weight.to(compute_dtype).float()
    return (g @ w).reshape(b, m, cout)
