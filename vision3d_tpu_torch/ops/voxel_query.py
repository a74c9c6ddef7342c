"""Voxel query (Voxel R-CNN's ``VoxelQueryAndGrouping``, Deng et al., AAAI
2021): for each grid point, the first ``nsample`` occupied voxels of one
scale, in a fixed scan of the voxels around it, whose centres lie within
``radius``. The port's own: the JAX package has no Voxel R-CNN.

The grid point's voxel is floor((p - lo) / step), step = voxel_size x
stride, per axis, in float32. The scan runs dz, dy, dx each over
[-range, range], z outermost and x innermost, skips cells outside the
scale's grid and empty cells, and takes a voxel whose centre
((coord + 0.5) x step + lo, float32, a multiply then an add) has squared
distance at most r2 from the grid point (dx*dx + dy*dy + dz*dz of the
float32 differences, added left to right, nothing fused; r2 =
float32(radius)^2). The first ``nsample`` taken fill the row in scan
order, later slots repeat the first; a point with none has every slot -1.

On a CPU tensor ``voxel_query`` runs the plain PyTorch version
(``voxel_query_plain``: every window cell of a chunk of grid points at
once, the rank of a hit a cumsum in scan order); on a CUDA tensor the CUDA
kernel ``csrc/voxel_query.cu`` (K2) or raises. Both read one map of the
scale, (B, D, H, W) int32 rows, -1 where no voxel is (``row_map``).
``LAUNCHES["voxel_query"]`` counts kernel launches.
"""

import ctypes

import numpy as np
import torch

from vision3d_tpu_torch import kernels

LAUNCHES = kernels.LAUNCHES
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_VP, _INT, _INT, _INT, _INT, _VP, _INT, _F, _F, _F, _F, _F, _F, _INT, _INT,
             _INT, _F, _INT, _VP, _VP]
# the grid point's voxel is clamped to this many cells outside the grid: a
# window of at most this range reaches no cell from there
_CLAMP = 64


def _r2(radius: float) -> float:
    """radius^2 in float32."""
    return float(np.float32(radius) * np.float32(radius))


def geometry(voxel_size, grid_bounds, stride):
    """(lo (3,), step (3,)) float32 numpy arrays, xyz: the grid's lower
    corner and a voxel's size at ``stride`` (exact: the stride is a power
    of two)."""
    lo = np.asarray(grid_bounds[:3], np.float32)
    step = np.asarray(voxel_size, np.float32) * np.float32(stride)
    return lo, step


def row_map(keys, mask, grid):
    """The scale's voxels as a flat (B * D * H * W + 1,) int32 map: each
    voxel's row (its index in its frame's key-sorted table) at its cell
    (b, z, y, x), -1 at empty cells; the last entry is scratch. ``keys``
    (B, N) column-major (y * W + x) * D + z, ``mask`` (B, N)."""
    d, h, w = grid
    b, n = keys.shape
    cells = d * h * w
    k = torch.where(mask, keys, 0).long()
    raster = (k % d) * (h * w) + k // d + torch.arange(b, device=keys.device)[:, None] * cells
    out = torch.full((b * cells + 1,), -1, dtype=torch.int32, device=keys.device)
    out.scatter_(0, torch.where(mask, raster, b * cells).reshape(-1),
                 torch.arange(n, dtype=torch.int32, device=keys.device).expand(b, n).reshape(-1))
    out[-1] = -1
    return out


def grid_cells(points, lo, step, grid):
    """(B, G, 3) float32 xyz -> (B, G, 3) int64 (x, y, z) voxel of each
    point, floor((p - lo) / step), clamped to ``_CLAMP`` cells outside
    the grid (a NaN to the low side)."""
    lo_t = torch.from_numpy(lo).to(points.device)
    step_t = torch.from_numpy(step).to(points.device)
    f = torch.floor((points - lo_t) / step_t)
    hi = torch.tensor([grid[2], grid[1], grid[0]], dtype=torch.float32,
                      device=points.device) + _CLAMP
    f = torch.where(f >= -_CLAMP, f, -_CLAMP)
    return torch.minimum(f, hi).long()


def window(ranges, device):
    """(T, 3) int64 (dx, dy, dz) offsets of the window in scan order: dz
    outermost, dx innermost. ``ranges`` (x, y, z)."""
    rx, ry, rz = ranges
    dz, dy, dx = torch.meshgrid(torch.arange(-rz, rz + 1), torch.arange(-ry, ry + 1),
                                torch.arange(-rx, rx + 1), indexing="ij")
    return torch.stack([dx, dy, dz], -1).reshape(-1, 3).to(device)


def voxel_query_plain(vmap, grid, points, lo, step, ranges, radius: float, nsample: int,
                      budget: int = 1 << 24):
    """Plain PyTorch version: (B, G, nsample) int32 rows. Chunked over the
    grid points so that the (B, chunk, T) temporaries stay near ``budget``
    elements."""
    d, h, w = grid
    b, g, _ = points.shape
    dev = points.device
    off = window(ranges, dev)
    t = off.shape[0]
    r2 = _r2(radius)
    step_t = torch.from_numpy(step).to(dev)
    lo_t = torch.from_numpy(lo).to(dev)
    dims = torch.tensor([w, h, d], device=dev)
    base = torch.arange(b, device=dev)[:, None, None] * (d * h * w)
    cells = grid_cells(points, lo, step, grid)
    chunk = max(1, min(g, budget // max(1, b * t)))
    out = []
    for c0 in range(0, g, chunk):
        p = points[:, c0:c0 + chunk]
        nb = cells[:, c0:c0 + chunk, None, :] + off                  # (B, C, T, 3) xyz
        inside = ((nb >= 0) & (nb < dims)).all(-1)
        flat = ((nb[..., 2] * h + nb[..., 1]) * w + nb[..., 0]) + base
        row = vmap[torch.where(inside, flat, vmap.numel() - 1)]
        centre = (nb.float() + 0.5) * step_t + lo_t
        diff = centre - p[:, :, None, :]
        dist = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        hit = (row >= 0) & (dist <= r2)
        rank = hit.to(torch.int32).cumsum(dim=2)                    # 1-based
        cnt = rank[..., -1:]
        slot = torch.where(hit & (rank <= nsample), rank - 1, nsample).long()
        idx = torch.full(slot.shape[:2] + (nsample + 1,), -1, dtype=torch.int32, device=dev)
        idx.scatter_(2, slot, row)
        idx = idx[..., :nsample]
        found = torch.arange(nsample, device=dev) < cnt
        out.append(torch.where(found, idx, idx[..., :1]))
    return torch.cat(out, dim=1)


def voxel_query(vmap, grid, points, lo, step, ranges, radius: float, nsample: int,
                budget: int = 1 << 24):
    """vmap: ``row_map`` of the scale (flat int32), grid (D, H, W), points
    (B, G, 3) float32 contiguous, lo / step from ``geometry``, ranges (x,
    y, z) voxels -> (B, G, nsample) int32 rows, -1 for an empty ball.
    ``budget`` is the plain version's (CPU tensors)."""
    if points.device.type == "cpu":
        return voxel_query_plain(vmap, grid, points, lo, step, ranges, radius, nsample, budget)
    if points.device.type != "cuda":
        raise ValueError(f"voxel_query: unsupported device {points.device}")
    d, h, w = grid
    b = points.shape[0]
    if vmap.device != points.device:
        raise ValueError(f"voxel_query: inputs on {vmap.device}, {points.device}")
    if points.dim() != 3 or points.shape[2] != 3 or vmap.dim() != 1 \
            or vmap.numel() != b * d * h * w + 1:
        raise ValueError("voxel_query: need points (B, G, 3) and a row_map of B x D x H x W + 1")
    if points.dtype != torch.float32 or vmap.dtype != torch.int32:
        raise TypeError("voxel_query: points must be float32 and the map int32")
    if not (points.is_contiguous() and vmap.is_contiguous()):
        raise ValueError("voxel_query: points and the map must be contiguous")
    g = points.shape[1]
    if nsample < 1 or b * g >= 2 ** 31 or min(ranges) < 0 or max(ranges) > _CLAMP:
        raise ValueError(f"voxel_query: unsupported sizes B {b}, G {g}, ranges {ranges}, "
                         f"nsample {nsample}")
    idx = torch.empty((b, g, nsample), dtype=torch.int32, device=points.device)
    if b * g == 0:
        return idx
    with torch.cuda.device(points.device):
        kernels.launch(
            "voxel_query", _ARGTYPES, vmap.data_ptr(), b, d, h, w, points.data_ptr(), g,
            *(float(v) for v in lo), *(float(v) for v in step), *(int(r) for r in ranges),
            _r2(radius), nsample, idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return idx
