"""Hard voxelization with fixed capacity and first-come truncation
(port of ``vision3d_tpu/core/voxelize.py:44-154, :190``).

spconv's VoxelGenerator semantics, as the reference uses them: points are
scanned in order; each new occupied voxel gets the next id until
``max_voxels`` (later new voxels are dropped); each voxel keeps its first
``max_occupancy`` points; coords are ZYX; out-of-range points are dropped.

The whole batch goes through ONE stable sort: each point's key is its
voxel's column-major linear key plus a per-sample offset, so samples never
mix and, within a voxel, the sort keeps scan order. The first sorted row of
a segment then carries both the segment's start and its first point's scan
index; a voxel's id is the rank of that first point among the sample's
voxels. The JAX code's ``.at[].set(mode="drop")`` scatters become writes
into one extra drop row that is sliced off afterwards.
"""

import numpy as np
import torch

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.training.profiler import annotate


def grid_dims_xyz(cfg: Config) -> tuple:
    """Point-validity grid extents (nx, ny, nz), spconv rounding."""
    vs = np.asarray(cfg.voxel_size)
    lo = np.asarray(cfg.grid_bounds[:3])
    hi = np.asarray(cfg.grid_bounds[3:])
    return tuple(int(x) for x in np.round((hi - lo) / vs))


def voxelize_batch(points, num_points, cfg: Config) -> dict:
    """Voxelize a batch of point clouds.

    Args:
      points: (B, P, C) float32; the first 3 columns are xyz. Rows past
        ``num_points[b]`` are padding.
      num_points: (B,) int count of real points per sample.

    Returns a dict of (B, ...) tensors on the points' device
    (N = cfg.max_voxels, K = cfg.max_occupancy): ``features`` (B, N, K, C),
    ``coords`` (B, N, 3) int32 ZYX, ``occupancy`` (B, N) int32,
    ``num_voxels`` (B,), ``num_voxels_total`` (B,) distinct in-range voxels
    before the cap, ``voxel_mask`` (B, N) bool.
    """
    b, p, c = points.shape
    n, k = cfg.max_voxels, cfg.max_occupancy
    nx, ny, nz = grid_dims_xyz(cfg)
    dev = points.device
    with annotate("sync"):
        lo = torch.tensor(cfg.grid_bounds[:3], dtype=points.dtype, device=dev)
        vs = torch.tensor(cfg.voxel_size, dtype=points.dtype, device=dev)
        dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)

    cxyz = torch.floor((points[..., :3] - lo) / vs).to(torch.int32)
    pos = torch.arange(p, device=dev)
    in_range = ((cxyz >= 0) & (cxyz < dims)).all(-1)
    in_range &= pos[None, :] < num_points.to(dev)[:, None]
    sentinel = nz * ny * nx
    key = (cxyz[..., 1] * nx + cxyz[..., 0]) * nz + cxyz[..., 2]
    key = torch.where(in_range, key, sentinel).to(torch.int64)

    bidx = torch.arange(b, device=dev)[:, None]
    gkey = (key + bidx * (sentinel + 1)).reshape(-1)
    skey_g, order = torch.sort(gkey, stable=True)
    skey = skey_g.reshape(b, p) - bidx * (sentinel + 1)
    order = order.reshape(b, p) - bidx * p               # within-sample index
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    is_vox = skey < sentinel

    # segment start (sorted position) for every row: running max of the
    # first-row positions
    seg_start = torch.where(first, pos[None, :], 0).cummax(dim=1).values
    slot = pos[None, :] - seg_start
    # voxel id = rank of the segment's first point (scan index) among the
    # sample's voxels: a presence row over scan indices + exclusive cumsum
    present = torch.zeros((b, p + 1), dtype=torch.int32, device=dev)
    present.scatter_(1, torch.where(first & is_vox, order, p),
                     torch.ones_like(order, dtype=torch.int32))
    present[:, p] = 0
    crank = present.cumsum(dim=1) - present
    first_pt = torch.gather(order, 1, seg_start)          # (B, P)
    vox = torch.gather(crank, 1, first_pt)

    valid = is_vox & (vox < n) & (slot < k)
    flat = torch.where(valid, (bidx * (n + 1) + vox) * (k + 1) + slot,
                       b * (n + 1) * (k + 1))
    pts_sorted = torch.gather(points, 1, order[..., None].expand(b, p, c))
    features = torch.zeros((b * (n + 1) * (k + 1) + 1, c), dtype=points.dtype,
                           device=dev)
    features[flat.reshape(-1)] = pts_sorted.reshape(-1, c)
    features = features[:-1].reshape(b, n + 1, k + 1, c)[:, :n, :k]

    # occupancy: segment size (next segment start - own start), capped
    seg_id = first.to(torch.int64).cumsum(dim=1) - 1
    seg_first_pos = torch.full((b, p + 1), p, dtype=torch.int64, device=dev)
    seg_first_pos.scatter_(1, torch.where(first, seg_id, p), pos.expand(b, p))
    seg_first_pos[:, p] = p
    seg_size = torch.gather(seg_first_pos, 1, seg_id + 1) - seg_start
    occ_row = first & is_vox & (vox < n)
    occupancy = torch.zeros((b * (n + 1) + 1,), dtype=torch.int32, device=dev)
    occupancy[torch.where(occ_row, bidx * (n + 1) + vox,
                          b * (n + 1)).reshape(-1)] = (
        seg_size.clamp(max=k).to(torch.int32).reshape(-1))
    occupancy = occupancy[:-1].reshape(b, n + 1)[:, :n]

    skey_c = torch.where(is_vox, skey, 0)
    coords_sorted = torch.stack(
        [skey_c % nz, skey_c // (nx * nz), (skey_c // nz) % nx], dim=-1
    ).to(torch.int32)
    coords = torch.zeros((b * (n + 1) + 1, 3), dtype=torch.int32, device=dev)
    coords[torch.where(valid, bidx * (n + 1) + vox,
                       b * (n + 1)).reshape(-1)] = coords_sorted.reshape(-1, 3)
    coords = coords[:-1].reshape(b, n + 1, 3)[:, :n]

    total = (first & is_vox).sum(dim=1).to(torch.int32)
    num_voxels = total.clamp(max=n)
    voxel_mask = torch.arange(n, device=dev)[None, :] < num_voxels[:, None]
    return dict(features=features, coords=coords, occupancy=occupancy,
                num_voxels=num_voxels, num_voxels_total=total,
                voxel_mask=voxel_mask)


def mean_vfe(features, occupancy):
    """Mean of the stored points per voxel; empty voxels give zeros."""
    denom = occupancy.clamp(min=1).to(features.dtype)[..., None]
    return features.sum(dim=-2) / denom


def voxelize_np(points: np.ndarray, cfg: Config):
    """Host voxelizer with the same first-come semantics, one cloud at a
    time (``vision3d_tpu/core/voxelize.py:157``): (features (Nv, K, C),
    coords (Nv, 3) ZYX int32, occupancy (Nv,) int32) of the real voxels
    only."""
    nx, ny, nz = grid_dims_xyz(cfg)
    lo = np.asarray(cfg.grid_bounds[:3], dtype=points.dtype)
    vs = np.asarray(cfg.voxel_size, dtype=points.dtype)
    c = np.floor((points[:, :3] - lo) / vs).astype(np.int64)
    ok = ((c >= 0) & (c < np.array([nx, ny, nz]))).all(axis=1)

    N, K, C = cfg.max_voxels, cfg.max_occupancy, points.shape[1]
    features = np.zeros((N, K, C), points.dtype)
    coords = np.zeros((N, 3), np.int32)
    occupancy = np.zeros((N,), np.int32)
    table = {}
    for i in np.flatnonzero(ok):
        zyx = (int(c[i, 2]), int(c[i, 1]), int(c[i, 0]))
        v = table.get(zyx)
        if v is None:
            if len(table) >= N:
                continue
            v = len(table)
            table[zyx] = v
            coords[v] = zyx
        if occupancy[v] < K:
            features[v, occupancy[v]] = points[i]
            occupancy[v] += 1
    n = len(table)
    return features[:n], coords[:n], occupancy[:n]
