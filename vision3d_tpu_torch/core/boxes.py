"""Box encode/decode (port of ``vision3d_tpu/core/boxes.py:29-66``) and
the host box geometry (``:69-128``).

VoxelNet-style encoding: xy normalized by the anchor's BEV diagonal, z by
anchor height, wlh as log ratios; encode wraps the yaw residual mod pi,
decode adds the raw residual to the anchor yaw (the reference contract).
encode / decode are shape-polymorphic over leading dims, torch tensors in
and out; the geometry takes and returns numpy arrays.
"""

import math

import numpy as np
import torch


def _anchor_diagonal(a_wlh):
    """BEV diagonal for the x/y slots, height for the z slot."""
    diag = torch.sqrt(a_wlh[..., 0:1] ** 2 + a_wlh[..., 1:2] ** 2)
    return torch.cat([diag, diag, a_wlh[..., 2:3]], dim=-1)


def encode(boxes, anchors):
    """Encode (*, 7) boxes against (*, 7) anchors -> (*, 7) deltas."""
    g_xyz, g_wlh, g_yaw = boxes[..., 0:3], boxes[..., 3:6], boxes[..., 6:7]
    a_xyz, a_wlh, a_yaw = anchors[..., 0:3], anchors[..., 3:6], anchors[..., 6:7]
    a_norm = _anchor_diagonal(a_wlh)
    return torch.cat(
        [
            (g_xyz - a_xyz) / a_norm,
            torch.log(g_wlh / a_wlh),
            torch.remainder(g_yaw - a_yaw, math.pi),
        ],
        dim=-1,
    )


def decode(deltas, anchors, max_wlh_delta=10.0):
    """Decode (*, 7) deltas against (*, 7) anchors -> (*, 7) boxes.

    ``max_wlh_delta`` clamps the log-size residual before exp so an
    untrained delta cannot overflow to inf; None gives the raw reference
    behaviour.
    """
    p_xyz, p_wlh, p_yaw = deltas[..., 0:3], deltas[..., 3:6], deltas[..., 6:7]
    if max_wlh_delta is not None:
        p_wlh = torch.clamp(p_wlh, -max_wlh_delta, max_wlh_delta)
    a_xyz, a_wlh, a_yaw = anchors[..., 0:3], anchors[..., 3:6], anchors[..., 6:7]
    a_norm = _anchor_diagonal(a_wlh)
    return torch.cat(
        [p_xyz * a_norm + a_xyz, torch.exp(p_wlh) * a_wlh, p_yaw + a_yaw],
        dim=-1,
    )


# Host (numpy) box geometry for the data pipeline and the BEV image: a copy
# of ``vision3d_tpu/core/boxes.py:69-128`` at ``xp=numpy``, so augmented
# scenes are bit-equal to the JAX package's.

def box3d_to_bev_corners(boxes):
    """(N, 7) boxes -> (N, 4, 2) BEV corner polygons, counter-clockwise.
    Box layout (x, y, z, w, l, h, yaw): w spans the box's local x-extent
    and l its local y-extent before rotation."""
    xy = boxes[..., 0:2]
    wl = boxes[..., 3:5]
    yaw = boxes[..., 6]
    c, s = np.cos(yaw), np.sin(yaw)
    unit = np.asarray(
        [[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], dtype=boxes.dtype
    )
    corners = wl[..., None, :] * unit  # (N, 4, 2) in box frame
    cx = corners[..., 0] * c[..., None] - corners[..., 1] * s[..., None]
    cy = corners[..., 0] * s[..., None] + corners[..., 1] * c[..., None]
    return np.stack([cx, cy], axis=-1) + xy[..., None, :]


def points_in_convex_polygon(points, polygons, ccw=True):
    """points (N, 2), polygons (M, V, 2) -> mask (N, M): True where point n
    lies strictly inside convex polygon m."""
    rolled = np.roll(polygons, shift=1, axis=1)
    sign = -1.0 if ccw else 1.0
    side = sign * (polygons - rolled)[None]          # (1, M, V, 2)
    v2p = polygons[None] - points[:, None, None]     # (N, M, V, 2)
    cross = side[..., 0] * v2p[..., 1] - side[..., 1] * v2p[..., 0]
    return (cross > 0).all(axis=2)


def points_in_cuboids_mask(points, boxes):
    """points (N, >=3), boxes (M, 7) -> (N, M) bool membership mask: the
    z-slab test and the BEV polygon test."""
    z = points[:, None, 2]
    z_c, h = boxes[:, 2], boxes[:, 5]
    zmask = (z > z_c - h / 2) & (z < z_c + h / 2)
    polygons = box3d_to_bev_corners(boxes)
    return zmask & points_in_convex_polygon(points[:, :2], polygons)


def points_in_cuboids(points, boxes):
    """List of per-box point arrays."""
    mask = points_in_cuboids_mask(points, boxes).T
    return [points[m] for m in mask]


def points_not_in_rectangles(points, boxes):
    """Points outside every box's BEV footprint."""
    polygons = box3d_to_bev_corners(boxes)
    mask = points_in_convex_polygon(points[:, :2], polygons)
    return points[~mask.any(axis=1)]
