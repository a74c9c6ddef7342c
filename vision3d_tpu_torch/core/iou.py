"""Exact rotated-box IoU, fully vectorized (port of
``vision3d_tpu/core/iou.py:30-160``).

Boxes are (x_ctr, y_ctr, w, h, angle). ``angle_mode="degrees"`` keeps the
reference kernel's quirk of reading radians as degrees (``PARITY.md``);
``"radians"`` is the corrected mode. The intersection of two convex quads
is convex with at most 8 vertices drawn from 24 candidates: 16 edge-pair
intersections plus each quad's vertices inside the other. All 24 are built
in parallel with a validity mask, ordered by angle about their mean, and
summed with a masked shoelace formula: no data-dependent loop.
"""

import math

import torch

_DEG2RAD = math.pi / 180.0
_EPS = 1e-14


def _corners(boxes, angle_mode):
    """(..., 5) -> (..., 4, 2) ccw corners."""
    theta = boxes[..., 4]
    if angle_mode == "degrees":
        theta = theta * _DEG2RAD
    c, s = torch.cos(theta), torch.sin(theta)
    w2 = boxes[..., 2] * 0.5
    h2 = boxes[..., 3] * 0.5
    lx = torch.stack([-w2, w2, w2, -w2], dim=-1)
    ly = torch.stack([-h2, -h2, h2, h2], dim=-1)
    gx = lx * c[..., None] - ly * s[..., None] + boxes[..., 0:1]
    gy = lx * s[..., None] + ly * c[..., None] + boxes[..., 1:2]
    return torch.stack([gx, gy], dim=-1)


def _segment_intersections(p1, p2):
    """All 16 intersections of quad p1's edges with quad p2's edges.
    p1, p2 (..., 4, 2) -> points (..., 16, 2), valid (..., 16)."""
    a = p1[..., :, None, :]
    b = torch.roll(p1, -1, dims=-2)[..., :, None, :]
    c = p2[..., None, :, :]
    d = torch.roll(p2, -1, dims=-2)[..., None, :, :]
    r = b - a
    s = d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = c - a
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    nonpar = denom.abs() > _EPS
    safe = torch.where(nonpar, denom, torch.ones_like(denom))
    t = t_num / safe
    u = u_num / safe
    valid = nonpar & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    pts = a + t[..., None] * r
    shape = valid.shape[:-2] + (16,)
    return pts.reshape(shape + (2,)), valid.reshape(shape)


def _points_in_quad(pts, quad):
    """pts (..., K, 2) inside convex ccw quad (..., 4, 2) -> (..., K)."""
    a = quad[..., None, :, :]
    b = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    p = pts[..., :, None, :]
    cross = (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (p[..., 0] - a[..., 0])
    return (cross >= -1e-12).all(dim=-1)


def _masked_convex_area(pts, valid):
    """Area of the convex polygon of the valid subset of pts (..., K, 2):
    sort by angle about the valid mean, route invalid slots onto the first
    vertex (zero-area edges), shoelace."""
    vf = valid.to(pts.dtype)
    n = vf.sum(dim=-1, keepdim=True)
    center = (pts * vf[..., None]).sum(dim=-2, keepdim=True) / n[..., None].clamp(min=1.0)
    rel = pts - center
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    key = torch.where(valid, ang, torch.full_like(ang, 1e9))
    order = torch.sort(key, dim=-1, stable=True).indices
    pts_s = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    val_s = torch.gather(valid, -1, order)
    first = pts_s[..., 0:1, :]
    pts_s = torch.where(val_s[..., None], pts_s, first)
    nxt = torch.roll(pts_s, -1, dims=-2)
    cross = pts_s[..., 0] * nxt[..., 1] - pts_s[..., 1] * nxt[..., 0]
    area = 0.5 * cross.sum(dim=-1).abs()
    return torch.where(n[..., 0] >= 3, area, torch.zeros_like(area))


def rotated_box_intersection(boxes1, boxes2, angle_mode="degrees"):
    """Intersection area of broadcast-compatible (..., 5) rotated boxes."""
    boxes1, boxes2 = torch.broadcast_tensors(boxes1, boxes2)
    # pair-local frame for precision (the reference shifts by box1's center)
    shift = boxes1[..., 0:2]
    b1 = torch.cat([boxes1[..., 0:2] - shift, boxes1[..., 2:5]], dim=-1)
    b2 = torch.cat([boxes2[..., 0:2] - shift, boxes2[..., 2:5]], dim=-1)
    q1 = _corners(b1, angle_mode)
    q2 = _corners(b2, angle_mode)
    ipts, ivalid = _segment_intersections(q1, q2)
    in12 = _points_in_quad(q1, q2)
    in21 = _points_in_quad(q2, q1)
    pts = torch.cat([ipts, q1, q2], dim=-2)          # (..., 24, 2)
    valid = torch.cat([ivalid, in12, in21], dim=-1)
    return _masked_convex_area(pts, valid)


def rotated_iou(boxes1, boxes2, angle_mode="degrees"):
    """Elementwise IoU of broadcast-compatible (..., 5) rotated boxes."""
    inter = rotated_box_intersection(boxes1, boxes2, angle_mode)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union.clamp(min=_EPS),
                       torch.zeros_like(inter))


def pairwise_rotated_iou(boxes1, boxes2, angle_mode="degrees"):
    """(..., M, 5) x (..., N, 5) -> (..., M, N) IoU matrix; the leading
    dims broadcast."""
    return rotated_iou(boxes1[..., :, None, :], boxes2[..., None, :, :],
                       angle_mode)


def pairwise_rotated_iou_chunked(boxes1, boxes2, angle_mode="degrees",
                                 chunk=4096):
    """(..., M, N) IoU computed in N-chunks to bound peak memory: the 24
    candidate points per pair would make an unchunked gt-vs-anchor matrix
    (N ~ 70k per class) gigabytes wide."""
    return torch.cat([pairwise_rotated_iou(boxes1, blk, angle_mode)
                      for blk in boxes2.split(chunk, dim=-2)], dim=-1)
