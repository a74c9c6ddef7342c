"""Exact rotated-box IoU in numpy, for host callers: the collision filter
of the paste augmentation (``data/augment.py``) and the evaluator's 3D IoU
(``eval/kitti_eval.py``). A copy of ``vision3d_tpu/core/iou.py:30-160`` at
``xp=numpy`` (the device version is ``core/iou.py``): the same numpy
operations in the same order give the JAX package's keep sets, IoU
matrices and AP tables bit for bit. ``core/iou.py`` on CPU tensors matches
in float64, but not in the evaluator's float32, where it is off by one
unit in the last place in some entries
(``tools/compare_torch_host_iou.py``).

Boxes are (x_ctr, y_ctr, w, h, angle); ``angle_mode="degrees"`` reads
radians as degrees (the reference kernel's quirk, ``PARITY.md``),
``"radians"`` is the corrected mode.
"""

import math

import numpy as np

_DEG2RAD = math.pi / 180.0
_EPS = 1e-14


def _corners(boxes, angle_mode):
    """(..., 5) -> (..., 4, 2) ccw corners."""
    theta = boxes[..., 4]
    if angle_mode == "degrees":
        theta = theta * _DEG2RAD
    c, s = np.cos(theta), np.sin(theta)
    w2 = boxes[..., 2] * 0.5
    h2 = boxes[..., 3] * 0.5
    lx = np.stack([-w2, w2, w2, -w2], axis=-1)
    ly = np.stack([-h2, -h2, h2, h2], axis=-1)
    gx = lx * c[..., None] - ly * s[..., None] + boxes[..., 0:1]
    gy = lx * s[..., None] + ly * c[..., None] + boxes[..., 1:2]
    return np.stack([gx, gy], axis=-1)


def _segment_intersections(p1, p2):
    """All 16 intersections of quad p1's edges with quad p2's edges.
    p1, p2 (..., 4, 2) -> points (..., 16, 2), valid (..., 16)."""
    a_ = p1[..., :, None, :]
    b_ = np.roll(p1, -1, axis=-2)[..., :, None, :]
    c_ = p2[..., None, :, :]
    d_ = np.roll(p2, -1, axis=-2)[..., None, :, :]
    r = b_ - a_
    s = d_ - c_
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = c_ - a_
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    safe = np.where(np.abs(denom) > _EPS, denom, np.ones_like(denom))
    t = t_num / safe
    u = u_num / safe
    valid = (
        (np.abs(denom) > _EPS) & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    )
    pts = a_ + t[..., None] * r
    shape = valid.shape[:-2] + (16,)
    return pts.reshape(shape + (2,)), valid.reshape(shape)


def _points_in_quad(pts, quad):
    """pts (..., K, 2) inside convex ccw quad (..., 4, 2) -> (..., K)."""
    a = quad[..., None, :, :]
    b = np.roll(quad, -1, axis=-2)[..., None, :, :]
    p = pts[..., :, None, :]
    cross = (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (p[..., 0] - a[..., 0])
    return (cross >= -1e-12).all(axis=-1)


def _masked_convex_area(pts, valid):
    """Area of the convex polygon of the valid subset of pts (..., K, 2):
    sort by angle about the valid mean, route invalid slots onto the first
    vertex (zero-area edges), shoelace."""
    vf = valid.astype(pts.dtype)
    n = vf.sum(axis=-1, keepdims=True)
    center = (pts * vf[..., None]).sum(axis=-2, keepdims=True) / np.maximum(n[..., None], 1.0)
    rel = pts - center
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    big = np.asarray(1e9, dtype=pts.dtype)
    key = np.where(valid, ang, big)
    order = np.argsort(key, axis=-1)
    pts_s = np.take_along_axis(pts, order[..., None], axis=-2)
    val_b = np.take_along_axis(valid, order, axis=-1)
    first = pts_s[..., 0:1, :]
    pts_s = np.where(val_b[..., None], pts_s, first)
    nxt = np.roll(pts_s, -1, axis=-2)
    cross = pts_s[..., 0] * nxt[..., 1] - pts_s[..., 1] * nxt[..., 0]
    area = 0.5 * np.abs(cross.sum(axis=-1))
    return np.where(n[..., 0] >= 3, area, np.zeros_like(area))


def rotated_box_intersection(boxes1, boxes2, angle_mode="degrees"):
    """Intersection area of broadcast-compatible (..., 5) rotated boxes."""
    shape = np.broadcast_shapes(boxes1.shape, boxes2.shape)
    boxes1 = np.broadcast_to(boxes1, shape)
    boxes2 = np.broadcast_to(boxes2, shape)
    # pair-local frame for precision (the reference shifts by box1's center)
    shift = boxes1[..., 0:2]
    b1 = np.concatenate([boxes1[..., 0:2] - shift, boxes1[..., 2:5]], axis=-1)
    b2 = np.concatenate([boxes2[..., 0:2] - shift, boxes2[..., 2:5]], axis=-1)
    q1 = _corners(b1, angle_mode)
    q2 = _corners(b2, angle_mode)
    ipts, ivalid = _segment_intersections(q1, q2)
    in12 = _points_in_quad(q1, q2)
    in21 = _points_in_quad(q2, q1)
    pts = np.concatenate([ipts, q1, q2], axis=-2)        # (..., 24, 2)
    valid = np.concatenate([ivalid, in12, in21], axis=-1)
    return _masked_convex_area(pts, valid)


def rotated_iou(boxes1, boxes2, angle_mode="degrees"):
    """Elementwise IoU of broadcast-compatible (..., 5) rotated boxes."""
    inter = rotated_box_intersection(boxes1, boxes2, angle_mode)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    union = a1 + a2 - inter
    return np.where(union > 0, inter / np.maximum(union, _EPS), np.zeros_like(inter))


def np_pairwise_rotated_iou(boxes1, boxes2, angle_mode="degrees"):
    """(M, 5) x (N, 5) -> (M, N) float32 IoU, computed in float64."""
    b1 = np.asarray(boxes1, dtype=np.float64)[:, None, :]
    b2 = np.asarray(boxes2, dtype=np.float64)[None, :, :]
    return rotated_iou(b1, b2, angle_mode).astype(np.float32)
