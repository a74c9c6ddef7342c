"""Synthetic KITTI-like point clouds and training batches, seeded (the
generators of ``bench.py:20-62`` and ``bench_train.py:62-84``, copied so the
port needs nothing of the JAX repo)."""

import numpy as np


def kitti_like_points(rng, n):
    """Cloud with KITTI-like structure: a ground plane, box-like objects
    and vertical clutter at radial density. Surface-like z matters: the
    sparse-conv active-set dilation, and so every stage's cost, depends on
    it. ``rng`` is a numpy Generator; about ``n`` points before the crop to
    the KITTI grid bounds, in random order."""
    n_ground = int(n * 0.45)
    n_obj = int(n * 0.35)
    n_clut = n - n_ground - n_obj

    def radial(m):
        r = 3.0 + 67.0 * rng.beta(1.2, 2.2, m)
        th = rng.uniform(-0.7, 0.7, m)
        return r * np.cos(th), r * np.sin(th)

    gx, gy = radial(n_ground)
    gz = -1.73 + 0.05 * rng.standard_normal(n_ground) + 0.008 * gx

    n_boxes = 40
    cx, cy = radial(n_boxes)
    cw = rng.uniform(0.5, 2.2, n_boxes)
    cl = rng.uniform(0.5, 4.5, n_boxes)
    ch = rng.uniform(1.0, 2.2, n_boxes)
    bi = rng.integers(0, n_boxes, n_obj)
    u = rng.uniform(-0.5, 0.5, n_obj)
    v = rng.uniform(0, 1, n_obj)
    face = rng.integers(0, 2, n_obj)
    ox = cx[bi] + np.where(face == 0, -0.5 * cl[bi], u * cl[bi])
    oy = cy[bi] + np.where(face == 0, u * cw[bi], -0.5 * cw[bi])
    oz = -1.7 + v * ch[bi]

    tx, ty = radial(n_clut)
    tz = -1.7 + 2.8 * rng.beta(1.1, 2.5, n_clut)

    x = np.concatenate([gx, ox, tx])
    y = np.concatenate([gy, oy, ty])
    z = np.concatenate([gz, oz, tz])
    i = rng.uniform(0, 1, (len(x), 1))
    keep = (x > 0) & (x < 70.4) & (np.abs(y) < 40) & (z > -3) & (z < 1)
    pts = np.concatenate([np.stack([x, y, z], -1), i], -1).astype(np.float32)
    pts = pts[keep]
    return pts[rng.permutation(len(pts))]


def _clouds(rng, batch, points):
    clouds = []
    for _ in range(batch):
        p = kitti_like_points(rng, int(points * 1.6))
        if len(p) < points:
            p = np.concatenate([p, p[rng.integers(0, len(p), points - len(p))]])
        clouds.append(p[:points])
    return np.stack(clouds), np.full((batch,), points, np.int32)


def kitti_like_batch(seed, batch, points):
    """(batch, points, 4) float32 clouds and (batch,) int32 counts, as
    ``bench.py`` builds its batch: 1.6x oversampled, then cut or padded
    by resampling to exactly ``points``."""
    return _clouds(np.random.default_rng(seed), batch, points)


def kitti_like_train_batch(seed, batch, points, max_gt=32, cfg=None):
    """A training batch as ``bench_train.py`` builds it (numpy arrays):
    the clouds of ``kitti_like_batch`` plus ``max_gt`` random ground-truth
    boxes per sample, each valid with probability 0.5 and none ignored.
    Without ``cfg`` every box is a car (class 0, 1.6 x 3.9 x 1.56); with
    it, ``class_idx`` is drawn over the config's classes and a box takes
    its class's anchor size."""
    rng = np.random.default_rng(seed)
    pts, num = _clouds(rng, batch, points)
    boxes = np.zeros((batch, max_gt, 7), np.float32)
    boxes[..., 0] = rng.uniform(5, 60, (batch, max_gt))
    boxes[..., 1] = rng.uniform(-30, 30, (batch, max_gt))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = [1.6, 3.9, 1.56]
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch, max_gt))
    gt_mask = rng.uniform(size=(batch, max_gt)) < 0.5
    class_idx = np.zeros((batch, max_gt), np.int32)
    if cfg is not None:
        class_idx = rng.integers(0, cfg.num_classes, (batch, max_gt)).astype(np.int32)
        wlh = np.asarray([a.wlh for a in cfg.anchors[:cfg.num_classes]], np.float32)
        boxes[..., 3:6] = wlh[class_idx]
    return dict(points=pts, num_points=num, boxes=boxes, class_idx=class_idx,
                gt_mask=gt_mask, box_ignore=np.zeros((batch, max_gt), bool))
