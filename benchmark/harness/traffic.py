"""Traffic: the benchmark's one generator, driven by a mix's parameters.

A frozen copy of the port's synthetic KITTI-like clouds
(``vision3d_tpu_torch/synthetic.py``: ground plane, box-like objects and
clutter at radial density, cut to the KITTI grid bounds) and training
boxes, so that a later change to the program cannot change the inputs it
is measured on. ``tests/test_bench_traffic.py`` holds the copy bit-equal to
the original at a seed.

A mix (``traffic/<name>.json``) gives the batch, the points per frame,
the number of distinct batches in the pool the window cycles through
(one client sends them back to back) and, for training, the ground-truth
slots per frame and the share that is valid. ``batch`` is one card's: a
cell on N cards draws global batches of N x ``batch`` frames, and rank r
takes frames ``batch*r`` to ``batch*r + batch - 1`` of each, so the global
traffic does not depend on the number of ranks. The pool's frames are one fixed catalogue of
``pool * batch`` frames, the same for every seed; the seed deals them into
batches in its own order and draws the training boxes, so every seed gives
the window the same work in another order (the active sites, and so the
sparse convs' cost, depend on a frame's content). Every other stream (the
calibration batch, the grid draws) is drawn from the seed. Each stream of
random numbers comes from ``numpy.random.SeedSequence((seed, stream,
index))``, so the same seed gives the same inputs.
"""

import numpy as np

CALIBRATION, POOL, GRID_DRAWS, CHECK, ORDER = 0, 1, 2, 3, 4     # streams of one seed
CATALOGUE = 5                   # the pool's frames, independent of the seed


def rng_for(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((int(seed), stream, index)))


def kitti_like_points(rng, n):
    """About ``n`` points of one KITTI-like frame before the crop to the
    KITTI grid bounds, in random order (x, y, z, intensity) float32."""
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


def clouds(rng, batch, points):
    """(batch, points, 4) float32 frames and (batch,) int32 counts: each
    frame drawn 1.6x oversampled, then cut or padded by resampling to
    exactly ``points``."""
    out = []
    for _ in range(batch):
        p = kitti_like_points(rng, int(points * 1.6))
        if len(p) < points:
            p = np.concatenate([p, p[rng.integers(0, len(p), points - len(p))]])
        out.append(p[:points])
    return np.stack(out), np.full((batch,), points, np.int32)


def train_boxes(rng, batch, max_gt, valid_share, wlh):
    """``max_gt`` boxes a frame (x in [5, 60), y in [-30, 30), z -1, size
    ``wlh``, any yaw), each valid with probability ``valid_share``, class
    0, none ignored."""
    boxes = np.zeros((batch, max_gt, 7), np.float32)
    boxes[..., 0] = rng.uniform(5, 60, (batch, max_gt))
    boxes[..., 1] = rng.uniform(-30, 30, (batch, max_gt))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = wlh
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch, max_gt))
    gt_mask = rng.uniform(size=(batch, max_gt)) < valid_share
    return dict(boxes=boxes, class_idx=np.zeros((batch, max_gt), np.int32),
                gt_mask=gt_mask, box_ignore=np.zeros((batch, max_gt), bool))


def train_batch(rng, batch, points, max_gt, valid_share, wlh):
    """A training batch: the frames of ``clouds``, then ``train_boxes``."""
    pts, num = clouds(rng, batch, points)
    return dict(points=pts, num_points=num, **train_boxes(rng, batch, max_gt, valid_share, wlh))


def catalogue_frame(k: int, points: int) -> np.ndarray:
    """Frame ``k`` of the pool's catalogue: (points, 4) float32."""
    rng = np.random.default_rng(np.random.SeedSequence((CATALOGUE, k)))
    return clouds(rng, 1, points)[0][0]


def make_batch(mix: dict, seed: int, stream: int, index: int, wlh=None,
               rows: slice = slice(None)) -> dict:
    """Batch ``index`` of stream ``stream`` of a mix, as numpy arrays.
    ``rows`` takes a share of its frames (one rank's of a global batch):
    the same frames and boxes as those rows of the whole batch, whatever
    the share."""
    b, p = mix["batch"], mix["points"]
    rng = rng_for(seed, stream, index)
    if stream == POOL:
        order = rng_for(seed, ORDER).permutation(mix["pool"] * b)[index * b:(index + 1) * b][rows]
        pts = np.stack([catalogue_frame(int(k), p) for k in order])
        num = np.full((len(order),), p, np.int32)
    else:
        pts, num = clouds(rng, b, p)
        pts, num = pts[rows], num[rows]
    if mix["mode"] == "train":
        boxes = train_boxes(rng, b, mix["max_gt"], mix["gt_valid_share"],
                            np.asarray(wlh, np.float32))
        return dict(points=pts, num_points=num, **{k: v[rows] for k, v in boxes.items()})
    return dict(points=pts, num_points=num)


def grid_draws(seed: int, index: int, batch: int, proposals: int, gridpoints: int):
    """Grid-point draws for pool batch ``index`` (a two-stage model's RoI
    grid): uniform in [0, 1), (batch, proposals, gridpoints, 3) float32."""
    rng = rng_for(seed, GRID_DRAWS, index)
    return rng.uniform(size=(batch, proposals, gridpoints, 3)).astype(np.float32)
