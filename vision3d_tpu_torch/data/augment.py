"""Point-cloud augmentation chain and ground-truth sample database (a
numpy copy of ``vision3d_tpu/data/augment.py``).

The chain is [gt-database paste, y-flip p=0.5, global scale U(0.95,1.05),
global rotation U(-pi/4, pi/4)], parameters from the config. The paste
draws NUM_SAMPLE_OBJECTS[c] samples per class from the database (boxes
de-meaned to the box's BEV frame with their cropped points), moves each to
a random xy position in bounds, rejects samples whose pasted box has BEV
IoU > 1e-2 with any other box, removes the scene points inside the kept
boxes' BEV footprints and concatenates. The database is built once by
cropping the points inside every train gt box and keeping boxes with more
than MIN_NUM_SAMPLE_PTS points.

Host numpy throughout (the collision filter is the float64 numpy rotated
IoU in the config's angle mode); all randomness flows through an explicit
``np.random.Generator``, so one seed gives the JAX package's scene.
"""

import os.path as osp
import pickle
from collections import defaultdict

import numpy as np

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.boxes import points_in_cuboids, points_not_in_rectangles
from vision3d_tpu_torch.core.iou_host import np_pairwise_rotated_iou


def _rotate_xy(theta, xy):
    c, s = np.cos(theta), np.sin(theta)
    return xy @ np.array([[c, s], [-s, c]], dtype=xy.dtype)


class FlipAugmentation:
    """y-mirror with p=0.5."""

    def __init__(self, cfg: Config):
        self.enabled = cfg.aug.flip_horizontal

    def __call__(self, points, boxes, rng):
        if not self.enabled or rng.random() < 0.5:
            return points, boxes
        points = points.copy()
        boxes = boxes.copy()
        points[:, 1] = -points[:, 1]
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        return points, boxes


class ScaleAugmentation:
    """Global metric scale."""

    def __init__(self, cfg: Config):
        self.lo, self.hi = cfg.aug.global_scale

    def __call__(self, points, boxes, rng):
        f = np.float32(rng.uniform(self.lo, self.hi))
        points = points.copy()
        boxes = boxes.copy()
        points[:, :3] *= f
        boxes[:, :6] *= f
        return points, boxes


class RotateAugmentation:
    """Global z-rotation."""

    def __init__(self, cfg: Config):
        self.lo, self.hi = cfg.aug.global_rotation

    def __call__(self, points, boxes, rng):
        th = np.float32(rng.uniform(self.lo, self.hi))
        points = points.copy()
        boxes = boxes.copy()
        points[:, :2] = _rotate_xy(th, points[:, :2])
        boxes[:, :2] = _rotate_xy(th, boxes[:, :2])
        boxes[:, 6] += th
        return points, boxes


class SampleAugmentation:
    """Ground-truth paste from the cached database."""

    def __init__(self, cfg: Config, database=None):
        self.cfg = cfg
        if database is None:
            with open(osp.join(cfg.data.cachedir, "database.pkl"), "rb") as f:
                database = pickle.load(f)
        self.database = database

    def draw_samples(self, rng):
        boxes, points, class_idx = [], [], []
        for c in range(self.cfg.num_classes):
            pool = self.database.get(c, [])
            n = self.cfg.aug.num_sample_objects[c]
            if not pool or n == 0:
                continue
            for i in rng.integers(0, len(pool), n):
                s = pool[i]
                boxes.append(s["box"])
                points.append(s["points"])
                class_idx.append(c)
        if not boxes:
            return None
        return dict(
            boxes=np.stack(boxes).astype(np.float32),
            points=[p.astype(np.float32) for p in points],
            class_idx=np.asarray(class_idx, np.int64),
        )

    def random_translate(self, samples, rng):
        lo = np.asarray(self.cfg.grid_bounds[:2])
        hi = np.asarray(self.cfg.grid_bounds[3:5])
        n = len(samples["boxes"])
        pos = rng.random((n, 2)) * (hi - lo) + lo
        samples["boxes"][:, :2] += pos
        samples["points"] = [
            np.concatenate([p[:, :2] + q, p[:, 2:]], axis=1)
            for p, q in zip(samples["points"], pos)
        ]

    def filter_collisions(self, scene_boxes, sample_boxes):
        """Keep the samples that overlap nothing: BEV IoU <= 1e-2 with
        every other box."""
        n = len(scene_boxes)
        allb = np.concatenate([scene_boxes, sample_boxes])[:, [0, 1, 3, 4, 6]]
        iou = np_pairwise_rotated_iou(allb, allb, angle_mode=self.cfg.iou_angle_mode)
        return (iou > 1e-2).sum(axis=1)[n:] == 1  # only self-overlap

    def __call__(self, points, boxes, class_idx, rng):
        samples = self.draw_samples(rng)
        if samples is None:
            return points, boxes, class_idx
        self.random_translate(samples, rng)
        keep = self.filter_collisions(boxes, samples["boxes"])
        sboxes = samples["boxes"][keep]
        spoints = [p for p, k in zip(samples["points"], keep) if k]
        scls = samples["class_idx"][keep]
        if len(sboxes):
            points = points_not_in_rectangles(points, sboxes)
        points = np.concatenate([points] + spoints) if spoints else points
        boxes = np.concatenate([boxes, sboxes])
        class_idx = np.concatenate([class_idx, scls])
        return points, boxes, class_idx


class ChainedAugmentation:
    """paste -> flip -> scale -> rotate."""

    def __init__(self, cfg: Config, database=None):
        self.cfg = cfg
        self.sample = SampleAugmentation(cfg, database) if cfg.aug.database_sample else None
        self.geo = [FlipAugmentation(cfg), ScaleAugmentation(cfg), RotateAugmentation(cfg)]

    def __call__(self, points, boxes, class_idx, rng=None):
        rng = rng or np.random.default_rng()
        if self.sample is not None:
            points, boxes, class_idx = self.sample(points, boxes, class_idx, rng)
        for aug in self.geo:
            points, boxes = aug(points, boxes, rng)
        return points, boxes, class_idx


class DatabaseBuilder:
    """One-time gt-sample database build into ``{cachedir}/database.pkl``."""

    def __init__(self, cfg: Config, annotations, verbose=True):
        self.cfg = cfg
        self.fpath = osp.join(cfg.data.cachedir, "database.pkl")
        if osp.isfile(self.fpath):
            if verbose:
                print(f"Found cached database: {self.fpath}")
            return
        self._build(annotations, verbose)

    def _build(self, annotations, verbose):
        from vision3d_tpu_torch.data.kitti import read_velo

        database = defaultdict(list)
        for anno in annotations.values():
            pts = read_velo(anno["velo_path"])
            boxes, class_idx = anno["boxes"], anno["class_idx"]
            if len(boxes) == 0:
                continue
            per_box = points_in_cuboids(pts, boxes)
            for c, box, p in zip(class_idx, boxes, per_box):
                if len(p) <= self.cfg.aug.min_num_sample_pts or c < 0:
                    continue
                # de-mean to the box's BEV frame
                p = p.copy()
                p[:, :2] -= box[:2]
                b = box.copy()
                b[:2] = 0
                database[int(c)].append(dict(points=p, box=b))
        with open(self.fpath, "wb") as f:
            pickle.dump(dict(database), f)
        if verbose:
            sizes = {k: len(v) for k, v in database.items()}
            print(f"Built gt database {self.fpath}: {sizes}")
