"""KITTI dataset: label / calib parsing, annotation cache, dataset objects
(a numpy copy of ``vision3d_tpu/data/kitti.py``).

KITTI label lines parse into objects with the class map {Car, Van -> 0;
Pedestrian, Person_sitting -> 1; Cyclist -> 2; else -1} and easy /
moderate / hard difficulty levels; calib files give P2 / R0 / V2C with C2V
the rigid inverse; camera-frame boxes convert to the velodyne frame as
xyz = C2V @ [R0 @ t, 1], box = [xyz, w, l, h, -ry] (the label's y is
shifted up by h/2 when parsed, so t is the box centre); velodyne scans are
cropped once to the camera FOV into ``velodyne_reduced/``. Samples are
numpy dicts; targets are assigned inside the train step, on the device.

The annotations of a split are cached in ``{cachedir}/{split}.torch.pkl``,
this package's own file: the JAX package's ``{split}.pkl`` holds pickled
``vision3d_tpu`` objects, and unpickling it would import that package. The
gt database (``database.pkl``, dicts of numpy arrays) is the same file in
both packages.
"""

import os
import os.path as osp
import pickle
from dataclasses import dataclass

import numpy as np

from vision3d_tpu_torch.config import Config

CLASS_NAME_TO_IDX = {
    "Car": 0,
    "Van": 0,
    "Pedestrian": 1,
    "Person_sitting": 1,
    "Cyclist": 2,
}

# Approximate KITTI image2 extent of the FOV crop.
IMAGE_WH = np.array([1224, 370])


@dataclass
class Object3d:
    """One KITTI label line."""

    class_name: str
    class_idx: int
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray          # (4,) xmin ymin xmax ymax
    h: float
    w: float
    l: float
    t: tuple                   # camera-frame box CENTER (y shifted by h/2)
    ry: float
    score: float
    level: int                 # 1 easy / 2 moderate / 3 hard / 4 unknown

    @classmethod
    def parse(cls, line: str) -> "Object3d":
        f = line.split(" ")
        vals = [float(x) for x in f[1:]]
        name = f[0]
        h, w, l = vals[7], vals[8], vals[9]
        box2d = np.array(vals[3:7])
        height = box2d[3] - box2d[1] + 1
        trunc, occ = vals[0], int(vals[1])
        if height >= 40 and trunc <= 0.15 and occ <= 0:
            level = 1
        elif height >= 25 and trunc <= 0.3 and occ <= 1:
            level = 2
        elif height >= 25 and trunc <= 0.5 and occ <= 2:
            level = 3
        else:
            level = 4
        return cls(
            class_name=name,
            class_idx=CLASS_NAME_TO_IDX.get(name, -1),
            truncation=trunc,
            occlusion=occ,
            alpha=vals[2],
            box2d=box2d,
            h=h, w=w, l=l,
            t=(vals[10], vals[11] - h / 2, vals[12]),
            ry=vals[13],
            score=vals[14] if len(vals) == 15 else -1.0,
            level=level,
        )


@dataclass
class Calib:
    """KITTI calibration."""

    P2: np.ndarray   # (3, 4)
    R0: np.ndarray   # (3, 3)
    V2C: np.ndarray  # (3, 4)
    C2V: np.ndarray = None  # (3, 4) rigid inverse of V2C (derived if None)
    WH: np.ndarray = None

    def __post_init__(self):
        if self.C2V is None:
            C2V = np.zeros_like(self.V2C)
            C2V[:, :3] = self.V2C[:, :3].T
            C2V[:, 3] = -self.V2C[:, :3].T @ self.V2C[:, 3]
            self.C2V = C2V
        if self.WH is None:
            self.WH = IMAGE_WH

    @classmethod
    def parse(cls, path: str) -> "Calib":
        with open(path) as f:
            lines = f.readlines()

        def grab(i):
            return np.array(lines[i].strip().split(" ")[1:], dtype=np.float32)

        return cls(
            P2=grab(2).reshape(3, 4),
            R0=grab(4).reshape(3, 3),
            V2C=grab(5).reshape(3, 4),
        )


def read_label(path: str):
    with open(path) as f:
        return [Object3d.parse(line.rstrip()) for line in f if line.strip()]


def read_velo(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def filter_camera_fov(calib: Calib, points: np.ndarray) -> np.ndarray:
    """Crop to the points visible in image2."""
    keep = points[:, 0] > 0
    p = points[keep, :3]
    ones = np.ones_like(p[:, :1])
    cam = (calib.R0 @ calib.V2C) @ np.concatenate([p, ones], axis=1).T
    img = calib.P2 @ np.concatenate([cam, ones.T], axis=0)
    uv = (img[:2] / img[2:3]).T
    inside = ((uv >= 0) & (uv <= calib.WH)).all(axis=1)
    keep[keep] &= inside
    return points[keep]


def camera_box_to_velo(obj: Object3d, calib: Calib) -> np.ndarray:
    """Camera-frame object -> velodyne 7-dof box (xyz = C2V @ [R0 @ t, 1];
    yaw = -ry)."""
    xyz = calib.C2V @ np.concatenate([calib.R0 @ np.asarray(obj.t), [1.0]])
    return np.concatenate([xyz, [obj.w, obj.l, obj.h, -obj.ry]]).astype(np.float32)


class AnnotationLoader:
    """Create-or-load the per-split annotation cache; one-time FOV crop of
    the velodyne scans into velodyne_reduced/."""

    def __init__(self, cfg: Config, inds, split="val", verbose=True):
        self.cfg = cfg
        self.inds = inds
        self.split = split
        self.verbose = verbose
        self.cache_path = osp.join(cfg.data.cachedir, f"{split}.torch.pkl")
        self.annotations = self._load()

    def _log(self, msg):
        if self.verbose:
            print(msg)

    def _load(self):
        if osp.isfile(self.cache_path):
            with open(self.cache_path, "rb") as f:
                cached = pickle.load(f)
            # the cache must cover the requested split (a cache built from
            # a subset would KeyError mid-epoch): otherwise rebuild
            missing = [i for i in self.inds if i not in cached]
            if not missing:
                self._log(f"Loading cached annotations: {self.cache_path}")
                return cached
            self._log(
                f"Cache {self.cache_path} lacks {len(missing)} of "
                f"{len(self.inds)} frames; rebuilding"
            )
        os.makedirs(self.cfg.data.cachedir, exist_ok=True)
        annotations = self._create()
        self._crop_points(annotations)
        with open(self.cache_path, "wb") as f:
            pickle.dump(annotations, f)
        self._log(f"Cached annotations: {self.cache_path}")
        return annotations

    def _path(self, subdir, idx, ext):
        return osp.join(self.cfg.data.rootdir, subdir, f"{idx:06d}.{ext}")

    def _create(self):
        annotations = {}
        for idx in self.inds:
            objects = read_label(self._path("label_2", idx, "txt"))
            calib = Calib.parse(self._path("calib", idx, "txt"))
            boxes = (
                np.stack([camera_box_to_velo(o, calib) for o in objects])
                if objects else np.zeros((0, 7), np.float32)
            )
            annotations[idx] = dict(
                idx=idx,
                velo_path=self._path("velodyne_reduced", idx, "bin"),
                calib=calib,
                boxes=boxes,
                class_idx=np.array([o.class_idx for o in objects], np.int64),
                levels=np.array([o.level for o in objects], np.int64),
                names=[o.class_name for o in objects],
            )
        return annotations

    def _crop_points(self, annotations):
        # per-file (not per-directory) existence check: splits share the
        # directory, so a directory-level skip would leave every split
        # after the first without its reduced scans
        out_dir = osp.join(self.cfg.data.rootdir, "velodyne_reduced")
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for anno in annotations.values():
            base = osp.basename(anno["velo_path"])
            out_path = osp.join(out_dir, base)
            if osp.isfile(out_path):
                continue
            pts = read_velo(osp.join(self.cfg.data.rootdir, "velodyne", base))
            pts = filter_camera_fov(anno["calib"], pts)
            pts.astype(np.float32).tofile(out_path)
            n += 1
        if n:
            self._log(f"Wrote {n} reduced scans: {out_dir}")


class KittiDataset:
    """Map-style dataset yielding numpy sample dicts."""

    def __init__(self, cfg: Config, split="val", verbose=True):
        self.cfg = cfg
        self.split = split
        split_file = osp.join(cfg.data.splitdir, f"{split}.txt")
        self.inds = np.loadtxt(split_file, dtype=np.int32).tolist()
        self.annotations = AnnotationLoader(cfg, self.inds, split, verbose).annotations

    def __len__(self):
        return len(self.inds)

    def filter_bad_objects(self, item):
        keep = (item["class_idx"] != -1) & (item["boxes"][:, 3:6] > 0).all(1)
        item["boxes"] = item["boxes"][keep]
        item["class_idx"] = item["class_idx"][keep]

    def filter_out_of_bounds(self, item):
        xyz = item["boxes"][:, :3]
        lo = np.asarray(self.cfg.grid_bounds[:3])
        hi = np.asarray(self.cfg.grid_bounds[3:])
        keep = ((xyz >= lo) & (xyz <= hi)).all(1)
        item["boxes"] = item["boxes"][keep]
        item["class_idx"] = item["class_idx"][keep]

    def preprocessing(self, item):
        pass

    def __getitem__(self, i):
        anno = self.annotations[self.inds[i]]
        item = dict(
            idx=anno["idx"],
            points=read_velo(anno["velo_path"]),
            boxes=anno["boxes"].copy(),
            class_idx=anno["class_idx"].copy(),
        )
        self.preprocessing(item)
        return item


class KittiDatasetTrain(KittiDataset):
    """Adds point shuffling and augmentation; targets are not assigned
    here but in the train step."""

    def __init__(self, cfg: Config, verbose=True, rng=None):
        super().__init__(cfg, split="train", verbose=verbose)
        from vision3d_tpu_torch.data.augment import ChainedAugmentation, DatabaseBuilder

        DatabaseBuilder(cfg, self.annotations, verbose=verbose)
        self.augmentation = ChainedAugmentation(cfg)
        self.rng = rng or np.random.default_rng()

    def preprocessing(self, item):
        self.rng.shuffle(item["points"])
        self.filter_bad_objects(item)
        points, boxes, class_idx = self.augmentation(
            item["points"], item["boxes"], item["class_idx"], self.rng
        )
        item.update(points=points, boxes=boxes, class_idx=class_idx)
        self.filter_out_of_bounds(item)
