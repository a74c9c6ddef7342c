"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
a JAX Config turned into the port's Config, and seeded numpy inputs."""

import dataclasses
import pathlib

import numpy as np

from vision3d_tpu_torch import config as tconfig
from vision3d_tpu_torch.synthetic import kitti_like_points

ROOT = pathlib.Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "second" / "all_classes.yaml"
WEIGHTS = ROOT / "vision3d_tpu_torch" / "weights" / "second_all_classes_epoch11.npz"


def port_cfg(cfg):
    """The port's Config with every field of a vision3d_tpu Config."""
    d = dataclasses.asdict(cfg)
    anchors = tuple(tconfig.AnchorConfig(**a) for a in d.pop("anchors"))
    subs = dict(psa=tconfig.PSAConfig, gridpool=tconfig.GridPoolConfig,
                proposal=tconfig.ProposalConfig,
                refinement=tconfig.RefinementConfig, data=tconfig.DataConfig,
                train=tconfig.TrainConfig, aug=tconfig.AugConfig,
                capacity=tconfig.CapacityConfig)
    for name, cls in subs.items():
        d[name] = cls(**d[name])
    return tconfig.Config(anchors=anchors, **d)


def uniform_points(cfg, rng, batch, n):
    """(batch, n, 4) float32 points uniform over the grid bounds."""
    lo = np.asarray(cfg.grid_bounds[:3])
    hi = np.asarray(cfg.grid_bounds[3:])
    pts = rng.uniform(lo, hi, (batch, n, 3))
    inten = rng.uniform(0, 1, (batch, n, 1))
    return (np.concatenate([pts, inten], -1).astype(np.float32),
            np.full((batch,), n, np.int32))


def sorted_key_sets(rng, grid, batch, n, lo, hi):
    """Random sorted active key sets: (keys (B, N) int32 sentinel-padded,
    mask (B, N)), each sample with between lo and hi active voxels."""
    d, h, w = grid
    keys, mask = [], []
    for _ in range(batch):
        nact = int(rng.integers(lo, hi))
        k = np.sort(rng.choice(d * h * w, nact, replace=False)).astype(np.int32)
        keys.append(np.concatenate([k, np.full(n - nact, d * h * w, np.int32)]))
        mask.append(np.arange(n) < nact)
    return np.stack(keys), np.stack(mask)


def kitti_like_frames(cfg, seed, batch=2):
    """KITTI-like clouds cropped to the grid of ``cfg``: objects, ground,
    clutter; (points (batch, n, 4), num_points (batch,) int32)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(cfg.grid_bounds[:3]), np.asarray(cfg.grid_bounds[3:])
    clouds = []
    for _ in range(batch):
        p = kitti_like_points(rng, 30000)
        p = p[((p[:, :3] >= lo) & (p[:, :3] < hi)).all(1)]
        clouds.append(p[:1500])
    n = min(len(c) for c in clouds)
    return np.stack([c[:n] for c in clouds]), np.full((batch,), n, np.int32)


class ShardSet:
    """A dataset for the loader tests: frame i is a seeded cloud and boxes
    of its own (sizes vary), jittered by draws from ``self.rng``, which the
    loaders swap for each batch's own generator, as the KITTI dataset's
    augmentation draws."""

    def __init__(self, n=37):
        self.n = n
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(1000 + i)
        pts = r.normal(size=(int(r.integers(50, 300)), 4)).astype(np.float32)
        pts[:, :3] += self.rng.normal(0, 0.1, 3).astype(np.float32)
        g = int(r.integers(0, 5))
        return dict(points=pts, boxes=r.normal(size=(g, 7)).astype(np.float32),
                    class_idx=r.integers(0, 3, g).astype(np.int32), idx=i)
