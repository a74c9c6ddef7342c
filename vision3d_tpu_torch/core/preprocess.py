"""Host preprocessing facade (a copy of ``vision3d_tpu/core/preprocess.py``).

Voxelization runs on the device inside the model, so the host only pads
point clouds to a fixed capacity; ``Preprocessor.voxelize_host`` gives
reference-shaped (features, coords, occupancy) arrays for pipelines that
want them, from the native C++ host voxelizer (``utils/native.py``) when
it builds here, else from the numpy voxelizer, as the JAX package does.
"""

import numpy as np

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.voxelize import voxelize_np
from vision3d_tpu_torch.data.loader import collate, pad_points


class Preprocessor:
    """Build fixed-capacity batch arrays from a dict with 'points' lists."""

    def __init__(self, cfg: Config, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def voxelize_host(self, points: np.ndarray):
        """Host voxelization: (features (Nv, K, C), coords (Nv, 3) ZYX,
        occupancy (Nv,)). Uses the native C++ library when available, else
        the numpy version (the same arrays)."""
        from vision3d_tpu_torch.utils import native

        if native.available():
            return native.hard_voxelize(points, self.cfg)
        return voxelize_np(points, self.cfg)

    def __call__(self, item: dict) -> dict:
        """item['points']: list of (Np, C) arrays -> padded batch arrays
        ('points' (B, P, C), 'num_points' (B,)); other keys pass through."""
        P = self.cfg.capacity.max_points
        padded, nums = [], []
        for p in item["points"]:
            arr, n = pad_points(np.asarray(p, np.float32), P, self.rng)
            padded.append(arr)
            nums.append(n)
        out = dict(item)
        out["points"] = np.stack(padded)
        out["num_points"] = np.asarray(nums, np.int32)
        out["batch_size"] = len(padded)
        return out


class TrainPreprocessor(Preprocessor):
    """Collate a list of dataset samples into one fixed-capacity batch."""

    def collate(self, items):
        return collate(items, self.cfg, self.rng)
