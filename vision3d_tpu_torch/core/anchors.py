"""Dense BEV anchor grid (port of ``vision3d_tpu/core/anchors.py``).

Anchor centers are bin midpoints of the BEV grid at the final stride, per
class with per-class (wlh, center_z) and ``num_yaw`` yaw bins. Layout is
(num_classes, num_yaw, ny, nx, 7), so flattened anchor indices line up
with the proposal head's flattened score/reg maps. Per-class center_z is
kept as configured (the reference aliases the last class's value onto all
classes; see the JAX module's docstring). Pure numpy: computed once.
"""

import numpy as np

from vision3d_tpu_torch.config import Config


def _linspace_midpoint(x0, x1, nx):
    """nx bin midpoints of [x0, x1)."""
    dx = (x1 - x0) / nx
    return x0 + dx / 2 + dx * np.arange(nx, dtype=np.float64)


def make_anchors(cfg: Config) -> np.ndarray:
    """Build the anchor grid, shape (num_classes, num_yaw, ny, nx, 7) f32."""
    stride = cfg.strides[-1]
    pixel = np.asarray(cfg.voxel_size[:2]) * stride
    lower = np.asarray(cfg.grid_bounds[:2], dtype=np.float64)
    upper = np.asarray(cfg.grid_bounds[3:5], dtype=np.float64)
    # round, don't truncate: 38.4/0.8 is 47.999... in float64
    nx, ny = np.round((upper - lower) / pixel).astype(np.int64)

    xs = _linspace_midpoint(lower[0], upper[0], nx)
    ys = _linspace_midpoint(lower[1], upper[1], ny)

    n_cls, n_yaw = cfg.num_classes, cfg.num_yaw
    anchors = np.zeros((n_cls, n_yaw, ny, nx, 7), dtype=np.float32)
    anchors[..., 0] = xs[None, None, None, :]
    anchors[..., 1] = ys[None, None, :, None]
    for c, a in enumerate(cfg.anchors[:n_cls]):
        anchors[c, ..., 2] = a.center_z
        anchors[c, ..., 3:6] = np.asarray(a.wlh, dtype=np.float32)
        for j in range(n_yaw):
            anchors[c, j, ..., 6] = a.yaw[j]
    return anchors
