"""Sparse-tensor plans, the z-window conv and the other kernels' wrappers
(port of ``vision3d_tpu/ops``), and the public ops surface of
``vision3d_tpu/ops/__init__.py``: the same 17 names, bound to the port's
functions. The four of this package's own modules are bound here; the
others at first access (PEP 562), because the modules that define them
import this package's submodules (``core.targets`` imports ``ops.fps``),
so binding them here at import would be circular. (Binding ``ball_query``
here also keeps the function, not its module, under that name.)
"""

import importlib

from vision3d_tpu_torch.ops.ball_query import ball_query, group_features
from vision3d_tpu_torch.ops.fps import furthest_point_sample, sample_keypoints

_LAZY = {
    "batched_nms": ("core.nms", "batched_nms"),
    "batched_nms_rotated": ("core.nms", "batched_nms_rotated"),
    # the reference's name for the pairwise IoU op (ops/iou_nms.py:9)
    "box_iou_rotated": ("core.iou", "pairwise_rotated_iou"),
    "box_iou_rotated_3d": ("eval.kitti_eval", "box3d_iou_matrix"),
    "nms": ("core.nms", "nms"),
    "nms_rotated": ("core.nms", "nms_rotated"),
    "np_pairwise_rotated_iou": ("core.iou_host", "np_pairwise_rotated_iou"),
    "pairwise_rotated_iou": ("core.iou", "pairwise_rotated_iou"),
    "pairwise_rotated_iou_chunked": ("core.iou", "pairwise_rotated_iou_chunked"),
    "rotated_iou": ("core.iou", "rotated_iou"),
    "sigmoid_focal_loss": ("models.losses", "sigmoid_focal_loss"),
    "smooth_l1": ("models.losses", "smooth_l1"),
    "subsample_labels": ("core.targets", "subsample_labels"),
}

__all__ = sorted([*_LAZY, "ball_query", "furthest_point_sample", "group_features",
                  "sample_keypoints"])


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    value = getattr(importlib.import_module(f"vision3d_tpu_torch.{module}"), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
