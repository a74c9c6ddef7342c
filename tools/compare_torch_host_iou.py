"""Compare the port's torch rotated IoU (``core/iou.py``) on CPU tensors
with its numpy copy (``core/iou_host.py``, which the tests hold bit-equal
to the JAX package's) on the two host uses of the geometry:

- the evaluator's 3D IoU matrix, computed in float32
  (``eval/kitti_eval.box3d_iou_matrix``, the boxes of
  ``tests/test_torch_eval_cli.py::test_box3d_iou_matrix_bit_equal``);
- the paste augmentation's collision IoU, computed in float64 and returned
  in float32 (``np_pairwise_rotated_iou``, the boxes of
  ``tests/test_torch_data.py::test_host_rotated_iou_bit_equal``).

For each it prints the entries that differ and the largest difference.
Numpy only on the host side; no card, no JAX.

    python tools/compare_torch_host_iou.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vision3d_tpu_torch.core import iou, iou_host  # noqa: E402
from vision3d_tpu_torch.eval import kitti_eval  # noqa: E402


def _torch_intersection(boxes1, boxes2, angle_mode="degrees"):
    return iou.rotated_box_intersection(torch.from_numpy(np.ascontiguousarray(boxes1)),
                                        torch.from_numpy(np.ascontiguousarray(boxes2)),
                                        angle_mode).numpy()


def _report(name, got, want):
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    print(f"{name}: {int((got != want).sum())} of {want.size} entries differ, "
          f"largest difference {diff.max():.6g} ({got.dtype})")


def main():
    rng = np.random.default_rng(3)
    wlh = [0.5, 0.6, 1.4], [1.9, 4.5, 1.9]

    def boxes(n):
        xyz = rng.uniform([0, -4, -2], [8, 4, 0], (n, 3))
        return np.column_stack([xyz, rng.uniform(*wlh, (n, 3)),
                                rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)

    a = boxes(40)
    b = np.concatenate([a[:20] + rng.normal(0, 0.2, (20, 7)).astype(np.float32), boxes(15)])
    want = kitti_eval.box3d_iou_matrix(a, b)
    host = kitti_eval.rotated_box_intersection
    kitti_eval.rotated_box_intersection = _torch_intersection
    try:
        got = kitti_eval.box3d_iou_matrix(a, b)
    finally:
        kitti_eval.rotated_box_intersection = host
    _report("evaluator 3D IoU, float32", got, want)

    rng = np.random.default_rng(6)
    c = np.column_stack([rng.uniform(0, 6, (80, 2)), rng.uniform(0.5, 4, (80, 2)),
                         rng.uniform(-3, 3, (80, 1))]).astype(np.float32)
    c[40:] = c[:40] + rng.normal(0, 0.3, (40, 5)).astype(np.float32)
    for mode in ("degrees", "radians"):
        want = iou_host.np_pairwise_rotated_iou(c, c, mode)
        c64 = torch.from_numpy(c.astype(np.float64))
        got = iou.pairwise_rotated_iou(c64, c64, mode).numpy().astype(np.float32)
        _report(f"collision IoU, float64, {mode}", got, want)


if __name__ == "__main__":
    main()
