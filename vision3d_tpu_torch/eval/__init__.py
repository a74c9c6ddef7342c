"""Evaluation: KITTI 3D AP@R40 (``kitti_eval``)."""
