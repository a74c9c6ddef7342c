"""Time the device ran nothing inside rotated NMS (``v3d:nms``: sort, IoU
matrix, the fixpoint and its read-back each step) per batch, in ms."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.idle_us(run.trace, "nms")
    return None if us is None else us * 1e-3 / run.units
