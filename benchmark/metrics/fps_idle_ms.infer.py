"""Time the device ran nothing inside PV-RCNN's furthest point sampling
(``v3d:fps``: one host-dispatched step a keypoint) per batch, in ms."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.idle_us(run.trace, "fps")
    return None if us is None else us * 1e-3 / run.units
