"""Time the device ran nothing inside the optimizer (``v3d:optimizer``:
zeroing the gradients, then the clip, learning rate and Adam) per training
step, in ms."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.idle_us(run.trace, "optimizer")
    return None if us is None else us * 1e-3 / run.units
