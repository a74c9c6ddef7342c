"""Device time of target assignment (``v3d:target_assign``: anchor-box IoU,
matching, box encoding) per training step, in ms."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.kernel_us(run.trace, "target_assign")
    return None if us is None else us * 1e-3 / run.units
