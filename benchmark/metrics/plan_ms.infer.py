"""Device time of the middle extractor's rulebook and active-set builds
(``v3d:plan``) per batch, in ms: the kernels launched inside the program's
spans."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.kernel_us(run.trace, "plan")
    return None if us is None else us * 1e-3 / run.units
