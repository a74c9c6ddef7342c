"""Device time of the voxelizer (``v3d:voxelize``: voxelize, mean VFE, the
key sort or the columns) per batch, in ms: the kernels launched inside the
program's span."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.kernel_us(run.trace, "voxelize")
    return None if us is None else us * 1e-3 / run.units
