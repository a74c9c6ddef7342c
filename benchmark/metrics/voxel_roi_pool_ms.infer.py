"""Device time of Voxel R-CNN's voxel RoI pooling (``v3d:voxel_roi_pool``:
the grid points, the three voxel queries, grouping and the pooling MLPs)
per batch, in ms: the kernels launched inside the program's span."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.kernel_us(run.trace, "voxel_roi_pool")
    return None if us is None else us * 1e-3 / run.units
