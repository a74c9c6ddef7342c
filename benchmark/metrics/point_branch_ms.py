"""Device time of PV-RCNN's point branch (``model.pnets``: the ten ball
queries, grouping and shared MLPs of the five set abstractions) per batch,
in ms: the kernels launched inside the ``pnets.<i>`` spans."""

SUBMODULES = [f"pnets.{i}" for i in range(5)]
KERNELS = []


def read(run):
    us = run.trace.span_kernel_us(SUBMODULES)
    return us * 1e-3 / run.units if us > 0 else None
