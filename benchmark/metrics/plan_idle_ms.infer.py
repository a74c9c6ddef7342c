"""Time the device ran nothing while the host built rulebooks and active
sets (inside ``v3d:plan``) per batch, in ms."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    us = program_spans.idle_us(run.trace, "plan")
    return None if us is None else us * 1e-3 / run.units
