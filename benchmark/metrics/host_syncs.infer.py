"""Calls that wait for the device (``program_spans.SYNCS``: stream, device
and event synchronisation, blocking copies) made inside the program's
forward (``v3d:inference``) per batch; the benchmark's own read-back of the
detections lies outside it."""

from harness import program_spans

SUBMODULES = []
KERNELS = []


def read(run):
    n = program_spans.count(run.trace, "inference")
    return None if n is None else n / run.units
