"""Device time of the gradient all-reduce (``v3d:allreduce``:
``mesh.all_reduce_gradients``, the flattening copy, the collective and the
copy back) per training step, in ms, the largest over the ranks. A
collective's kernel runs until every rank has joined it, so the time
holds the wait for the slowest rank. Nothing to read on one rank, where
the span launches no kernel."""

from harness import program_spans

SUBMODULES = []
KERNELS = []
OVER_RANKS = "max"


def read(run):
    us = program_spans.kernel_us(run.trace, "allreduce", any_thread=True)
    return us * 1e-3 / run.units if us else None
