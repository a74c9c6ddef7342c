"""Device time of the collectives outside the gradient all-reduce per
training step, in ms, the largest over the ranks: NCCL's kernels launched
anywhere but inside ``v3d:allreduce``, that is the global sums of every
batch norm's statistics (``mesh.global_sum``, forward and backward) and of
the loss normalisers (``mesh.sum_over_ranks``). A collective's kernel runs
until every rank has joined it, so the time holds each wait for the
slowest rank. Nothing to read on one rank, where no collective runs."""

from harness import program_spans

SUBMODULES = []
KERNELS = []
OVER_RANKS = "max"
NCCL = r"^nccl"


def read(run):
    inside = program_spans.kernel_us(run.trace, "allreduce", any_thread=True, match=NCCL)
    if inside is None:
        return None
    us = run.trace.kernel_us([NCCL]) - inside
    return us * 1e-3 / run.units if us else None
