"""The arithmetic of the training steps in the traced stretch (forward,
input and weight gradients of every layer, as ``counts.train_flops``),
over the stretch's wall time and the bf16 peak, in %."""

from harness import counts

SUBMODULES = []
KERNELS = []


def read(run):
    flops = sum(counts.train_flops(uc) for uc in run.unit_counts)
    return 100.0 * flops / (run.wall_s * counts.BF16_FLOP_PER_S) if flops > 0 else None
