"""The configuration's own arithmetic of the forwards in the traced
stretch (the middle extractor as sparse convs on their active sites, the
RPN and head densely, the point branch's and grid pool's MLPs on their
grouped samples), over the stretch's wall time and the bf16 peak, in %."""

from harness import counts

SUBMODULES = []
KERNELS = []


def read(run):
    flops = sum(counts.forward_flops(uc) for uc in run.unit_counts)
    return 100.0 * flops / (run.wall_s * counts.BF16_FLOP_PER_S) if flops > 0 else None
