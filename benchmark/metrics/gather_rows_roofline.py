"""Kernels B4/B5 (``csrc/gather_rows.cu``) in a training step against their
least time: each sparse conv's weight gradient regathers its columns, each
active input row read once and each neighbour pair's row written once."""

from harness import counts

SUBMODULES = []
KERNELS = [r"gather_rows_kernel"]


def read(run):
    t = run.trace.kernel_us(KERNELS) * 1e-6
    if t <= 0:
        return None
    least = sum(counts.regather_least_s(c) for uc in run.unit_counts
                for c in counts.sparse_convs(uc))
    return 100.0 * least / t
