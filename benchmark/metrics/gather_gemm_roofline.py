"""Kernel B2 (``csrc/gather_gemm.cu``) in a training step against its least
time: every sparse conv's forward and every input gradient but the first
conv's, counted on the reference's neighbour pairs, over the measured time
of the kernels."""

from harness import counts

SUBMODULES = []
KERNELS = [r"gather_gemm(_mma)?_kernel"]


def read(run):
    t = run.trace.kernel_us(KERNELS) * 1e-6
    if t <= 0:
        return None
    least = 0.0
    for uc in run.unit_counts:
        convs = counts.sparse_convs(uc)
        least += sum(counts.conv_least_s(c) for c in convs)
        least += sum(counts.conv_dx_least_s(c) for c in convs[1:])
    return 100.0 * least / t
