"""Kernel B1 (``csrc/zwin_conv.cu``) against its least time: the sparse
convs of the stages before ``dense_from_stage``, counted on the reference's
neighbour pairs (2*Cin*Cout a pair; bf16 inputs and weights read once, the
float32 output written once), over the measured time of the kernels."""

from harness import counts

SUBMODULES = []
KERNELS = [r"zwin_conv(_mma)?_kernel"]


def read(run):
    t = run.trace.kernel_us(KERNELS) * 1e-6
    if t <= 0:
        return None
    least = sum(counts.conv_least_s(c) for uc in run.unit_counts
                for c in counts.sparse_convs(uc) if c["stage"] < run.cfg["dense_from_stage"])
    return 100.0 * least / t
