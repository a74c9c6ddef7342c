"""Kernel K2 (``csrc/voxel_query.cu``) against its least time, in %. Each
query's work comes from the reference's own scan (the model file's
``counts``, entries ``voxel_query<k>``): its distance tests (the occupied
in-grid window cells a scan that stops at the ``nsample``-th hit meets), 8
float32 operations each, over the H100 SXM's 67 TFLOP/s outside the tensor
cores; and its bytes (each grid point's xyz and cell read once, each
occupied voxel's centre read once, the (G, nsample) int32 rows written
once) over the memory bandwidth. A query's least time is the larger of the
two; the share is their sum over the measured time of the kernel's
launches."""

from harness import counts

SUBMODULES = []
KERNELS = [r"voxel_query_kernel"]
FP32_FLOP_PER_S = 67e12         # NVIDIA H100 SXM data sheet, float32 without tensor cores
OPS_PER_TEST = 8                # three differences, three squares, two sums


def read(run):
    t = run.trace.kernel_us(KERNELS) * 1e-6
    if t <= 0:
        return None
    least = sum(max(c["tests"] * OPS_PER_TEST / FP32_FLOP_PER_S,
                    c["bytes"] / counts.HBM_BYTES_PER_S)
                for uc in run.unit_counts for c in uc if "tests" in c)
    return 100.0 * least / t
