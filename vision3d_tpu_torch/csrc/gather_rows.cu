// Row gather out[i, :] = table[idx[i], :] for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels with one: vision3d_tpu/ops/pallas/gather.py:34
// (gather_rows: table resident in VMEM, index tiles through SMEM, one
// dynamic sublane copy per row) and vision3d_tpu/ops/pallas/dma_gather.py:29
// (dma_gather_rows: one HBM-to-VMEM DMA per row, a block of copies in
// flight on one semaphore). Both compute the same function; their tile
// sizes, lane padding and "M divides by block_rows" are TPU constraints and
// not the contract. Here: any Q, any row width, float32 or bf16 (the kernel
// moves bytes and does not look at the type).
//
// What bounds it on the H100: bytes only (Q rows read, Q rows written, Q
// indices read). Rows are 8 to 256 bytes, less than or about one 128-byte
// line, so what matters is that the lanes of a warp cover whole rows with
// the widest loads the row allows. Design: a row is cut into chunks of VEC
// bytes (16, 8, 4, 2 or 1: the widest that divides the row's bytes and the
// alignment of both base pointers, chosen by the launcher), and each thread
// moves one chunk; consecutive threads take consecutive chunks of one row
// and then the next row, so a warp's stores are one contiguous run of
// 32*VEC bytes and its loads are whole rows. A 16-byte row (C = 4 float32)
// has one thread per row, a 256-byte row sixteen. Grid-stride over chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                   V* __restrict__ out, long long Q, int chunks) {
  const long long total = Q * chunks;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long q = t / chunks;
    const int j = (int)(t - q * chunks);
    out[t] = table[(long long)idx[q] * chunks + j];
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* idx, void* out, long long Q,
                   int row_bytes, cudaStream_t stream) {
  const int chunks = row_bytes / (int)sizeof(V);
  const int threads = 256;
  long long blocks = (Q * chunks + threads - 1) / threads;
  const long long max_blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(idx),
      static_cast<V*>(out), Q, chunks);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Rows are row_bytes wide in both
// table and out (contiguous); idx holds Q int32 rows in [0, R), which the
// caller guarantees. Returns the cudaError_t of the launch.
extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  void* out, long long Q, int row_bytes,
                                  void* stream) {
  if (Q <= 0) return 0;
  if (row_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
      (uintptr_t)row_bytes;
  cudaError_t err;
  if (align % 16 == 0) {
    err = launch<uint4>(table, idx, out, Q, row_bytes, s);
  } else if (align % 8 == 0) {
    err = launch<uint2>(table, idx, out, Q, row_bytes, s);
  } else if (align % 4 == 0) {
    err = launch<uint32_t>(table, idx, out, Q, row_bytes, s);
  } else if (align % 2 == 0) {
    err = launch<uint16_t>(table, idx, out, Q, row_bytes, s);
  } else {
    err = launch<uint8_t>(table, idx, out, Q, row_bytes, s);
  }
  return (int)err;
}

extern "C" const char* gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
