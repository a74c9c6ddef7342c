// Rulebook gather-GEMM (full-tap sparse convolution) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel vision3d_tpu/ops/pallas/sparse_conv.py:52
// (fused_gather_gemm): out[n] = concat_k(table[idx[n, k]]) @ W, the compute
// of conv_rulebook_apply (vision3d_tpu/ops/sparse.py:1589). The TPU version
// pads C to 128 lanes, keeps the whole table in VMEM and copies rows one at
// a time through SMEM indices before one MXU product per tile; none of that
// is carried over. Here the kernel reads the batched sparse tensor and the
// rulebook directly:
//
//   out[b, m, :] = sum over taps k with row = rb[b, m*K + k] in [0, N) of
//                  feats[b, row, :] @ W[k*C : (k+1)*C, :]
//
// A row outside [0, N) is a miss and reads as zero (the JAX wrapper appends
// a zero row N; no such row and no flattening of the batch is needed here).
// Sums are float32. The same kernels run the forward (C -> Cout), and the
// dX of the backward with the (transpose) rulebook and tap-flipped
// transposed weights (Cout -> C).
//
// What bounds it on the H100: per hit a site gathers one C-wide row (8 to
// 256 bytes) and does 2*C*Cout flops; counting each input row once, bytes
// bound it at every training shape, but the rows are gathered: a row is
// read once per tap that hits it (up to 27 times), from L2.
//
// Two routes, chosen by the wrapper from (dtype, C, Cout) alone:
//
// * "mma" (gather_gemm_mma_kernel), bf16 with C % 16 == 0 and Cout % 8 ==
//   0: tiles of 64 consecutive flattened sites on the tensor cores, the
//   design of gather_tile_mma.cuh (cp.async-staged gathered rows and
//   weight slices in a two-stage ring, ldmatrix + mma.sync m16n8k16 bf16
//   -> f32, only the taps some site of the tile hits). The tile's T*K
//   rulebook entries are read once, coalesced, into shared memory as
//   global row numbers (b*N + row, -1 for a miss).
// * "fma" (gather_gemm_kernel), float32 (the card-vs-CPU checks need exact
//   f32 products, which TF32 tensor cores would not give), and bf16 with
//   C % 16 != 0 or Cout % 8 != 0: one site per min(32, Cout) lanes, lanes
//   over output channels. A tap no site of the warp hits is skipped
//   (__any_sync).
//   A gathered row is loaded once, one element per lane, and broadcast by
//   shuffles; FMA in float32. Rows need no alignment (C = 4 bf16 rows are
//   8 bytes): no vector load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_tile_mma.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- fma route

template <typename T, int COUT>
__global__ void __launch_bounds__(256)
gather_gemm_kernel(const T* __restrict__ feats, const int* __restrict__ rb,
                   const T* __restrict__ weight, float* __restrict__ out,
                   int B, int N, int M, int K, int C) {
  constexpr int LPS = COUT >= 32 ? 32 : COUT;  // lanes per site
  constexpr int OPT = COUT / LPS;              // outputs per lane
  constexpr int SPW = 32 / LPS;                // sites per warp
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPS;
  const long long total = (long long)B * M;
  const long long warp0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;

  // the loop bound is the same for all lanes of a warp, so every shuffle
  // and vote below sees the whole warp
  for (long long base = warp0 * SPW; base < total; base += nwarps * SPW) {
    const long long site = base + lane / LPS;
    const bool live = site < total;
    const long long b = live ? site / M : 0;
    const T* fb = feats + b * (long long)N * C;
    const int* rbs = rb + (live ? site : 0) * (long long)K;
    float acc[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

    for (int k = 0; k < K; ++k) {
      const int row = live ? rbs[k] : -1;
      const bool on = row >= 0 && row < N;
      if (!__any_sync(full, on)) continue;
      const T* frow = fb + (long long)(on ? row : 0) * C;
      const T* wtap = weight + (long long)k * C * COUT + sub * OPT;
      for (int c0 = 0; c0 < C; c0 += LPS) {
        float v = 0.f;
        if (on && c0 + sub < C) v = to_f(frow[c0 + sub]);
        const int cn = min(LPS, C - c0);
        for (int cc = 0; cc < cn; ++cc) {
          const float f = __shfl_sync(full, v, cc, LPS);
          const T* wr = wtap + (long long)(c0 + cc) * COUT;
#pragma unroll
          for (int o = 0; o < OPT; ++o) acc[o] = fmaf(f, to_f(wr[o]), acc[o]);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int o = 0; o < OPT; ++o) out[site * COUT + sub * OPT + o] = acc[o];
    }
  }
}

template <typename T, int COUT>
cudaError_t launch_fma(const void* feats, const void* rb, const void* weight,
                       void* out, int B, int N, int M, int K, int C,
                       cudaStream_t stream) {
  constexpr int LPS = COUT >= 32 ? 32 : COUT;
  constexpr int SPW = 32 / LPS;
  const int threads = 256;
  const long long sites_per_block = (long long)(threads / 32) * SPW;
  long long blocks = ((long long)B * M + sites_per_block - 1) / sites_per_block;
  const long long max_blocks = 132LL * 32;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  gather_gemm_kernel<T, COUT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(rb),
      static_cast<const T*>(weight), static_cast<float*>(out), B, N, M, K, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* feats, const void* rb, const void* weight,
                         void* out, int B, int N, int M, int K, int C,
                         int cout, cudaStream_t stream) {
  switch (cout) {
    case 4:
      return launch_fma<T, 4>(feats, rb, weight, out, B, N, M, K, C, stream);
    case 8:
      return launch_fma<T, 8>(feats, rb, weight, out, B, N, M, K, C, stream);
    case 16:
      return launch_fma<T, 16>(feats, rb, weight, out, B, N, M, K, C, stream);
    case 32:
      return launch_fma<T, 32>(feats, rb, weight, out, B, N, M, K, C, stream);
    case 64:
      return launch_fma<T, 64>(feats, rb, weight, out, B, N, M, K, C, stream);
    case 128:
      return launch_fma<T, 128>(feats, rb, weight, out, B, N, M, K, C, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- mma route

namespace gt = gather_tile;
typedef gt::bf16 bf16;

// The tile's rulebook is read once, coalesced, into shared memory as
// global rows b*N + row (-1: miss); the rest is gt::tile_mma.
template <int COUT>
__global__ void __launch_bounds__(gt::THREADS)
gather_gemm_mma_kernel(const bf16* __restrict__ feats,
                       const int* __restrict__ rb,
                       const bf16* __restrict__ weight,
                       float* __restrict__ out, int B, int N, int M, int K,
                       int C) {
  constexpr int T = gt::Shape<COUT>::T;
  extern __shared__ int4 smem_raw[];
  const gt::TileSmem sm = gt::carve_smem<COUT>(smem_raw, K, C);
  const int tid = threadIdx.x;
  const int total = B * M;  // < INT_MAX, checked by the launcher
  const int tile0 = blockIdx.x * T;

  for (int k = tid; k < K; k += gt::THREADS) sm.hit[k] = 0;
  __syncthreads();
  const long long e0 = (long long)tile0 * K;
  for (int e = tid; e < T * K; e += gt::THREADS) {
    const int i = e / K;
    const int site = tile0 + i;
    int g = -1;
    if (site < total) {
      const int row = rb[e0 + e];
      if (row >= 0 && row < N) {
        g = (site / M) * N + row;
        sm.hit[e - i * K] = 1;
      }
    }
    sm.grow[e] = g;
  }
  __syncthreads();
  gt::tile_mma<COUT>(feats, weight, out, total, tile0, K, C, sm);
}

template <int COUT>
struct MmaKernel {
  static auto fn() { return gather_gemm_mma_kernel<COUT>; }
};

cudaError_t dispatch_mma(const void* feats, const void* rb, const void* weight,
                         void* out, int B, int N, int M, int K, int C,
                         int cout, cudaStream_t stream) {
  if (!gt::sizes_fit(B, N, M, C)) return cudaErrorInvalidValue;
  return gt::launch_tiles<MmaKernel>(
      cout, (long long)B * M, K, C, stream, static_cast<const bf16*>(feats),
      static_cast<const int*>(rb), static_cast<const bf16*>(weight),
      static_cast<float*>(out), B, N, M, K, C);
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype 0 = float32, 1 = bf16
// for both feats and weight; route 0 = fma, 1 = mma (bf16 only; feats and
// weight 16-byte aligned). Returns the cudaError_t of the launch.
extern "C" int gather_gemm_launch(const void* feats, const void* rb,
                                  const void* weight, void* out, int B, int N,
                                  int M, int K, int C, int cout, int dtype,
                                  int route, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N <= 0 || C <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1 && dtype == 1) {
    err = dispatch_mma(feats, rb, weight, out, B, N, M, K, C, cout, s);
  } else if (route == 0 && dtype == 0) {
    err = dispatch_fma<float>(feats, rb, weight, out, B, N, M, K, C, cout, s);
  } else if (route == 0 && dtype == 1) {
    err = dispatch_fma<bf16>(feats, rb, weight, out, B, N, M, K, C, cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* gather_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
