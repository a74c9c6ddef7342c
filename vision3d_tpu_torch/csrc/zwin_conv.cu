// Z-window sparse 3x3x3 convolution for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vision3d_tpu/ops/pallas/zwin_conv.py:114
// (zwin_conv_gemm_v2, reached through conv_zwin_apply_pallas2). On the TPU
// the row gather and the tap-mask build ran as XLA ops and the kernel only
// consumed dense (B, M, 9*3*C) windows; here the kernel reads the sparse
// tensor and the rulebook directly:
//
//   out[b, m, :] = sum over BEV offsets j2 (9) and taps dz (3) whose bit is
//                  set in pattern[b, m*9 + j2] of
//                  feats[b, start + popcount(pattern & ((1 << dz) - 1)), :]
//                    @ W[(dz*9 + j2)*C : (dz*9 + j2 + 1)*C, :]
//
// (the mask rule of vision3d_tpu/ops/sparse.py:1355-1373). Rows >= N read
// as zero (the JAX wrapper pads kz zero rows). Inputs are float32 or bf16;
// sums are float32. Weight layout is the shared (27*C, Cout),
// tap K = (dz*3 + dy)*3 + dx = dz*9 + j2.
//
// What bounds it on the H100: per active tap a site gathers one C-wide row
// (8 to 64 bytes) and does 2*C*Cout flops; at C, Cout <= 64 that is at most
// ~128 flops per gathered byte, below the ~295 flop/byte at which bf16
// tensor cores would be the limit, so the gathers (bytes) bound it, and
// the sparse taps make it irregular. A row is read once per tap that uses
// it (up to 27 times), mostly from L2.
//
// Two routes, chosen by the wrapper from (dtype, C, Cout) alone, with the
// rule of gather_gemm.cu:
//
// * "mma" (zwin_conv_mma_kernel), bf16 with C % 16 == 0 and Cout % 8 ==
//   0: the tile design of gather_tile_mma.cuh (64 consecutive flattened
//   sites per block of 4 warps, cp.async-staged gathered rows and weight
//   slices in a two-stage ring, ldmatrix + mma.sync m16n8k16 bf16 -> f32,
//   only the taps some site of the tile hits). The tile's rulebook is
//   built in shared memory, not read: the tile's 64 x 9 (start, pattern)
//   pairs are read once, coalesced (72 bytes a site against 108 for a
//   27-tap rulebook), and each expands into its three taps k = dz*9 + j2,
//   row b*N + start + popcount(pattern & ((1 << dz) - 1)) when bit dz is
//   set and start + popcount < N, else -1 (a miss: the windows run past N
//   into the JAX wrapper's zero rows, which are never read).
// * "fma" (zwin_conv_kernel), float32 (the card-vs-CPU checks need exact
//   f32 products, which TF32 tensor cores would not give), and bf16 at
//   C = 4: one site per 32 lanes (two sites per warp when Cout = 16),
//   lanes over output channels. Every lane of a site takes the same
//   branch, so a tap that no site of the warp needs is skipped whole
//   (__any_sync) and nothing diverges. A gathered row is loaded once,
//   coalesced, one element per lane, and broadcast by shuffles; the weight
//   slice of a tap is read by consecutive lanes at consecutive addresses
//   and stays in L1 (at most 27*32*64 values). FMA in float32. Rows need
//   no alignment (C = 4 bf16 rows are 8 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_tile_mma.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int COUT>
__global__ void __launch_bounds__(256)
zwin_conv_kernel(const T* __restrict__ feats, const int* __restrict__ start,
                 const int* __restrict__ pattern, const T* __restrict__ weight,
                 float* __restrict__ out, int B, int N, int M, int C) {
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
    float acc[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

    for (int j2 = 0; j2 < 9; ++j2) {
      int s = 0, p = 0;
      if (live) {
        s = start[site * 9 + j2];
        p = pattern[site * 9 + j2];
      }
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int row = s + __popc(p & ((1 << dz) - 1));
        const bool on = live && ((p >> dz) & 1) && row < N;
        if (!__any_sync(full, on)) continue;
        const T* frow = fb + (long long)(on ? row : 0) * C;
        const T* wtap = weight + (long long)(dz * 9 + j2) * C * COUT + sub * OPT;
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
    }
    if (live) {
#pragma unroll
      for (int o = 0; o < OPT; ++o) out[site * COUT + sub * OPT + o] = acc[o];
    }
  }
}

template <typename T, int COUT>
cudaError_t launch_fma(const void* feats, const void* start,
                       const void* pattern, const void* weight, void* out,
                       int B, int N, int M, int C, cudaStream_t stream) {
  constexpr int LPS = COUT >= 32 ? 32 : COUT;
  constexpr int SPW = 32 / LPS;
  const int threads = 256;
  const long long sites_per_block = (long long)(threads / 32) * SPW;
  long long blocks = ((long long)B * M + sites_per_block - 1) / sites_per_block;
  const long long max_blocks = 132LL * 16;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  zwin_conv_kernel<T, COUT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(start),
      static_cast<const int*>(pattern), static_cast<const T*>(weight),
      static_cast<float*>(out), B, N, M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* feats, const void* start,
                         const void* pattern, const void* weight, void* out,
                         int B, int N, int M, int C, int cout,
                         cudaStream_t stream) {
  switch (cout) {
    case 16:
      return launch_fma<T, 16>(feats, start, pattern, weight, out, B, N, M, C, stream);
    case 32:
      return launch_fma<T, 32>(feats, start, pattern, weight, out, B, N, M, C, stream);
    case 64:
      return launch_fma<T, 64>(feats, start, pattern, weight, out, B, N, M, C, stream);
    case 128:
      return launch_fma<T, 128>(feats, start, pattern, weight, out, B, N, M, C, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- mma route

namespace gt = gather_tile;
typedef gt::bf16 bf16;

constexpr int K2 = 9, KZ = 3, K = KZ * K2;

template <int COUT>
__global__ void __launch_bounds__(gt::THREADS)
zwin_conv_mma_kernel(const bf16* __restrict__ feats,
                     const int* __restrict__ start,
                     const int* __restrict__ pattern,
                     const bf16* __restrict__ weight, float* __restrict__ out,
                     int B, int N, int M, int C) {
  constexpr int T = gt::Shape<COUT>::T;
  extern __shared__ int4 smem_raw[];
  const gt::TileSmem sm = gt::carve_smem<COUT>(smem_raw, K, C);
  const int tid = threadIdx.x;
  const int total = B * M;  // < INT_MAX, checked by the launcher
  const int tile0 = blockIdx.x * T;

  // the tile's rulebook from its (start, pattern) pairs: grow[i*K + k]
  for (int k = tid; k < K; k += gt::THREADS) sm.hit[k] = 0;
  __syncthreads();
  const long long e0 = (long long)tile0 * K2;
  for (int e = tid; e < T * K2; e += gt::THREADS) {
    const int i = e / K2, j2 = e - i * K2;
    const int site = tile0 + i;
    int s = 0, p = 0, base = 0;  // p = 0: every tap of a dead site misses
    if (site < total) {
      s = start[e0 + e];
      p = pattern[e0 + e];
      base = (site / M) * N;
    }
#pragma unroll
    for (int dz = 0; dz < KZ; ++dz) {
      const int row = s + __popc(p & ((1 << dz) - 1));
      const bool on = ((p >> dz) & 1) && row < N;
      sm.grow[i * K + dz * K2 + j2] = on ? base + row : -1;
      if (on) sm.hit[dz * K2 + j2] = 1;
    }
  }
  __syncthreads();
  gt::tile_mma<COUT>(feats, weight, out, total, tile0, K, C, sm);
}

template <int COUT>
struct MmaKernel {
  static auto fn() { return zwin_conv_mma_kernel<COUT>; }
};

cudaError_t dispatch_mma(const void* feats, const void* start,
                         const void* pattern, const void* weight, void* out,
                         int B, int N, int M, int C, int cout,
                         cudaStream_t stream) {
  if (!gt::sizes_fit(B, N, M, C)) return cudaErrorInvalidValue;
  return gt::launch_tiles<MmaKernel>(
      cout, (long long)B * M, K, C, stream, static_cast<const bf16*>(feats),
      static_cast<const int*>(start), static_cast<const int*>(pattern),
      static_cast<const bf16*>(weight), static_cast<float*>(out), B, N, M, C);
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype 0 = float32, 1 = bf16
// for both feats and weight; route 0 = fma, 1 = mma (bf16 only; feats and
// weight 16-byte aligned). Returns the cudaError_t of the launch.
extern "C" int zwin_conv_launch(const void* feats, const void* start,
                                const void* pattern, const void* weight,
                                void* out, int B, int N, int M, int C,
                                int cout, int dtype, int route, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1 && dtype == 1) {
    err = dispatch_mma(feats, start, pattern, weight, out, B, N, M, C, cout, s);
  } else if (route == 0 && dtype == 0) {
    err = dispatch_fma<float>(feats, start, pattern, weight, out, B, N, M, C,
                              cout, s);
  } else if (route == 0 && dtype == 1) {
    err = dispatch_fma<bf16>(feats, start, pattern, weight, out, B, N, M, C,
                             cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* zwin_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
