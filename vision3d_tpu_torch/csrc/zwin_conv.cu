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
// the sparse taps make it irregular. Design: one site per 32 lanes (two
// sites per warp when Cout = 16), lanes over output channels. Every lane of
// a site takes the same branch, so a tap that no site of the warp needs is
// skipped whole (__any_sync) and nothing diverges. A gathered row is loaded
// once, coalesced, one element per lane, and broadcast by shuffles; the
// weight slice of a tap is read by consecutive lanes at consecutive
// addresses and stays in L1 (at most 27*32*64 values), so device memory
// sees each input row once per tap that uses it. FMA in float32: a first
// kernel that is right; tensor cores (mma/wgmma) are later work.
// Rows need no alignment (C = 4 bf16 rows are 8 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
cudaError_t launch(const void* feats, const void* start, const void* pattern,
                   const void* weight, void* out, int B, int N, int M, int C,
                   cudaStream_t stream) {
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
cudaError_t dispatch(const void* feats, const void* start, const void* pattern,
                     const void* weight, void* out, int B, int N, int M, int C,
                     int cout, cudaStream_t stream) {
  switch (cout) {
    case 16:
      return launch<T, 16>(feats, start, pattern, weight, out, B, N, M, C, stream);
    case 32:
      return launch<T, 32>(feats, start, pattern, weight, out, B, N, M, C, stream);
    case 64:
      return launch<T, 64>(feats, start, pattern, weight, out, B, N, M, C, stream);
    case 128:
      return launch<T, 128>(feats, start, pattern, weight, out, B, N, M, C, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype 0 = float32, 1 = bf16
// for both feats and weight. Returns the cudaError_t of the launch.
extern "C" int zwin_conv_launch(const void* feats, const void* start,
                                const void* pattern, const void* weight,
                                void* out, int B, int N, int M, int C,
                                int cout, int dtype, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(feats, start, pattern, weight, out, B, N, M, C, cout, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(feats, start, pattern, weight, out, B, N, M,
                                  C, cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* zwin_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
