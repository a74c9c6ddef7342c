// Z-window tap alignment + GEMM on already gathered windows, for NVIDIA
// Hopper (sm_90a). One source, two entry points:
//
//   zwin_align_v1 replaces vision3d_tpu/ops/pallas/zwin_conv.py:55
//     (zwin_conv_gemm, v1): masks (B, K2, M, P) with P = kz(kz+1)/2 = 6
//     entries in (dz, j) order, j <= dz;
//   zwin_align_v3 replaces vision3d_tpu/ops/pallas/zwin_conv.py:238
//     (zwin_conv_gemm_v3): shift masks (kz, B, M, K2*kz), entry
//     [s, b, m, k2*kz + j] routes candidate j to tap dz = j + s.
//
// Unlike the z-window kernel of zwin_conv.cu, which reads the sparse tensor
// and the rulebook, both take the gather's output: g_km (B, K2, M, kz*C),
// candidate j of the window of (site m, BEV offset k2) at
// [b, k2, m, j*C : (j+1)*C], zeros at misses, in the gather's own k2-major
// order. They compute
//
//   out[b, m, :] = sum over k2, dz and the candidates j whose mask for
//                  (dz, j) is set of
//                  g_km[b, k2, m, j*C : (j+1)*C] @ W[(dz*K2 + k2)*C : +C, :]
//
// with kz = 3, K2 = 9. The masks come from the rulebook's patterns, so per
// (site, k2, dz) at most one candidate is set. Each kernel reads its mask
// layout as it is. The TPU kernels' (BLK, K2*kz*C) im2col block, v3's
// padding of every offset block to 128 lanes and its mask-expanding matmul
// are layout devices of that machine and are not carried over. Inputs and
// masks are float32 or bf16 (a mask is set where it is not zero); sums are
// float32.
//
// What bounds it on the H100: the function reads B*K2*M*kz*C gathered
// values and the masks once and does 2*C*Cout flops per set mask, at most
// 128 flops per byte at C, Cout <= 64: bytes. Design, as zwin_conv.cu: one
// site per min(32, Cout) lanes, lanes over output channels; a (dz, j) pair
// no site of the warp has set is skipped whole (__any_sync); a candidate
// row is loaded once, coalesced, one element per lane, and broadcast by
// shuffles; a tap's weight slice is read by consecutive lanes and stays in
// L1/L2. FMA in float32: a first kernel that is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KZ = 3;
constexpr int K2 = 9;
constexpr int P1 = KZ * (KZ + 1) / 2;  // v1 mask entries per (site, k2)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V3 false: v1 pair masks; true: v3 shift masks.
template <typename T, int COUT, bool V3>
__global__ void __launch_bounds__(256)
zwin_align_kernel(const T* __restrict__ g_km, const T* __restrict__ masks,
                  const T* __restrict__ weight, float* __restrict__ out,
                  int B, int M, int C) {
  constexpr int LPS = COUT >= 32 ? 32 : COUT;  // lanes per site
  constexpr int OPT = COUT / LPS;              // outputs per lane
  constexpr int SPW = 32 / LPS;                // sites per warp
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LPS;
  const size_t total = (size_t)B * M;
  const size_t warp0 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const size_t nwarps = ((size_t)gridDim.x * blockDim.x) >> 5;

  // the loop bound is the same for all lanes of a warp, so every shuffle
  // and vote below sees the whole warp
  for (size_t base = warp0 * SPW; base < total; base += nwarps * SPW) {
    const size_t site = base + lane / LPS;
    const bool live = site < total;
    const size_t b = live ? site / M : 0;
    const size_t m = live ? site % M : 0;
    float acc[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) acc[o] = 0.f;

    for (int k2 = 0; k2 < K2; ++k2) {
      const size_t win = (b * K2 + k2) * M + m;  // window of (b, k2, m)
      const T* grow = g_km + win * (size_t)(KZ * C);
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
        for (int j = 0; j <= dz; ++j) {
          bool on = false;
          if (live) {
            const size_t at =
                V3 ? (((size_t)(dz - j) * B + b) * M + m) * (K2 * KZ) +
                         k2 * KZ + j
                   : win * P1 + dz * (dz + 1) / 2 + j;
            on = to_f(masks[at]) != 0.f;
          }
          if (!__any_sync(full, on)) continue;
          const T* xrow = grow + j * C;
          const T* wtap = weight + (size_t)(dz * K2 + k2) * C * COUT + sub;
          for (int c0 = 0; c0 < C; c0 += LPS) {
            float v = 0.f;
            if (on && c0 + sub < C) v = to_f(xrow[c0 + sub]);
            const int cn = min(LPS, C - c0);
            for (int cc = 0; cc < cn; ++cc) {
              const float f = __shfl_sync(full, v, cc, LPS);
              const T* wr = wtap + (size_t)(c0 + cc) * COUT;
#pragma unroll
              for (int o = 0; o < OPT; ++o) {
                acc[o] = fmaf(f, to_f(wr[o * LPS]), acc[o]);
              }
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int o = 0; o < OPT; ++o) out[site * COUT + o * LPS + sub] = acc[o];
    }
  }
}

template <typename T, int COUT, bool V3>
cudaError_t launch(const void* g_km, const void* masks, const void* weight,
                   void* out, int B, int M, int C, cudaStream_t stream) {
  constexpr int LPS = COUT >= 32 ? 32 : COUT;
  constexpr int SPW = 32 / LPS;
  const int threads = 256;
  const size_t sites_per_block = (size_t)(threads / 32) * SPW;
  size_t blocks = ((size_t)B * M + sites_per_block - 1) / sites_per_block;
  const size_t max_blocks = 132 * 16;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  zwin_align_kernel<T, COUT, V3><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g_km), static_cast<const T*>(masks),
      static_cast<const T*>(weight), static_cast<float*>(out), B, M, C);
  return cudaGetLastError();
}

template <typename T, bool V3>
cudaError_t dispatch(const void* g_km, const void* masks, const void* weight,
                     void* out, int B, int M, int C, int cout,
                     cudaStream_t stream) {
  switch (cout) {
    case 16:
      return launch<T, 16, V3>(g_km, masks, weight, out, B, M, C, stream);
    case 32:
      return launch<T, 32, V3>(g_km, masks, weight, out, B, M, C, stream);
    case 64:
      return launch<T, 64, V3>(g_km, masks, weight, out, B, M, C, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool V3>
int entry(const void* g_km, const void* masks, const void* weight, void* out,
          int B, int M, int C, int cout, int dtype, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float, V3>(g_km, masks, weight, out, B, M, C, cout, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16, V3>(g_km, masks, weight, out, B, M, C, cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype 0 = float32, 1 = bf16
// for g_km, masks and weight. Each returns the cudaError_t of the launch.
extern "C" int zwin_align_v1_launch(const void* g_km, const void* masks,
                                    const void* weight, void* out, int B,
                                    int M, int C, int cout, int dtype,
                                    void* stream) {
  return entry<false>(g_km, masks, weight, out, B, M, C, cout, dtype, stream);
}

extern "C" int zwin_align_v3_launch(const void* g_km, const void* msk,
                                    const void* weight, void* out, int B,
                                    int M, int C, int cout, int dtype,
                                    void* stream) {
  return entry<true>(g_km, msk, weight, out, B, M, C, cout, dtype, stream);
}

extern "C" const char* zwin_align_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
