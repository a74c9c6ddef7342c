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
// with kz = 3, K2 = 9. Masks built from the rulebook's patterns route at
// most one candidate to each (site, k2, dz); any other 0/1 masks are summed
// all the same. Each kernel reads its mask layout as it is. The TPU
// kernels' (BLK, K2*kz*C) im2col block, v3's padding of every offset block
// to 128 lanes and its mask-expanding matmul are layout devices of that
// machine and are not carried over. Inputs and masks are float32 or bf16 (a
// mask is set where it is not zero); sums are float32.
//
// What bounds it on the H100: the least it must read is the masks once and
// the C-wide rows that set masks select; it does 2*C*Cout flops per such
// row, at most 128 flops per byte at C, Cout <= 64: bytes.
//
// Two routes, chosen by the wrapper from (dtype, C, Cout) alone, with the
// rule of gather_gemm.cu:
//
// * "mma" (zwin_align_mma_kernel), bf16 with C % 16 == 0: g_km is one flat
//   (B*K2*M*kz, C) table, candidate j of window (b, k2, m) its row
//   ((b*K2 + k2)*M + m)*kz + j, and the tap order k = dz*K2 + k2 is the
//   weight's own. So the tile of gather_tile_mma.cuh (64 consecutive
//   flattened sites b*M + m, which may span frames; cp.async staging with
//   zero-fill misses that read nothing; only the taps some site of the tile
//   hits; the two-stage ring; ldmatrix + mma.sync m16n8k16 bf16 -> f32)
//   computes it once each tile's rulebook is built in shared memory from
//   the masks: one thread per (site, k2) reads the site's candidates for
//   its three taps (6 mask entries; v1: consecutive threads on consecutive
//   sites of one k2; v3: entries of the 3 shift planes, consecutive threads
//   along a site's 27) and writes grow[i*K + dz*K2 + k2] = the row
//   of the first set candidate, or -1. Exact for any masks: a
//   __syncthreads_or after the build says whether some (site, k2, dz) of
//   the tile has a second set candidate; only then does the tile run again
//   on the second candidates, adding to its output rows (tile_mma's
//   ACCUM), and a third time for a third. A tile of masks built from real
//   patterns runs once, exactly the 27-tap stages of zwin_conv.cu, with no
//   shared memory beyond that kernel's.
// * "fma" (zwin_align_kernel), float32 (the card-vs-CPU checks need exact
//   f32 products), and bf16 at C = 4: one site per min(32, Cout) lanes,
//   lanes over output channels; a (dz, j) pair no site of the warp has set
//   is skipped whole (__any_sync); a candidate row is loaded once,
//   coalesced, one element per lane, and broadcast by shuffles; a tap's
//   weight slice is read by consecutive lanes and stays in L1/L2. FMA in
//   float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_tile_mma.cuh"

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

// ---------------------------------------------------------------- mma route

namespace gt = gather_tile;
typedef gt::bf16 bf16;

constexpr int K = KZ * K2;

// Whether the mask routes candidate j of window (b, k2, m) = site to tap dz.
template <bool V3>
__device__ __forceinline__ bool routed(const bf16* __restrict__ masks, int B,
                                       int M, int site, int win, int k2,
                                       int dz, int j) {
  const long long at =
      V3 ? ((long long)(dz - j) * B * M + site) * (K2 * KZ) + k2 * KZ + j
         : (long long)win * P1 + dz * (dz + 1) / 2 + j;
  return __bfloat162float(masks[at]) != 0.f;
}

template <int COUT, bool V3>
__global__ void __launch_bounds__(gt::THREADS)
zwin_align_mma_kernel(const bf16* __restrict__ g_km,
                      const bf16* __restrict__ masks,
                      const bf16* __restrict__ weight,
                      float* __restrict__ out, int B, int M, int C) {
  constexpr int T = gt::Shape<COUT>::T;
  extern __shared__ int4 smem_raw[];
  const gt::TileSmem sm = gt::carve_smem<COUT>(smem_raw, K, C);
  const int tid = threadIdx.x;
  const int total = B * M;  // B*K2*M*KZ < INT_MAX, checked by the launcher
  const int tile0 = blockIdx.x * T;

  // pass p runs the p-th set candidate of every (site, k2, dz)
  for (int p = 0; p < KZ; ++p) {
    for (int k = tid; k < K; k += gt::THREADS) sm.hit[k] = 0;
    __syncthreads();
    bool more = false;  // a (site, k2, dz) of mine has a candidate past p
    for (int e = tid; e < T * K2; e += gt::THREADS) {
      // v1 reads a k2's 64 sites' pairs as one run; v3 a site's 27 entries
      const int i = V3 ? e / K2 : e % T;
      const int k2 = V3 ? e - i * K2 : e / T;
      const int site = tile0 + i;
      const bool live = site < total;
      const int b = live ? site / M : 0;
      const int win = (b * K2 + k2) * M + (live ? site - b * M : 0);
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) {
        int row = -1, seen = 0;
        if (live) {
#pragma unroll
          for (int j = 0; j <= dz; ++j) {
            if (!routed<V3>(masks, B, M, site, win, k2, dz, j)) continue;
            if (seen == p) row = win * KZ + j;
            ++seen;
          }
        }
        more |= seen > p + 1;
        sm.grow[i * K + dz * K2 + k2] = row;
        if (row >= 0) sm.hit[dz * K2 + k2] = 1;
      }
    }
    // the barrier after the build, and whether the tile needs pass p + 1
    // (read by every thread before tile_mma's first barrier, so the next
    // build cannot overwrite what this pass still reads)
    const bool again = __syncthreads_or(more);
    if (p == 0)
      gt::tile_mma<COUT>(g_km, weight, out, total, tile0, K, C, sm);
    else
      gt::tile_mma<COUT, false, true>(g_km, weight, out, total, tile0, K, C,
                                      sm);
    if (!again) break;
  }
}

template <bool V3>
struct MmaKernel {
  template <int COUT>
  struct Of {
    static auto fn() { return zwin_align_mma_kernel<COUT, V3>; }
  };
};

template <bool V3>
cudaError_t dispatch_mma(const void* g_km, const void* masks,
                         const void* weight, void* out, int B, int M, int C,
                         int cout, cudaStream_t stream) {
  if (C % 16 || (long long)B * K2 * M * KZ >= INT_MAX ||
      (long long)B * M >= INT_MAX - 64)
    return cudaErrorInvalidValue;
  if (cout != 16 && cout != 32 && cout != 64) return cudaErrorInvalidValue;
  return gt::launch_tiles<MmaKernel<V3>::template Of>(
      cout, (long long)B * M, K, C, stream, static_cast<const bf16*>(g_km),
      static_cast<const bf16*>(masks), static_cast<const bf16*>(weight),
      static_cast<float*>(out), B, M, C);
}

template <bool V3>
int entry(const void* g_km, const void* masks, const void* weight, void* out,
          int B, int M, int C, int cout, int dtype, int route, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1 && dtype == 1) {
    err = dispatch_mma<V3>(g_km, masks, weight, out, B, M, C, cout, s);
  } else if (route == 0 && dtype == 0) {
    err = dispatch<float, V3>(g_km, masks, weight, out, B, M, C, cout, s);
  } else if (route == 0 && dtype == 1) {
    err = dispatch<__nv_bfloat16, V3>(g_km, masks, weight, out, B, M, C, cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype 0 = float32, 1 = bf16
// for g_km, masks and weight; route 0 = fma, 1 = mma (bf16 only; g_km and
// weight 16-byte aligned). Each returns the cudaError_t of the launch.
extern "C" int zwin_align_v1_launch(const void* g_km, const void* masks,
                                    const void* weight, void* out, int B,
                                    int M, int C, int cout, int dtype,
                                    int route, void* stream) {
  return entry<false>(g_km, masks, weight, out, B, M, C, cout, dtype, route,
                      stream);
}

extern "C" int zwin_align_v3_launch(const void* g_km, const void* msk,
                                    const void* weight, void* out, int B,
                                    int M, int C, int cout, int dtype,
                                    int route, void* stream) {
  return entry<true>(g_km, msk, weight, out, B, M, C, cout, dtype, route,
                     stream);
}

extern "C" const char* zwin_align_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
