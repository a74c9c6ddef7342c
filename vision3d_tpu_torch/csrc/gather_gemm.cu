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
//   0: a block of 4 warps owns a tile of T = 64 consecutive flattened sites
//   and all Cout columns. The tile's T*K rulebook entries are read once,
//   coalesced, into shared memory as global row numbers (b*N + row, -1 for
//   a miss), and a list of the taps that any site of the tile hits is
//   built; a tap no site hits is skipped whole. For each hit tap (in
//   chunks of at most 64 channels) the T gathered C-wide rows are staged
//   into an A tile by 16-byte cp.async (a miss is the zero-fill form, with
//   src-size 0 from the valid base address: no address is formed from a
//   miss row) and the tap's weight slice into a B tile; rows are padded by
//   16 bytes so ldmatrix is conflict-free. Two stages: the copies of the
//   next hit tap are in flight while the current one is multiplied with
//   ldmatrix (.trans for B) and mma.sync m16n8k16 bf16 -> f32. The sums
//   stay in registers across all taps; the epilogue writes f32 rows below
//   B*M.
// * "fma" (gather_gemm_kernel), float32 (the card-vs-CPU checks need exact
//   f32 products, which TF32 tensor cores would not give), and bf16 with
//   C % 16 != 0 or Cout % 8 != 0: one site per min(32, Cout) lanes, lanes
//   over output channels. A tap no site of the warp hits is skipped
//   (__any_sync).
//   A gathered row is loaded once, one element per lane, and broadcast by
//   shuffles; FMA in float32. Rows need no alignment (C = 4 bf16 rows are
//   8 bytes): no vector load.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

typedef __nv_bfloat16 bf16;

constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int CK_MAX = 64;        // channels of one stage
constexpr int PAD = 8;            // bf16 of padding per staged row (16 bytes)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; with on == false it writes 16 zero bytes
// and reads nothing (src-size 0), so src need only be a valid address.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warps WARPS_M x (4 / WARPS_M); each holds WM sites x Cout / WARPS_N
// columns of the T = WM * WARPS_M site tile.
template <int COUT, int WM, int WARPS_M>
struct MmaShape {
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int T = WM * WARPS_M;
  static constexpr int WN = COUT / WARPS_N;
  static constexpr int MT = WM / 16;  // m16 tiles per warp
  static constexpr int NT = WN / 8;   // n8 tiles per warp
  static constexpr int BS = COUT + PAD;  // weight row stride (bf16)
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
};

// Dynamic shared memory of one block: two A tiles [T][ck + PAD], two B
// tiles [ck][COUT + PAD], the tile's rulebook [T*K] and the tap list [K].
template <int COUT, int WM, int WARPS_M>
size_t mma_smem_bytes(int K, int C) {
  typedef MmaShape<COUT, WM, WARPS_M> S;
  const int ck = C < CK_MAX ? C : CK_MAX;
  return 2 * (size_t)S::T * (ck + PAD) * sizeof(bf16) +
         2 * (size_t)ck * S::BS * sizeof(bf16) +
         ((size_t)S::T * K + 2 * (size_t)K + 1) * sizeof(int);
}

template <int COUT, int WM, int WARPS_M>
__global__ void __launch_bounds__(MMA_THREADS)
gather_gemm_mma_kernel(const bf16* __restrict__ feats,
                       const int* __restrict__ rb,
                       const bf16* __restrict__ weight,
                       float* __restrict__ out, int B, int N, int M, int K,
                       int C) {
  typedef MmaShape<COUT, WM, WARPS_M> S;
  constexpr int T = S::T, MT = S::MT, NT = S::NT, BS = S::BS;
  extern __shared__ int4 smem_raw[];
  const int ck_max = C < CK_MAX ? C : CK_MAX;
  const int as = ck_max + PAD;  // A row stride (bf16): 16 bytes off 32k
  bf16* a_tiles = reinterpret_cast<bf16*>(smem_raw);
  bf16* b_tiles = a_tiles + 2 * T * as;
  int* grow = reinterpret_cast<int*>(b_tiles + 2 * ck_max * BS);
  int* hit = grow + T * K;  // per tap: any site of the tile hits it
  int* taps = hit + K;      // the hit taps, in order
  int* ntaps_s = taps + K;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int total = B * M;  // < INT_MAX, checked by the launcher
  const int tile0 = blockIdx.x * T;

  // 1. the tile's rulebook, coalesced, as global rows b*N + row (-1: miss)
  for (int k = tid; k < K; k += MMA_THREADS) hit[k] = 0;
  __syncthreads();
  const long long e0 = (long long)tile0 * K;
  for (int e = tid; e < T * K; e += MMA_THREADS) {
    const int i = e / K;
    const int site = tile0 + i;
    int g = -1;
    if (site < total) {
      const int row = rb[e0 + e];
      if (row >= 0 && row < N) {
        g = (site / M) * N + row;
        hit[e - i * K] = 1;
      }
    }
    grow[e] = g;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool on = k0 + lane < K && hit[k0 + lane];
      const unsigned votes = __ballot_sync(0xffffffffu, on);
      if (on) taps[n + __popc(votes & ((1u << lane) - 1))] = k0 + lane;
      n += __popc(votes);
    }
    if (lane == 0) *ntaps_s = n;
  }
  __syncthreads();
  const int nchunks = (C + CK_MAX - 1) / CK_MAX;
  const int stages = *ntaps_s * nchunks;

  // 2. stage s = (hit tap s / nchunks, channel chunk s % nchunks)
  auto load_stage = [&](int s) {
    const int t = s / nchunks;
    const int c0 = (s - t * nchunks) * CK_MAX;
    const int k = taps[t];
    const int ck = min(CK_MAX, C - c0);
    bf16* a = a_tiles + (s & 1) * T * as;
    bf16* w = b_tiles + (s & 1) * ck_max * BS;
    const int pieces = ck / 8;  // 16-byte pieces of a row
    for (int p = tid; p < T * pieces; p += MMA_THREADS) {
      const int i = p / pieces, q = p - i * pieces;
      const int g = grow[i * K + k];
      const bf16* src = g >= 0 ? feats + (long long)g * C + c0 + q * 8 : feats;
      cp_async16(smem_addr(a + i * as + q * 8), src, g >= 0);
    }
    constexpr int WP = COUT / 8;
    const bf16* wsrc = weight + ((long long)k * C + c0) * COUT;
    for (int p = tid; p < ck * WP; p += MMA_THREADS) {
      const int r = p / WP, q = p - r * WP;
      cp_async16(smem_addr(w + r * BS + q * 8), wsrc + r * COUT + q * 8, true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  const int wm0 = (warp % WARPS_M) * WM;
  const int wn0 = (warp / WARPS_M) * S::WN;
  if (stages > 0) load_stage(0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    // the buffer written here was last read before the barrier that ended
    // the previous iteration
    if (s + 1 < stages) load_stage(s + 1);
    cp_async_commit();
    cp_async_wait_one();  // all but the newest group: stage s has landed
    __syncthreads();
    const int c0 = (s % nchunks) * CK_MAX;
    const int ck = min(CK_MAX, C - c0);
    const bf16* a = a_tiles + (s & 1) * T * as;
    const bf16* w = b_tiles + (s & 1) * ck_max * BS;
    for (int kk = 0; kk < ck; kk += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(smem_addr(a + (wm0 + mt * 16 + (lane & 15)) * as + kk +
                          (lane >> 4) * 8),
                af[mt]);
      unsigned bfr[NT][2];
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(
            smem_addr(w + krow * BS + wn0 + np * 16 + (lane >> 4) * 8), r);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
      if (NT % 2)
        ldsm_x2_trans(smem_addr(w + krow * BS + wn0 + (NT - 1) * 8),
                      bfr[NT - 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }

  // 3. epilogue: C/D fragment rows lane/4 and lane/4 + 8, columns
  // 2*(lane%4) + {0, 1}; out is (B*M, COUT) row-major
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = tile0 + wm0 + mt * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = wn0 + nt * 8 + (lane & 3) * 2;
      if (r0 < total)
        *reinterpret_cast<float2*>(out + (long long)r0 * COUT + n) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < total)
        *reinterpret_cast<float2*>(out + (long long)(r0 + 8) * COUT + n) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int COUT, int WM, int WARPS_M>
cudaError_t launch_mma(const void* feats, const void* rb, const void* weight,
                       void* out, int B, int N, int M, int K, int C,
                       cudaStream_t stream) {
  typedef MmaShape<COUT, WM, WARPS_M> S;
  const size_t smem = mma_smem_bytes<COUT, WM, WARPS_M>(K, C);
  auto kernel = gather_gemm_mma_kernel<COUT, WM, WARPS_M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(((long long)B * M + S::T - 1) / S::T);
  kernel<<<blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const int*>(rb),
      static_cast<const bf16*>(weight), static_cast<float*>(out), B, N, M, K,
      C);
  return cudaGetLastError();
}

// Tile of 64 sites: 4 x 1 warps of 16 sites x Cout up to Cout 64; 2 x 2
// warps of 32 sites x 64 columns at Cout 128 (64 f32 sums a thread). On
// the training step's 27 shapes on the H100 tiles of 64 took 13.0 ms in
// all, tiles of 128 (twice the rows per warp) 13.9 ms
// (tools/microbench_torch_gather_gemm.py): more blocks in flight hide the
// gather's latency better than fewer weight copies per site save.
cudaError_t dispatch_mma(const void* feats, const void* rb, const void* weight,
                         void* out, int B, int N, int M, int K, int C,
                         int cout, cudaStream_t stream) {
  if (C % 16 || (long long)B * N >= INT_MAX || (long long)B * M >= INT_MAX - 64)
    return cudaErrorInvalidValue;
  switch (cout) {
    case 8:
      return launch_mma<8, 16, 4>(feats, rb, weight, out, B, N, M, K, C,
                                  stream);
    case 16:
      return launch_mma<16, 16, 4>(feats, rb, weight, out, B, N, M, K, C,
                                   stream);
    case 32:
      return launch_mma<32, 16, 4>(feats, rb, weight, out, B, N, M, K, C,
                                   stream);
    case 64:
      return launch_mma<64, 16, 4>(feats, rb, weight, out, B, N, M, K, C,
                                   stream);
    case 128:
      return launch_mma<128, 32, 2>(feats, rb, weight, out, B, N, M, K, C,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
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
