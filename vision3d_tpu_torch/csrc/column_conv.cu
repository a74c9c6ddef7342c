// Column-sparse convolution (sparse in BEV, dense in z) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel vision3d_tpu/ops/pallas/column_conv.py:86
// (column_conv_pallas), whose contract is that of
// vision3d_tpu/ops/column_sparse.py:105 (column_conv_dz). The TPU version
// pads every row to 1024 lanes, appends a zero row, pads z on the host and
// reorders the rulebook into per-block SMEM tiles before per-row DMAs; none
// of that is carried over. Here the kernel reads the column tensor, the
// rulebook and the weight as the model holds them:
//
//   out[b, m, zo*Cout + co] =
//     sum over BEV offsets k2 with row = rb[b, m*K2 + k2] in [0, N) and taps
//     dz with z = zo*stride_z - pad_z + dz in [0, D) of
//       col_feats[b, row, z*C : (z+1)*C] @ W[(dz*K2 + k2)*C : +C, co]
//
// A rulebook entry outside [0, N) is a miss and adds nothing (so a padded
// column, whose entries are all N, gets exact zeros); pad_z is the bounds
// check on z; the (dz, dy, dx)-major weight is indexed in place. Inputs are
// float32 or bf16; sums and the output are float32.
//
// What bounds it on the H100: per output column the function reads K2 rows
// of D*C values (328 to 2816 bytes each, neighbours share them through L2)
// and writes D_out*Cout floats; the dense-z output alone is 2 to 4 times the
// input bytes, and a column holds only a few active voxels, so bytes bound
// it.
//
// Two routes, chosen by the wrapper from (dtype, C, Cout) alone, with the
// rule of gather_gemm.cu and zwin_conv.cu:
//
// * "mma" (column_conv_mma_kernel), bf16 with C % 16 == 0: the GEMM rows
//   are the (column, zo) sites, the taps k = dz*K2 + k2 (the weight's own
//   row order), and tap k of a site reads the z-slice z = zo*stride_z -
//   pad_z + dz of its k2-th neighbour row: row (b*N + row)*D + z of
//   col_feats read as one flat (B*N*D, C) table. So the tile of
//   gather_tile_mma.cuh computes it once each tile's rulebook is built.
//   Most (column, zo) sites have no input at all (a column holds a few
//   voxels of its D), so tiles are built from the active sites only:
//   1. column_zmask_kernel reads every input row once and writes a 64-bit
//      mask of the z whose C-wide slice holds a non-zero value (one warp a
//      row, 16-byte loads, the bits OR-reduced over the warp);
//   2. column_conv_mma_kernel: a block owns a run of `cols` consecutive
//      output columns (b*M + m). From the rulebook and the row masks it
//      forms each column's active zo (some tap reaches a non-zero slice),
//      compacts the block's active (column, zo) sites into a list in
//      shared memory (a block scan of the per-column counts) and writes
//      exact zeros to the output rows of its inactive sites, coalesced, so
//      every output row is written once and no zero pass or host sync is
//      needed. Then per tile of 64 listed sites it builds grow[i*K + k]
//      ((b*N + row)*D + z, or -1 when the row is a miss, z is outside [0,
//      D) or the slice is all zero: a zero-filled miss that reads nothing),
//      hit[k] and the map of output rows (b*M + m)*D_out + zo, and runs
//      tile_mma: cp.async staging, only the taps some site of the tile
//      hits, the two-stage ring, ldmatrix + mma.sync m16n8k16 bf16 -> f32.
//   The row masks are scratch of B*N x 8 bytes that the wrapper allocates.
// * "fma" (column_conv_kernel), float32 (the card-vs-CPU checks need exact
//   f32 products) and bf16 at C = 4: one output column per warp at a
//   time. Lane k2 reads the column's rulebook entry; the warp copies the
//   K2 neighbour rows into its own slice of shared memory with cp.async,
//   all rows in flight at once, in the widest pieces the row size and base
//   pointers allow (a 4-channel bf16 row is 328 bytes: 8-byte pieces), and
//   then notes per row which z hold any non-zero value (a 64-bit mask,
//   OR-reduced over the lanes). Each group of min(32, Cout) lanes takes
//   one output z, lanes over output channels. From the masks it forms the
//   bit set of its taps (k2, dz) whose input z-slice is non-zero; the warp
//   walks the union of its groups' sets in (k2, dz) order, the order of
//   the plain version's GEMM columns, so a tap whose input is all zero
//   costs nothing (it would add exact zeros) and the work follows the
//   active voxels, not D. The input value is a shared-memory broadcast;
//   the weight row is read by consecutive lanes and stays in L1/L2; the
//   output row is written coalesced along (zo, co). FMA in float32.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_tile_mma.cuh"

namespace {

constexpr int MAX_K2 = 9;
constexpr int MAX_D = 60;    // one bit per padded z in the 64-bit non-zero masks
constexpr int MAX_TAPS = 32;  // kz * K2 bits in a tap set

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int BYTES> struct Vec;
template <> struct Vec<16> { typedef uint4 type; };
template <> struct Vec<8> { typedef uint2 type; };
template <> struct Vec<4> { typedef uint32_t type; };
template <> struct Vec<2> { typedef uint16_t type; };

// T: element type; COUT: output channels; VB: bytes per staging load.
template <typename T, int COUT, int VB>
__global__ void __launch_bounds__(256)
column_conv_kernel(const T* __restrict__ col_feats, const int* __restrict__ rb,
                   const T* __restrict__ weight, float* __restrict__ out,
                   int B, int N, int M, int K2, int D, int C, int log2c,
                   int kz, int stride_z, int pad_z, int D_out, int row_pitch) {
  constexpr int LPS = COUT >= 32 ? 32 : COUT;  // lanes per output z
  constexpr int OPT = COUT / LPS;              // outputs per lane
  constexpr int ZPW = 32 / LPS;                // output z per warp pass
  constexpr int EPV = VB / (int)sizeof(T);     // elements per staging load
  typedef typename Vec<VB>::type vec_t;
  const unsigned full = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPS;
  const int DC = D * C;
  // this warp's K2 row slots; row_pitch (bytes) is a multiple of 16
  unsigned char* rows = smem + (size_t)warp * K2 * row_pitch;
  const size_t total = (size_t)B * M;
  const size_t warp0 = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  const size_t nwarps = (size_t)gridDim.x * (blockDim.x >> 5);

  // the loop bound is the same for all lanes of a warp, so every shuffle,
  // vote and __syncwarp below sees the whole warp
  for (size_t site = warp0; site < total; site += nwarps) {
    const size_t b = site / M;
    const T* fb = col_feats + b * (size_t)N * DC;
    int myrow = -1;
    if (lane < K2) {
      myrow = rb[site * (size_t)K2 + lane];
      if (myrow >= N) myrow = -1;
    }

    // stage the neighbour rows: every piece of every row in flight at once
#pragma unroll
    for (int k2 = 0; k2 < MAX_K2; ++k2) {
      if (k2 >= K2) continue;
      const int row = __shfl_sync(full, myrow, k2);
      if (row < 0) continue;
      const vec_t* src = reinterpret_cast<const vec_t*>(fb + (size_t)row * DC);
      vec_t* dst = reinterpret_cast<vec_t*>(rows + (size_t)k2 * row_pitch);
      for (int v = lane; v * EPV < DC; v += 32) {
        if constexpr (VB >= 4) {
          __pipeline_memcpy_async(dst + v, src + v, VB);
        } else {
          dst[v] = src[v];
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();

    // per row the z that hold a non-zero value, as bit z
    unsigned long long zb[MAX_K2];
#pragma unroll
    for (int k2 = 0; k2 < MAX_K2; ++k2) {
      unsigned long long bits = 0ull;
      if (k2 < K2 && __shfl_sync(full, myrow, k2) >= 0) {
        const vec_t* srow =
            reinterpret_cast<const vec_t*>(rows + (size_t)k2 * row_pitch);
        for (int v = lane; v * EPV < DC; v += 32) {
          const vec_t x = srow[v];
          const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
          for (int i = 0; i < EPV; ++i) {
            if (to_f(e[i]) != 0.f) bits |= 1ull << ((v * EPV + i) >> log2c);
          }
        }
      }
      zb[k2] = bits;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
      for (int k2 = 0; k2 < MAX_K2; ++k2) {
        zb[k2] |= __shfl_xor_sync(full, zb[k2], s);
      }
    }

    float* orow = out + site * (size_t)D_out * COUT;
    const unsigned window = (1u << kz) - 1u;
    for (int zo0 = 0; zo0 < D_out; zo0 += ZPW) {
      const int zo = zo0 + lane / LPS;
      const bool live = zo < D_out;
      // this group's taps with a non-zero input: bit k2*kz + dz. Padded z
      // zo*stride_z + dz is input z zo*stride_z - pad_z + dz; the masks hold
      // no bit below pad_z or from D + pad_z on, which is the bounds check.
      unsigned mine = 0u;
      if (live) {
#pragma unroll
        for (int k2 = 0; k2 < MAX_K2; ++k2) {
          if (k2 < K2) {
            mine |= ((unsigned)((zb[k2] << pad_z) >> (zo * stride_z)) & window)
                    << (k2 * kz);
          }
        }
      }
      unsigned todo = __reduce_or_sync(full, mine);
      float acc[OPT];
#pragma unroll
      for (int o = 0; o < OPT; ++o) acc[o] = 0.f;
      while (todo) {
        const int t = __ffs(todo) - 1;
        todo &= todo - 1;
        const int k2 = t / kz;
        const int dz = t - k2 * kz;
        const bool on = (mine >> t) & 1u;
        const int z = on ? zo * stride_z - pad_z + dz : 0;
        const T* xz = reinterpret_cast<const T*>(rows + (size_t)k2 * row_pitch) +
                      z * C;
        const T* wt = weight + (size_t)(dz * K2 + k2) * C * COUT + sub;
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float f = on ? to_f(xz[c]) : 0.f;
#pragma unroll
          for (int o = 0; o < OPT; ++o) {
            acc[o] = fmaf(f, to_f(wt[(size_t)c * COUT + o * LPS]), acc[o]);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int o = 0; o < OPT; ++o) orow[zo * COUT + o * LPS + sub] = acc[o];
      }
    }
    __syncwarp();  // the next column's staging overwrites the row slots
  }
}

struct Params {
  const void* col_feats;
  const void* rb;
  const void* weight;
  void* out;
  int B, N, M, K2, D, C, log2c, kz, stride_z, pad_z, D_out;
  cudaStream_t stream;
};

template <typename T, int COUT, int VB>
cudaError_t launch(const Params& p) {
  const int row_bytes = p.D * p.C * (int)sizeof(T);
  const int row_pitch = (row_bytes + 15) / 16 * 16;
  const int per_warp = p.K2 * row_pitch;
  // two blocks of up to 8 warps per SM within its 227 KB of shared memory;
  // the split between shared memory and L1 is left to the CUDA runtime
  // (asking for the largest carveout shrinks L1, where the weights live,
  // and measured slower)
  int warps = (110 * 1024) / per_warp;
  if (warps > 8) warps = 8;
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * per_warp;
  auto kern = column_conv_kernel<T, COUT, VB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)p.B * p.M;
  size_t blocks = (total + warps - 1) / warps;
  const size_t max_blocks = 132 * 16;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  kern<<<(unsigned)blocks, warps * 32, smem, p.stream>>>(
      static_cast<const T*>(p.col_feats), static_cast<const int*>(p.rb),
      static_cast<const T*>(p.weight), static_cast<float*>(p.out), p.B, p.N,
      p.M, p.K2, p.D, p.C, p.log2c, p.kz, p.stride_z, p.pad_z, p.D_out,
      row_pitch);
  return cudaGetLastError();
}

template <typename T, int COUT>
cudaError_t dispatch_vec(const Params& p) {
  // the widest load that divides the row and keeps every row aligned
  const size_t row_bytes = (size_t)p.D * p.C * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.col_feats);
  if (row_bytes % 16 == 0 && base % 16 == 0) return launch<T, COUT, 16>(p);
  if (row_bytes % 8 == 0 && base % 8 == 0) return launch<T, COUT, 8>(p);
  return launch<T, COUT, (int)sizeof(T)>(p);
}

template <typename T>
cudaError_t dispatch(const Params& p, int cout) {
  switch (cout) {
    case 16:
      return dispatch_vec<T, 16>(p);
    case 32:
      return dispatch_vec<T, 32>(p);
    case 64:
      return dispatch_vec<T, 64>(p);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- mma route

namespace gt = gather_tile;
typedef gt::bf16 bf16;
typedef unsigned long long u64;

constexpr int MAX_COLS = 128;  // output columns of one block: one thread each

// 1. Per input row b*N + n: bit z set iff col_feats[b, n, z*C : +C] holds a
// non-zero value (+-0 are zero). One warp a row; ppz_log2 = log2(C / 8),
// the 16-byte pieces of one z-slice.
__global__ void __launch_bounds__(256)
column_zmask_kernel(const bf16* __restrict__ feats, u64* __restrict__ zmask,
                    long long rows, int pieces, int ppz_log2) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = warp0; r < rows; r += nwarps) {
    const uint4* src = reinterpret_cast<const uint4*>(feats) + r * pieces;
    unsigned lo = 0u, hi = 0u;
    for (int p = lane; p < pieces; p += 32) {
      const uint4 v = src[p];
      if ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) {
        const int z = p >> ppz_log2;
        if (z < 32) lo |= 1u << z;
        else hi |= 1u << (z - 32);
      }
    }
    lo = __reduce_or_sync(full, lo);
    hi = __reduce_or_sync(full, hi);
    if (lane == 0) zmask[r] = ((u64)hi << 32) | lo;
  }
}

// Shared memory of one block after the tile's (gt::smem_bytes rounded up to
// 16): rmask [cols*K2] u64, act [cols] u64, rbase [cols*K2] int, orow
// [THREADS] int (T <= THREADS of them used), list [cols*D_out] u16.
size_t column_smem_bytes(int cols, int K2, int D_out) {
  return (size_t)cols * K2 * 12 + (size_t)cols * 8 + (size_t)gt::THREADS * 4 +
         (size_t)cols * D_out * 2;
}

// 2. One block per run of `cols` output columns (see the file's note).
template <int COUT>
__global__ void __launch_bounds__(gt::THREADS)
column_conv_mma_kernel(const bf16* __restrict__ feats,
                       const int* __restrict__ rb,
                       const u64* __restrict__ zmask,
                       const bf16* __restrict__ weight, float* __restrict__ out,
                       int B, int N, int M, int K2, int D, int C, int kz,
                       int stride_z, int pad_z, int D_out, int cols,
                       int col_off) {
  constexpr int T = gt::Shape<COUT>::T;
  const int K = kz * K2;
  extern __shared__ int4 smem_raw[];
  const gt::TileSmem sm = gt::carve_smem<COUT>(smem_raw, K, C);
  unsigned char* col_raw = reinterpret_cast<unsigned char*>(smem_raw) + col_off;
  u64* rmask = reinterpret_cast<u64*>(col_raw);
  u64* act = rmask + cols * K2;
  int* rbase = reinterpret_cast<int*>(act + cols);
  int* orow = rbase + cols * K2;
  unsigned short* list = reinterpret_cast<unsigned short*>(orow + gt::THREADS);
  __shared__ int warp_sum[gt::THREADS / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int total_cols = B * M;  // < INT_MAX, checked by the launcher
  const int col0 = blockIdx.x * cols;
  const int ncols = min(cols, total_cols - col0);

  // the rulebook rows of the block's columns and their non-zero z
  const long long e0 = (long long)col0 * K2;
  for (int e = tid; e < ncols * K2; e += gt::THREADS) {
    const int b = (col0 + e / K2) / M;
    const int row = rb[e0 + e];
    const bool on = row >= 0 && row < N;
    rbase[e] = on ? (b * N + row) * D : -1;  // B*N*D < INT_MAX
    rmask[e] = on ? zmask[(long long)b * N + row] : 0ull;
  }
  __syncthreads();

  // per column its active zo: padded z zo*stride_z + dz holds input z
  // zo*stride_z - pad_z + dz; the masks hold no bit at or above D, and the
  // shift by pad_z leaves none below it, which is the bounds check
  const u64 window = (1ull << kz) - 1ull;
  int count = 0;
  if (tid < ncols) {
    u64 any = 0ull;
    for (int k2 = 0; k2 < K2; ++k2) any |= rmask[tid * K2 + k2];
    any <<= pad_z;
    u64 a = 0ull;
    if (any)
      for (int zo = 0; zo < D_out; ++zo)
        if ((any >> (zo * stride_z)) & window) a |= 1ull << zo;
    act[tid] = a;
    count = __popcll(a);
  }
  // exclusive scan of the counts over the block's columns
  int incl = count;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int sites = 0, j = incl - count;  // the block's active sites, and mine
  for (int w = 0; w < gt::THREADS / 32; ++w) {
    if (w < warp) j += warp_sum[w];
    sites += warp_sum[w];
  }
  if (tid < ncols)
    for (u64 a = act[tid]; a; a &= a - 1ull)
      list[j++] = (unsigned short)((tid << 6) | (__ffsll((long long)a) - 1));

  // exact zeros on the output rows of the inactive sites, coalesced: Q
  // threads a row of COUT floats, one float4 each
  {
    constexpr int Q = COUT / 4;
    float4* o4 = reinterpret_cast<float4*>(out) + (long long)col0 * D_out * Q;
    const int q = tid % Q;
    for (int r = tid / Q; r < ncols * D_out; r += gt::THREADS / Q) {
      const int c = r / D_out;
      if (!((act[c] >> (r - c * D_out)) & 1ull))
        o4[r * Q + q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  for (int t0 = 0; t0 < sites; t0 += T) {
    for (int k = tid; k < K; k += gt::THREADS) sm.hit[k] = 0;
    __syncthreads();
    // the tile's rulebook: grow[i*K + k], k = dz*K2 + k2
    for (int e = tid; e < T * K; e += gt::THREADS) {
      const int i = e / K, k = e - i * K;
      int g = -1;
      if (t0 + i < sites) {
        const int v = list[t0 + i];
        const int c = v >> 6, zo = v & 63;
        const int dz = k / K2, k2 = k - dz * K2;
        const int z = zo * stride_z - pad_z + dz;
        const int ck = c * K2 + k2;
        if (z >= 0 && z < D && ((rmask[ck] >> z) & 1ull)) {
          g = rbase[ck] + z;
          sm.hit[k] = 1;
        }
      }
      sm.grow[e] = g;
    }
    if (tid < T) {
      int r = -1;
      if (t0 + tid < sites) {
        const int v = list[t0 + tid];
        r = (col0 + (v >> 6)) * D_out + (v & 63);  // B*M*D_out < INT_MAX
      }
      orow[tid] = r;
    }
    __syncthreads();
    gt::tile_mma<COUT, true>(feats, weight, out, 0, 0, K, C, sm, orow);
    __syncthreads();  // the next tile rewrites grow, hit and orow
  }
}

template <int COUT>
cudaError_t launch_mma_cout(const Params& p, const u64* zm, int cols) {
  const size_t col_off =
      (gt::smem_bytes<COUT>(p.kz * p.K2, p.C) + 15) / 16 * 16;
  const size_t smem = col_off + column_smem_bytes(cols, p.K2, p.D_out);
  auto kern = column_conv_mma_kernel<COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(((long long)p.B * p.M + cols - 1) / cols);
  kern<<<blocks, gt::THREADS, smem, p.stream>>>(
      static_cast<const bf16*>(p.col_feats), static_cast<const int*>(p.rb), zm,
      static_cast<const bf16*>(p.weight), static_cast<float*>(p.out), p.B, p.N,
      p.M, p.K2, p.D, p.C, p.kz, p.stride_z, p.pad_z, p.D_out, cols,
      (int)col_off);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const Params& p, u64* zm, int cout, int cols) {
  // C % 16 == 0 (16-byte pieces, k16 steps), a C power of two (the wrapper
  // checks it), every flat row and output row index in int, 1..128 columns
  if (p.C % 16 || (long long)p.B * p.N * p.D >= INT_MAX ||
      (long long)p.B * p.M * p.D_out >= INT_MAX - 64 || cols < 1 ||
      cols > MAX_COLS || p.D_out > 64)
    return cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.N;
  int ppz_log2 = 0;
  while ((8 << ppz_log2) < p.C) ++ppz_log2;
  long long blocks = (rows + 7) / 8;  // 8 warps, one row each
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  column_zmask_kernel<<<(unsigned)blocks, 256, 0, p.stream>>>(
      static_cast<const bf16*>(p.col_feats), zm, rows, p.D * p.C / 8,
      ppz_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (cout) {
    case 16:
      return launch_mma_cout<16>(p, zm, cols);
    case 32:
      return launch_mma_cout<32>(p, zm, cols);
    case 64:
      return launch_mma_cout<64>(p, zm, cols);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype 0 = float32, 1 = bf16
// for both col_feats and weight; route 0 = fma, 1 = mma (bf16 only, C % 16
// == 0; col_feats and weight 16-byte aligned; zmask scratch of B*N 64-bit
// words; cols output columns per block). C must be a power of two, D +
// 2*pad_z <= 60, K2 <= 9, kz*K2 <= 32. Returns the cudaError_t of the
// first launch that failed.
extern "C" int column_conv_launch(const void* col_feats, const void* rb,
                                  const void* weight, void* out, void* zmask,
                                  int B, int N, int M, int K2, int D, int C,
                                  int cout, int kz, int stride_z, int pad_z,
                                  int dtype, int route, int cols,
                                  void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N <= 0 || C <= 0 || (C & (C - 1)) || D <= 0 || pad_z < 0 ||
      D + 2 * pad_z > MAX_D || K2 <= 0 || K2 > MAX_K2 || kz <= 0 ||
      kz * K2 > MAX_TAPS || stride_z <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.col_feats = col_feats;
  p.rb = rb;
  p.weight = weight;
  p.out = out;
  p.B = B;
  p.N = N;
  p.M = M;
  p.K2 = K2;
  p.D = D;
  p.C = C;
  p.log2c = 0;
  while ((1 << p.log2c) < C) ++p.log2c;
  p.kz = kz;
  p.stride_z = stride_z;
  p.pad_z = pad_z;
  p.D_out = (D + 2 * pad_z - kz) / stride_z + 1;
  if (p.D_out <= 0) return (int)cudaErrorInvalidValue;
  p.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1 && dtype == 1) {
    err = dispatch_mma(p, static_cast<u64*>(zmask), cout, cols);
  } else if (route == 0 && dtype == 0) {
    err = dispatch<float>(p, cout);
  } else if (route == 0 && dtype == 1) {
    err = dispatch<__nv_bfloat16>(p, cout);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* column_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
