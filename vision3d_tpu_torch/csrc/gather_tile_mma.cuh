// Tiles of gathered rows on Hopper's tensor cores (sm_90a): the part that
// the rulebook gather-GEMM (gather_gemm.cu), the z-window conv
// (zwin_conv.cu), the column conv (column_conv.cu) and the z-window kernels
// on gathered windows (zwin_align_gemm.cu) share on their "mma" routes.
//
// A block of 4 warps owns a tile of T = 64 consecutive flattened sites
// (b*M + m) and all Cout columns of out (B*M, Cout) f32:
//
//   out[site, :] = sum over taps k with grow[i*K + k] >= 0 of
//                  feats[grow[i*K + k], :] @ W[k*C : (k+1)*C, :]
//
// for site = tile0 + i, with feats read as one flat (B*N, C) bf16 table.
// The kernel that includes this header first builds the tile's rulebook in
// shared memory: grow[i*K + k], the global row b*N + row that tap k of site
// i reads (-1 for a miss), and hit[k] != 0 for every tap that some site of
// the tile hits; how it gets them (read from a rulebook, or computed) is
// its own business. tile_mma() does the rest, after a barrier:
//
// * a warp ballot compacts the hit taps into a list, so a tap that no site
//   hits is skipped whole and the ring below never meets a skipped tap;
// * for each hit tap (in chunks of at most 64 channels) the T gathered
//   C-wide rows are staged into an A tile by 16-byte cp.async (a miss is
//   the zero-fill form, with src-size 0 from the valid base address: no
//   address is formed from a miss row) and the tap's weight slice into a B
//   tile; rows are padded by 16 bytes so ldmatrix is conflict-free;
// * two stages: the copies of the next hit tap are in flight while the
//   current one is multiplied with ldmatrix (.trans for B) and mma.sync
//   m16n8k16 bf16 -> f32. The sums stay in registers across all taps; the
//   epilogue writes the f32 rows below B*M, or, with ROW_MAP, site i's sum
//   to row orow[i] of out (a shared-memory map the caller writes beside
//   grow; -1: no site), for a caller whose sites are not consecutive rows.
//   With ACCUM it adds the sums to what out holds, for a caller that runs
//   a second rulebook over the same tile (each thread reads back only the
//   elements it wrote itself).
//
// Needs C % 16 == 0, feats and W 16-byte aligned, B*N and B*M + 64 below
// INT_MAX (the launchers check the sizes, the wrappers the alignment).
// Warps: 4 x 1 of 16 sites x Cout up to Cout 64; 2 x 2 of 32 sites x 64
// columns at Cout 128 (64 f32 sums a thread). On the training step's 27
// shapes on the H100 tiles of 64 took 13.0 ms in all, tiles of 128 (twice
// the rows per warp) 13.9 ms (tools/microbench_torch_gather_gemm.py): more
// blocks in flight hide the gather's latency better than fewer weight
// copies per site save.

#pragma once

#include <climits>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gather_tile {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;  // 4 warps
constexpr int CK_MAX = 64;    // channels of one stage
constexpr int PAD = 8;        // bf16 of padding per staged row (16 bytes)

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
// columns of the T = WM * WARPS_M = 64 site tile.
template <int COUT>
struct Shape {
  static constexpr int WM = COUT == 128 ? 32 : 16;
  static constexpr int WARPS_M = COUT == 128 ? 2 : 4;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int T = WM * WARPS_M;
  static constexpr int WN = COUT / WARPS_N;
  static constexpr int MT = WM / 16;     // m16 tiles per warp
  static constexpr int NT = WN / 8;      // n8 tiles per warp
  static constexpr int BS = COUT + PAD;  // weight row stride (bf16)
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
};

// Dynamic shared memory of one block: two A tiles [T][ck + PAD], two B
// tiles [ck][COUT + PAD], the tile's rulebook [T*K], hit [K], the tap list
// [K] and its length.
template <int COUT>
size_t smem_bytes(int K, int C) {
  typedef Shape<COUT> S;
  const int ck = C < CK_MAX ? C : CK_MAX;
  return 2 * (size_t)S::T * (ck + PAD) * sizeof(bf16) +
         2 * (size_t)ck * S::BS * sizeof(bf16) +
         ((size_t)S::T * K + 2 * (size_t)K + 1) * sizeof(int);
}

struct TileSmem {
  bf16* a;     // two A tiles
  bf16* b;     // two B tiles
  int* grow;   // [T*K] global rows, -1: miss (written by the caller)
  int* hit;    // [K] any site of the tile hits tap k (written by the caller)
  int* taps;   // [K] the hit taps, in order
  int* ntaps;  // their number
};

template <int COUT>
__device__ __forceinline__ TileSmem carve_smem(void* raw, int K, int C) {
  typedef Shape<COUT> S;
  const int ck_max = C < CK_MAX ? C : CK_MAX;
  TileSmem sm;
  sm.a = reinterpret_cast<bf16*>(raw);
  sm.b = sm.a + 2 * S::T * (ck_max + PAD);
  sm.grow = reinterpret_cast<int*>(sm.b + 2 * ck_max * S::BS);
  sm.hit = sm.grow + S::T * K;
  sm.taps = sm.hit + K;
  sm.ntaps = sm.taps + K;
  return sm;
}

// The tile's product, once sm.grow and sm.hit (and orow with ROW_MAP) are
// written and a barrier has passed. out is (total, COUT) row-major; rows >=
// total are not written. With ROW_MAP, site i goes to row orow[i] and
// total and tile0 are not read. With ACCUM the sums are added to out.
template <int COUT, bool ROW_MAP = false, bool ACCUM = false>
__device__ __forceinline__ void tile_mma(const bf16* __restrict__ feats,
                                         const bf16* __restrict__ weight,
                                         float* __restrict__ out, int total,
                                         int tile0, int K, int C,
                                         const TileSmem& sm,
                                         const int* orow = nullptr) {
  typedef Shape<COUT> S;
  constexpr int T = S::T, MT = S::MT, NT = S::NT, BS = S::BS;
  const int ck_max = C < CK_MAX ? C : CK_MAX;
  const int as = ck_max + PAD;  // A row stride (bf16): 16 bytes off 32k
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 1. the hit taps, in order
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool on = k0 + lane < K && sm.hit[k0 + lane];
      const unsigned votes = __ballot_sync(0xffffffffu, on);
      if (on) sm.taps[n + __popc(votes & ((1u << lane) - 1))] = k0 + lane;
      n += __popc(votes);
    }
    if (lane == 0) *sm.ntaps = n;
  }
  __syncthreads();
  const int nchunks = (C + CK_MAX - 1) / CK_MAX;
  const int stages = *sm.ntaps * nchunks;

  // 2. stage s = (hit tap s / nchunks, channel chunk s % nchunks)
  auto load_stage = [&](int s) {
    const int t = s / nchunks;
    const int c0 = (s - t * nchunks) * CK_MAX;
    const int k = sm.taps[t];
    const int ck = min(CK_MAX, C - c0);
    bf16* a = sm.a + (s & 1) * T * as;
    bf16* w = sm.b + (s & 1) * ck_max * BS;
    const int pieces = ck / 8;  // 16-byte pieces of a row
    for (int p = tid; p < T * pieces; p += THREADS) {
      const int i = p / pieces, q = p - i * pieces;
      const int g = sm.grow[i * K + k];
      const bf16* src = g >= 0 ? feats + (long long)g * C + c0 + q * 8 : feats;
      cp_async16(smem_addr(a + i * as + q * 8), src, g >= 0);
    }
    constexpr int WP = COUT / 8;
    const bf16* wsrc = weight + ((long long)k * C + c0) * COUT;
    for (int p = tid; p < ck * WP; p += THREADS) {
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

  const int wm0 = (warp % S::WARPS_M) * S::WM;
  const int wn0 = (warp / S::WARPS_M) * S::WN;
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
    const bf16* a = sm.a + (s & 1) * T * as;
    const bf16* w = sm.b + (s & 1) * ck_max * BS;
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
  // 2*(lane%4) + {0, 1}
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int i0 = wm0 + mt * 16 + (lane >> 2);
    int r0, r1;
    bool on0, on1;
    if constexpr (ROW_MAP) {
      r0 = orow[i0];
      r1 = orow[i0 + 8];
      on0 = r0 >= 0;
      on1 = r1 >= 0;
    } else {
      r0 = tile0 + i0;
      r1 = r0 + 8;
      on0 = r0 < total;
      on1 = r1 < total;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = wn0 + nt * 8 + (lane & 3) * 2;
      if (on0) {
        float2* p = reinterpret_cast<float2*>(out + (long long)r0 * COUT + n);
        float2 v = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        if constexpr (ACCUM) v = make_float2(v.x + p->x, v.y + p->y);
        *p = v;
      }
      if (on1) {
        float2* p = reinterpret_cast<float2*>(out + (long long)r1 * COUT + n);
        float2 v = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        if constexpr (ACCUM) v = make_float2(v.x + p->x, v.y + p->y);
        *p = v;
      }
    }
  }
}

// Whether a call with these sizes fits the tile's int arithmetic.
inline bool sizes_fit(int B, int N, int M, int C) {
  return C % 16 == 0 && (long long)B * N < INT_MAX &&
         (long long)B * M < INT_MAX - 64;
}

// Launches Kernel<cout>::fn() (a __global__ function of the Cout; one block
// per tile of 64 sites, with the dynamic shared memory of a K-tap
// rulebook); args are the kernel's own arguments.
template <template <int> class Kernel, typename... Args>
cudaError_t launch_tiles(int cout, long long sites, int K, int C,
                         cudaStream_t stream, Args... args) {
  auto go = [&](auto co) -> cudaError_t {
    constexpr int COUT = decltype(co)::value;
    const size_t smem = smem_bytes<COUT>(K, C);
    auto kernel = Kernel<COUT>::fn();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks =
        (unsigned)((sites + Shape<COUT>::T - 1) / Shape<COUT>::T);
    kernel<<<blocks, THREADS, smem, stream>>>(args...);
    return cudaGetLastError();
  };
  switch (cout) {
    case 8:
      return go(std::integral_constant<int, 8>());
    case 16:
      return go(std::integral_constant<int, 16>());
    case 32:
      return go(std::integral_constant<int, 32>());
    case 64:
      return go(std::integral_constant<int, 64>());
    case 128:
      return go(std::integral_constant<int, 128>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace gather_tile
