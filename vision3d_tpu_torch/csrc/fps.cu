// Furthest point sampling for NVIDIA Hopper (sm_90a), kernel K3: for each
// cloud of N points, K indices. The first is the first valid point (0 when
// none is); each next one is the point whose running minimum distance to
// the points taken so far is largest, ties to the lower index, as
// torch.argmax breaks them. The running minimum starts at +inf on valid
// points and -inf on invalid ones, and each step takes min(dist, d) with
// d = |p - centre|^2 in ops/fps.squared_distance's rounding
// (squared_distance.cuh). So an invalid point is taken only when no point
// is valid (then every index is 0), and once every valid point is taken the
// first valid one repeats at distance 0. The indices are bit-equal to the
// plain version (ops/fps.furthest_point_sample_plain).
//
// Replaces no TPU kernel: the JAX package computes FPS
// (vision3d_tpu/ops/fps.py) as XLA code, a fori_loop of K - 1 dense
// distance, minimum and argmax passes over the cloud. The port's plain
// version is the same loop in eager PyTorch: ~17 launches a step, ~35,000
// a PV-RCNN batch (B 8, N 18,000, K 2,048), and the card waits on the host
// between them.
//
// What bounds it on the H100: B * (K - 1) * N distances of six conversions
// between float32 and float64 each, at 16 a clock on each SM: ~0.42 ms at
// the shape above over all 132 SMs. Bytes are nothing (the clouds are read
// once). But the steps are a serial chain: each needs the winner of the
// step before, an argmax over the whole cloud, so every step ends in an
// exchange between all the blocks that hold the cloud, and its latency,
// not the arithmetic, sets the time.
//
// Design: one thread-block cluster a cloud (Hopper's distributed shared
// memory), C blocks of THREADS threads. Each block owns a contiguous slice
// of the cloud's points in index order. Each thread keeps its points' x,
// y, z and running minimum in registers (the "reg" route, up to 32 points
// a thread: 65,536 points a cloud at 16 blocks), updated without branches
// so the points' conversion chains overlap; for a larger slice the block
// keeps them in shared memory
// ("smem"), or the running minima live in device memory and the
// coordinates are read from the input each step ("global"). A step: every
// thread updates its points against the centre and keeps its (distance,
// lowest index) candidate; a warp takes its best by two redux.sync (the
// largest distance as an order-preserving key, then the lowest index at
// it); every warp then pushes its candidate (distance, index, x, y, z)
// into a slot of every block of the cluster with st.async, which signals
// the receiver's mbarrier. Each block waits on its own mbarrier until all
// C x WARPS candidates have landed, and every warp reduces them to the same
// winner, whose xyz is the next centre (no global read). There is no
// __syncthreads and no cluster barrier in the loop: a step costs the
// update, two warp reductions and one one-way trip across the cluster.
// Slots and mbarriers are double-buffered by step parity: a block pushes
// step t + 2 into a slot only after every warp of the receiver pushed step
// t + 1, which each does after reading step t's slots. Step 0 runs the
// same reduction on the initial +inf / -inf minima, which gives the first
// valid point. C adapts to the input: the launcher takes the largest of
// 16, 8, 4, 2, 1 at which every cloud's cluster is resident at once
// (cudaOccupancyMaxActiveClusters >= B), up to MAX_CLUSTER.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "squared_distance.cuh"

namespace cg = cooperative_groups;

namespace {

// 128 threads a block and clusters of up to 16 blocks were the fastest of
// 64-512 threads and 4-16 blocks on an H100 at B 1, 8 and 16 (N 18,000,
// K 2,048): fewer warps a block shorten each step's reductions, and the
// slice a block updates halves from 8 blocks to 16.
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int SLOTS = MAX_CLUSTER * WARPS;  // candidates a block receives a step
constexpr unsigned CANDIDATE_BYTES = 20;    // distance, index, x, y, z
constexpr int MAX_POINTS = 32;              // "reg" route: most points a thread
constexpr size_t SMEM_SLICE = 216 * 1024;   // "smem" route: most slice bytes
constexpr unsigned FULL = 0xffffffffu;
// route numbers, in the order of kernels.ROUTES["fps"]
constexpr int ROUTE_REG = 0, ROUTE_SMEM = 1, ROUTE_GLOBAL = 2;

struct Candidate {
  float d;
  int i;
  float x, y, z;
};

__device__ __forceinline__ Candidate no_candidate() {
  return Candidate{-CUDART_INF_F, INT_MAX, 0.f, 0.f, 0.f};
}

// (d, i) beats c: a larger distance, or the same one at a lower index
__device__ __forceinline__ bool beats(float d, int i, const Candidate& c) {
  return d > c.d || (d == c.d && i < c.i);
}

// An unsigned key in the order of the float (-inf lowest).
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The best of the warp's candidates, in every lane: the largest key, the
// lowest index at it, and x, y, z from the lane that held the winner.
__device__ __forceinline__ Candidate warp_best(const Candidate& c) {
  const unsigned key = order_key(c.d);
  const unsigned top = __reduce_max_sync(FULL, key);
  const int i = __reduce_min_sync(FULL, key == top ? c.i : INT_MAX);
  const int src = __ffs(__ballot_sync(FULL, key == top && c.i == i)) - 1;
  return Candidate{__shfl_sync(FULL, c.d, src), i, __shfl_sync(FULL, c.x, src),
                   __shfl_sync(FULL, c.y, src), __shfl_sync(FULL, c.z, src)};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ``addr`` (this block's shared memory) in block ``rank`` of the cluster
__device__ __forceinline__ unsigned remote(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void push(const Candidate& c, unsigned head, unsigned tail,
                                     unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(head), "r"(__float_as_uint(c.d)), "r"(c.i), "r"(__float_as_uint(c.x)),
      "r"(__float_as_uint(c.y)), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(tail),
      "r"(__float_as_uint(c.z)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}" ::"r"(bar), "r"(parity)
      : "memory");
}

// One cluster a cloud: grid (C, B), cluster (C, 1, 1). P is the "reg"
// route's points a thread (1 for the other routes).
template <int ROUTE, int P>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ xyz, const bool* __restrict__ mask, int N, int K,
           float* __restrict__ scratch, long long* __restrict__ out) {
  extern __shared__ float4 slice[];                    // "smem": (x, y, z, minimum)
  __shared__ float4 head[2][SLOTS];                    // (distance, index, x, y)
  __shared__ float tail[2][SLOTS];                     // z
  __shared__ __align__(8) unsigned long long bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (N + C - 1) / C;
  const int lo = min(N, rank * per), hi = min(N, lo + per);
  const float* pts = xyz + (long long)b * N * 3;
  const bool* mk = mask + (long long)b * N;

  if (tid == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&bar[p])), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Unowned "reg" slots hold -inf at the origin and are never taken.
  float px[P], py[P], pz[P], pd[P];
  if constexpr (ROUTE == ROUTE_REG) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int j = lo + tid + k * THREADS;
      const bool own = j < hi;
      px[k] = own ? pts[3LL * j] : 0.f;
      py[k] = own ? pts[3LL * j + 1] : 0.f;
      pz[k] = own ? pts[3LL * j + 2] : 0.f;
      pd[k] = own && mk[j] ? CUDART_INF_F : -CUDART_INF_F;
    }
  } else {
    for (int j = lo + tid; j < hi; j += THREADS) {
      const float d0 = mk[j] ? CUDART_INF_F : -CUDART_INF_F;
      if constexpr (ROUTE == ROUTE_SMEM) {
        slice[j - lo] = make_float4(pts[3LL * j], pts[3LL * j + 1], pts[3LL * j + 2], d0);
      } else {
        scratch[(long long)b * N + j] = d0;
      }
    }
  }
  // every block's mbarriers exist before any candidate is pushed
  cluster.sync();

  // lane r < C pushes the warp's candidate into its slot of block r
  const int slot = rank * WARPS + warp;
  unsigned to_head[2], to_tail[2], to_bar[2];
  for (int p = 0; p < 2; ++p) {
    const unsigned r = (unsigned)min(lane, C - 1);
    to_head[p] = remote(smem_addr(&head[p][slot]), r);
    to_tail[p] = remote(smem_addr(&tail[p][slot]), r);
    to_bar[p] = remote(smem_addr(&bar[p]), r);
  }
  const unsigned expect = (unsigned)(C * WARPS) * CANDIDATE_BYTES;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (int t = 0; t < K; ++t) {
    const int parity = t & 1;
    if (tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_addr(&bar[parity])),
                   "r"(expect)
                   : "memory");
    Candidate best = no_candidate();
    if constexpr (ROUTE == ROUTE_REG) {
      if (t > 0) {
#pragma unroll
        for (int k = 0; k < P; ++k)
          pd[k] = fminf(pd[k], squared_distance(px[k], py[k], pz[k], cx, cy, cz));
      }
      // indices rise with k: the first largest is the lowest index
      int bk = 0;
      best.d = pd[0];
      best.x = px[0];
      best.y = py[0];
      best.z = pz[0];
#pragma unroll
      for (int k = 1; k < P; ++k) {
        if (pd[k] > best.d) {
          best.d = pd[k];
          bk = k;
          best.x = px[k];
          best.y = py[k];
          best.z = pz[k];
        }
      }
      best.i = lo + tid < hi ? lo + tid + bk * THREADS : INT_MAX;
    } else {
      // an invalid point's minimum stays -inf: skip its distance
      auto visit = [&](int j, float x, float y, float z, float& d) {
        if (t > 0 && d > -CUDART_INF_F) d = fminf(d, squared_distance(x, y, z, cx, cy, cz));
        if (beats(d, j, best)) best = Candidate{d, j, x, y, z};
      };
      if constexpr (ROUTE == ROUTE_SMEM) {
        for (int j = tid; j < hi - lo; j += THREADS) {
          float4 p = slice[j];
          visit(lo + j, p.x, p.y, p.z, p.w);
          slice[j].w = p.w;
        }
      } else {
        float* dist = scratch + (long long)b * N;
        for (int j = lo + tid; j < hi; j += THREADS) {
          float d = dist[j];
          visit(j, pts[3LL * j], pts[3LL * j + 1], pts[3LL * j + 2], d);
          dist[j] = d;
        }
      }
    }
    best = warp_best(best);
    if (lane < C) push(best, to_head[parity], to_tail[parity], to_bar[parity]);
    wait_parity(smem_addr(&bar[parity]), (unsigned)(t >> 1) & 1u);
    Candidate c = no_candidate();
    for (int e = lane; e < C * WARPS; e += 32) {
      const float4 h = head[parity][e];
      const int i = __float_as_int(h.y);
      if (beats(h.x, i, c)) c = Candidate{h.x, i, h.z, h.w, tail[parity][e]};
    }
    const Candidate win = warp_best(c);
    cx = win.x;
    cy = win.y;
    cz = win.z;
    if (rank == 0 && tid == 32) out[(long long)b * K + t] = win.i;
  }
  // no block leaves while a push to it or from it may be in flight
  cluster.sync();
}

using Kernel = void (*)(const float*, const bool*, int, int, float*, long long*);

struct Plan {
  int route, cluster, points;
  size_t smem;
};

// the "reg" route's points a thread
constexpr int REG_POINTS[] = {1, 2, 4, 6, 8, 12, 16, 24, MAX_POINTS};

// Where a block of a C-block cluster keeps its slice of an N-point cloud.
Plan plan_for(int N, int C) {
  const long long per = (N + C - 1) / C;
  Plan pl{ROUTE_GLOBAL, C, 1, 0};
  if (per <= (long long)THREADS * MAX_POINTS) {
    pl.route = ROUTE_REG;
    for (int p : REG_POINTS) {
      pl.points = p;
      if ((long long)p * THREADS >= per) break;
    }
  } else if (per * sizeof(float4) <= SMEM_SLICE) {
    pl.route = ROUTE_SMEM;
    pl.smem = per * sizeof(float4);
  }
  return pl;
}

Kernel kernel_of(const Plan& pl) {
  if (pl.route == ROUTE_SMEM) return fps_kernel<ROUTE_SMEM, 1>;
  if (pl.route == ROUTE_GLOBAL) return fps_kernel<ROUTE_GLOBAL, 1>;
  switch (pl.points) {
    case 1: return fps_kernel<ROUTE_REG, 1>;
    case 2: return fps_kernel<ROUTE_REG, 2>;
    case 4: return fps_kernel<ROUTE_REG, 4>;
    case 6: return fps_kernel<ROUTE_REG, 6>;
    case 8: return fps_kernel<ROUTE_REG, 8>;
    case 12: return fps_kernel<ROUTE_REG, 12>;
    case 16: return fps_kernel<ROUTE_REG, 16>;
    case 24: return fps_kernel<ROUTE_REG, 24>;
    default: return fps_kernel<ROUTE_REG, MAX_POINTS>;
  }
}

// The kernel of ``pl`` with its attributes set and its launch configuration
// (``attr`` holds the cluster dimension).
cudaError_t configure(const Plan& pl, int B, cudaStream_t stream, Kernel* kernel,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *kernel = kernel_of(pl);
  cudaError_t err = cudaSuccess;
  if (pl.cluster > 8)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && pl.route == ROUTE_SMEM)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)pl.smem);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)pl.cluster, (unsigned)B, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = pl.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)pl.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// fps_plan: the route (0 "reg", 1 "smem", 2 "global") and cluster size that
// B clouds of N points take on the current device: the largest cluster of
// MAX_CLUSTER, ..., 2, 1 blocks at which all B clusters are resident at
// once (1 if none is). Returns a cudaError_t.
extern "C" int fps_plan(int B, int N, int* route, int* cluster) {
  if (B <= 0 || B > 65535 || N <= 0) return (int)cudaErrorInvalidValue;
  for (int c = MAX_CLUSTER; c >= 1; c /= 2) {
    const Plan pl = plan_for(N, c);
    Kernel kernel;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int active = 0;
    cudaError_t err = configure(pl, B, nullptr, &kernel, &cfg, &attr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) {
      if (c == 1) return (int)err;
      cudaGetLastError();       // this cluster size is not available: try the next
      continue;
    }
    if (active >= B || c == 1) {
      *route = pl.route;
      *cluster = c;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// fps_launch: xyz (B, N, 3) float32 and mask (B, N) bool, contiguous on the
// current device; out (B, K) int64; scratch (B, N) float32 for the "global"
// route (else unused); route and cluster as fps_plan gave them. Returns the
// cudaError_t of the launch.
extern "C" int fps_launch(const void* xyz, const void* mask, int B, int N, int K, int route,
                          int cluster, void* scratch, void* out, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (B > 65535 || N <= 0 || cluster < 1 || cluster > MAX_CLUSTER
      || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan_for(N, cluster);
  if (pl.route != route || (route == ROUTE_GLOBAL && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(pl, B, static_cast<cudaStream_t>(stream), &kernel, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(xyz),
                             static_cast<const bool*>(mask), N, K,
                             static_cast<float*>(scratch), static_cast<long long*>(out));
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}

extern "C" const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
