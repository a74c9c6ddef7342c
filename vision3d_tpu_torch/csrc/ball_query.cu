// Ball query for NVIDIA Hopper (sm_90a): for each centre, the first S
// source points by index whose squared distance to it is below r2 and whose
// mask is true; the first one found repeated to fill the group; an empty
// ball gives indices 0 and valid false.
//
// Replaces no TPU kernel: the JAX package computes the ball query
// (vision3d_tpu/ops/ball_query.py) as XLA code, a dense (N,) distance row
// per centre, a cumsum rank and a scatter. The port's plain version
// (ops/ball_query.ball_query_plain) does the same over (B, chunk, N) blocks
// with float64 temporaries: several hundred GB of device traffic a
// PV-RCNN forward (ten queries over sources of up to 64,000 rows x 2,048
// keypoints x 8 frames, two more in the RoI grid pool) for what is a scan
// in index order that can stop early. This kernel is that scan.
//
// The distance is bit-equal to ops/fps.squared_distance (squared_distance.cuh,
// shared with the FPS kernel, says how), then d < r2, r2 = float32(radius)^2
// from the wrapper.
//
// What bounds it on the H100: at most B*M*N pair tests of 13 operations
// (three float32 differences, one float32 multiply, two float64 fmas, six
// conversions between float32 and float64, a compare); the conversions, at
// 16 a clock on each SM, are the slowest part. Bytes are small: each block
// reads its frame's source once (13 bytes a row) and every group is
// written once (9 bytes an entry). A ball that fills early stops its scan;
// one that never fills scans the whole source.
//
// Design: a block holds W consecutive centres of one frame, one warp a
// centre, and streams the frame's source in index order through shared
// memory in tiles of 32*W rows (float32 xyz and the bool mask), each tile
// loaded once, coalesced, for all W centres. A warp tests its centre
// against 32 consecutive rows at a time, one a lane; a ballot gives the
// hits in index order, so a lane's slot in the group is the hits so far
// plus the hits of the lanes below it, and the hit writes its index
// straight to the output. A warp whose group is full skips the rest; the
// block stops streaming once every warp is full (__syncthreads_and), and
// skips the compute of a tile whose rows are all masked out
// (__syncthreads_or), so the padding at the end of a source costs one read.
// W (8, 4 or 2) is the largest that still gives the card four blocks an SM:
// main-path shapes (B*M of 12,800 and 16,384 centres) take 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "squared_distance.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(W * 32)
ball_query_kernel(const float* __restrict__ src, const bool* __restrict__ mask,
                  const float* __restrict__ centers, int N, int M, int S, float r2,
                  long long* __restrict__ idx, bool* __restrict__ valid) {
  constexpr int TILE = W * 32;
  __shared__ float tile_xyz[3 * TILE];
  __shared__ bool tile_mask[TILE];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * W + (threadIdx.x >> 5);
  const bool live = m < M;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (live) {
    const float* c = centers + ((long long)b * M + m) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  const float* s = src + (long long)b * N * 3;
  const bool* mk = mask + (long long)b * N;
  long long* group = idx + ((long long)b * M + m) * S;
  int count = live ? 0 : S;   // hits so far, the same in every lane
  int first = 0;              // index of the first hit

  for (int base = 0; base < N; base += TILE) {
    // also keeps the previous tile until every warp has read it
    if (__syncthreads_and(count >= S)) break;
    const int n = min(TILE, N - base);
    for (int f = threadIdx.x; f < 3 * n; f += TILE) tile_xyz[f] = s[3LL * base + f];
    const bool row = threadIdx.x < n && mk[base + threadIdx.x];
    tile_mask[threadIdx.x] = row;
    if (!__syncthreads_or(row)) continue;
    if (count >= S) continue;
    for (int k = 0; k < n; k += 32) {
      const int j = k + lane;
      bool hit = false;
      if (j < n && tile_mask[j]) {
        hit = squared_distance(cx, cy, cz, tile_xyz[3 * j], tile_xyz[3 * j + 1],
                               tile_xyz[3 * j + 2]) < r2;
      }
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (bits == 0u) continue;
      if (count == 0) first = base + k + __ffs(bits) - 1;
      const int slot = count + __popc(bits & ((1u << lane) - 1u));
      if (hit && slot < S) group[slot] = base + j;
      count += __popc(bits);
      if (count >= S) break;
    }
  }
  if (!live) return;
  const int found = min(count, S);
  bool* v = valid + ((long long)b * M + m) * S;
  for (int t = lane; t < S; t += 32) {
    if (t >= found) group[t] = found ? first : 0;
    v[t] = found > 0;
  }
}

template <int W>
cudaError_t launch(const float* src, const bool* mask, const float* centers, int B,
                   int N, int M, int S, float r2, long long* idx, bool* valid,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((M + W - 1) / W), (unsigned)B);
  ball_query_kernel<W><<<grid, W * 32, 0, stream>>>(src, mask, centers, N, M, S, r2,
                                                     idx, valid);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). src (B, N, 3) float32, mask
// (B, N) bool, centers (B, M, 3) float32, idx (B, M, S) int64 and valid
// (B, M, S) bool, all contiguous on the current device; r2 the float32
// squared radius. Returns the cudaError_t of the launch.
extern "C" int ball_query_launch(const void* src, const void* mask, const void* centers,
                                 int B, int N, int M, int S, float r2, void* idx,
                                 void* valid, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N < 0 || S <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = 4LL * sms;
  auto blocks = [&](int w) { return (long long)B * ((M + w - 1) / w); };
  const float* s = static_cast<const float*>(src);
  const bool* mk = static_cast<const bool*>(mask);
  const float* c = static_cast<const float*>(centers);
  long long* ix = static_cast<long long*>(idx);
  bool* v = static_cast<bool*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks(8) >= want) return (int)launch<8>(s, mk, c, B, N, M, S, r2, ix, v, st);
  if (blocks(4) >= want) return (int)launch<4>(s, mk, c, B, N, M, S, r2, ix, v, st);
  return (int)launch<2>(s, mk, c, B, N, M, S, r2, ix, v, st);
}

extern "C" const char* ball_query_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
