// Voxel query (K2) for NVIDIA Hopper (sm_90a): Voxel R-CNN's grouping of
// a scale's voxels around each RoI grid point. For each grid point p, the
// first S occupied voxels of a fixed scan of the (2rz+1) x (2ry+1) x (2rx+1)
// cells around p's own cell whose centres lie within r of p; later slots
// repeat the first; a point with none has every slot -1.
//
// Replaces no TPU kernel: the JAX package has no Voxel R-CNN. Added because
// no PyTorch call takes the first S hits of a window scan by index, and the
// port's plain version (ops/voxel_query.voxel_query_plain) materialises every
// window cell of every grid point: 8 frames x 100 RoIs x 216 grid points x
// 729 cells x 3 scales = 378 M probes a batch, each a few dozen bytes of
// temporaries.
//
// Arithmetic, bit-equal to the plain version (no contraction into fused
// multiply-adds: every operation is an _rn intrinsic):
//   cell   c = floor((p - lo) / step) per axis, clamped to CLAMP cells
//          outside the grid (a NaN to the low side);
//   centre q = ((float)c + 0.5f) * step + lo, a multiply then an add;
//   d = (dx*dx + dy*dy) + dz*dz of the float32 differences q - p;
//   taken when the cell holds a voxel (map >= 0) and d <= r2.
// Scan order: dz outermost, then dy, then dx, each from -range to range.
//
// What bounds it on the H100: the probes of the map, one int32 each, at
// most T = 729 a grid point and scale; the map (B, D, H, W) int32 holds
// 378 MB at stride 2 for a batch of 8, but a RoI's grid points share most
// of their windows, so the probes hit L2. Distance tests are 8 float32
// operations each, on occupied cells only. A row that fills early stops
// its scan.
//
// Design: one warp a grid point. A round takes 32 consecutive cells of the
// scan, one a lane; lanes of a round read at most four x-runs of the map,
// 9 consecutive int32 each. A ballot gives the round's hits in scan order,
// so a lane's slot is the hits so far plus the hits of the lanes below it,
// and the hit writes its row straight to the output; the first hit is
// broadcast with a shuffle for the fill. The warp stops once S are taken.
// Blocks of 8 warps; no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr float CLAMP = 64.f;

__device__ __forceinline__ int cell_of(float p, float lo, float step, int dim) {
  float f = floorf(__fdiv_rn(__fsub_rn(p, lo), step));
  if (!(f >= -CLAMP)) f = -CLAMP;
  const float hi = (float)dim + CLAMP;
  if (f > hi) f = hi;
  return (int)f;
}

__device__ __forceinline__ float centre_of(int c, float lo, float step) {
  return __fadd_rn(__fmul_rn(__fadd_rn((float)c, 0.5f), step), lo);
}

__global__ void __launch_bounds__(WARPS * 32)
voxel_query_kernel(const int* __restrict__ vmap, int B, int D, int H, int W,
                   const float* __restrict__ points, int G, float lox, float loy, float loz,
                   float sx, float sy, float sz, int rx, int ry, int rz, float r2, int S,
                   int* __restrict__ idx) {
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * G) return;
  const int b = (int)(warp / G);
  const float* p = points + warp * 3;
  const float px = p[0], py = p[1], pz = p[2];
  const int cx = cell_of(px, lox, sx, W), cy = cell_of(py, loy, sy, H),
            cz = cell_of(pz, loz, sz, D);
  const int nx = 2 * rx + 1, ny = 2 * ry + 1;
  const int total = nx * ny * (2 * rz + 1);
  const int* m = vmap + (long long)b * D * H * W;
  int* out = idx + warp * S;
  int count = 0;    // hits so far, the same in every lane
  int first = -1;   // row of the first hit
  for (int base = 0; base < total && count < S; base += 32) {
    const int t = base + lane;
    bool hit = false;
    int row = -1;
    if (t < total) {
      const int x = cx + t % nx - rx;
      const int rest = t / nx;
      const int y = cy + rest % ny - ry;
      const int z = cz + rest / ny - rz;
      if (x >= 0 && x < W && y >= 0 && y < H && z >= 0 && z < D) {
        row = m[((long long)z * H + y) * W + x];
        if (row >= 0) {
          const float dx = __fsub_rn(centre_of(x, lox, sx), px);
          const float dy = __fsub_rn(centre_of(y, loy, sy), py);
          const float dz = __fsub_rn(centre_of(z, loz, sz), pz);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          hit = d <= r2;
        }
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if (bits == 0u) continue;
    const int lead = __ffs(bits) - 1;
    const int lead_row = __shfl_sync(0xffffffffu, row, lead);
    if (count == 0) first = lead_row;
    const int slot = count + __popc(bits & ((1u << lane) - 1u));
    if (hit && slot < S) out[slot] = row;
    count += __popc(bits);
  }
  const int found = min(count, S);
  for (int s = lane; s < S; s += 32)
    if (s >= found) out[s] = first;
}

}  // namespace

// Plain C entry point (loaded with ctypes). vmap (B*D*H*W + 1,) int32, each
// cell's row or -1; points (B, G, 3) float32; idx (B, G, S) int32; all
// contiguous on the current device. lo and step xyz float32, ranges in
// cells, r2 the float32 squared radius. Returns the launch's cudaError_t.
extern "C" int voxel_query_launch(const void* vmap, int B, int D, int H, int W,
                                  const void* points, int G, float lox, float loy,
                                  float loz, float sx, float sy, float sz, int rx, int ry,
                                  int rz, float r2, int S, void* idx, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (D <= 0 || H <= 0 || W <= 0 || S <= 0 || rx < 0 || ry < 0 || rz < 0)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * G;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  voxel_query_kernel<<<(unsigned)blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vmap), B, D, H, W, static_cast<const float*>(points), G, lox,
      loy, loz, sx, sy, sz, rx, ry, rz, r2, S, static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

extern "C" const char* voxel_query_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
