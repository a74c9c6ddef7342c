// Inference conv epilogue (K4) for NVIDIA Hopper (sm_90a): batch norm on
// the running statistics, ReLU, the site mask and the cast to the compute
// dtype, in one pass over a conv's output.
//
// x is R rows of C channels, channels last (a dense volume's (B, D, H, W)
// sites in channels-last-3d memory, a sparse tensor's (B, N) rows or a
// column tensor's (B, Ncol, D) rows), bf16 or float32; site holds one byte
// a row. Per channel c, from float32 vectors:
//   out = site ? relu(((x - mean[c]) * rstd[c]) * weight[c] + bias[c]) : 0
// rounded to the output dtype (bf16 or float32). Every step rounds on its
// own (__fsub_rn, __fmul_rn, __fadd_rn: no contraction into fused
// multiply-adds), relu keeps a NaN as torch's clamp_min does, and the cast
// is round-to-nearest-even, so the result is bit-equal to the PyTorch chain
// it replaces (ops/bn_relu.bn_relu_plain: one elementwise kernel a step);
// rstd = rsqrt(running_var + eps) comes from that chain's own kernels.
//
// Replaces no TPU kernel: the JAX package leaves the epilogue to XLA, which
// fuses it into one loop. Added because in eager PyTorch the chain is about
// eight passes over the whole volume in float32; stage 2 of a SECOND batch
// of 8 is 12.39 M sites x 64 channels, 3.17 GB a pass.
//
// What bounds it on the H100: bytes only, about 6 operations an element.
// The rows of active sites are read once, the site bytes once, every row
// written once. A row whose site is off is written as zeros and never read.
//
// Design: 16-byte loads (8 bf16 or 4 float32 channels a lane) with the
// streaming cache hint, since every byte is touched once. A lane owns one
// fixed group of channels and walks rows in a grid-stride loop, so its
// channels' four constants stay in registers; the loop takes UNROLL rows
// at a time, so each lane has that many loads in flight. The grid is as
// many blocks as fit on the card at once. With equal input and output
// dtypes the caller may pass out == x: each lane reads its 16 bytes before
// it writes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float epilogue(float v, float m, float rs, float w, float b) {
  float t = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), rs), w), b);
  return isnan(t) ? t : fmaxf(t, 0.f);
}

// the N channels of one 16-byte load, as float32
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a low, b high
  return *reinterpret_cast<const uint32_t*>(&h);
}

// store N channels (4 or 8) of float32 results as To
template <typename To, int N> struct Store;

template <int N> struct Store<float, N> {
  __device__ static void run(float* p, const float* f) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<uint4*>(p + i),
             make_uint4(__float_as_uint(f[i]), __float_as_uint(f[i + 1]),
                        __float_as_uint(f[i + 2]), __float_as_uint(f[i + 3])));
  }
};

template <> struct Store<__nv_bfloat16, 4> {
  __device__ static void run(__nv_bfloat16* p, const float* f) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3])));
  }
};

template <> struct Store<__nv_bfloat16, 8> {
  __device__ static void run(__nv_bfloat16* p, const float* f) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7])));
  }
};

// x and out may be one buffer, so neither is __restrict__
template <typename Ti, typename To>
__global__ void __launch_bounds__(THREADS)
bn_relu_kernel(const Ti* x, const uint8_t* __restrict__ site, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ weight,
               const float* __restrict__ bias, To* out, long long R, int C) {
  constexpr int N = Vec<Ti>::N;
  const int groups = C / N;                   // lanes a row
  const int rows_per_block = blockDim.x / groups;
  const int lane_row = threadIdx.x / groups;   // blockDim.x is a multiple of groups
  const int c0 = (threadIdx.x - lane_row * groups) * N;
  float m[N], rs[N], w[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = mean[c0 + i];
    rs[i] = rstd[c0 + i];
    w[i] = weight[c0 + i];
    b[i] = bias[c0 + i];
  }
  const long long step = (long long)gridDim.x * rows_per_block;
  for (long long r0 = (long long)blockIdx.x * rows_per_block + lane_row; r0 < R;
       r0 += UNROLL * step) {
    bool on[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = r0 + u * step;
      on[u] = r < R && site[r] != 0;
    }
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (on[u])
        raw[u] = __ldcs(reinterpret_cast<const uint4*>(x + (r0 + u * step) * C + c0));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = r0 + u * step;
      if (r >= R) break;
      float f[N];
      Vec<Ti>::unpack(raw[u], f);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = on[u] ? epilogue(f[i], m[i], rs[i], w[i], b[i]) : 0.f;
      Store<To, N>::run(out + r * C + c0, f);
    }
  }
}

template <typename Ti, typename To>
cudaError_t launch(const void* x, const void* site, const void* mean, const void* rstd,
                   const void* weight, const void* bias, void* out, long long R, int C,
                   cudaStream_t stream) {
  const int groups = C / Vec<Ti>::N;
  const int threads = (THREADS / groups) * groups;
  const int rows_per_block = threads / groups;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_relu_kernel<Ti, To>,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (R + rows_per_block - 1) / rows_per_block;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  bn_relu_kernel<Ti, To><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const Ti*>(x), static_cast<const uint8_t*>(site),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<To*>(out), R, C);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x (R, C) in_bf16 ? bf16 :
// float32, out (R, C) out_bf16 ? bf16 : float32, both contiguous, 16-byte
// aligned, and either the same buffer (equal dtypes) or disjoint; site (R,)
// bytes, 0 or 1; mean, rstd, weight, bias (C,) float32. C a multiple of
// the channels a 16-byte load holds (8 bf16, 4 float32) and at most 256
// such groups. Returns the launch's cudaError_t.
extern "C" int bn_relu_launch(const void* x, const void* site, const void* mean,
                              const void* rstd, const void* weight, const void* bias, void* out,
                              long long R, int C, int in_bf16, int out_bf16, void* stream) {
  if (R <= 0) return 0;
  const int n = in_bf16 ? 8 : 4;
  if (C <= 0 || C % n != 0 || C / n > THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, site, mean, rstd, weight, bias, out, R, C, s);
  else if (in_bf16)
    err = launch<__nv_bfloat16, float>(x, site, mean, rstd, weight, bias, out, R, C, s);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(x, site, mean, rstd, weight, bias, out, R, C, s);
  else
    err = launch<float, float>(x, site, mean, rstd, weight, bias, out, R, C, s);
  return (int)err;
}

extern "C" const char* bn_relu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
