// |a - b|^2 in the rounding of ops/fps.squared_distance, which rounds as
// XLA's CPU code fuses jnp.sum(jnp.square(a - b), -1): dx, dy, dz float32
// differences; then p = (float)(dx*dx), q = (float)((double)dy*dy + p),
// d = (float)((double)dz*dz + q), each product exact in float64. FPS and
// ball-query indices are held exact against the plain version, the
// benchmark's reference and the JAX package, so d is formed in that
// sequence: p as one float32 multiply (the exact product rounded once, as
// the float64 product rounded to float32 is), q and d as float64 fused
// multiply-adds (the product is exact, so one rounding of the sum, as the
// float64 add) each rounded to float32. A float32 fma chain would round the
// sums once where the plain version rounds twice, and can differ on a
// float32 midpoint. The sign of a difference squares away, so the order of
// a and b does not matter. Six conversions between float32 and float64 a
// distance, at 16 a clock on each SM, are its slowest part.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float squared_distance(float ax, float ay, float az,
                                                  float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  const float p = __fmul_rn(dx, dx);
  const float q = __double2float_rn(__fma_rn((double)dy, (double)dy, (double)p));
  return __double2float_rn(__fma_rn((double)dz, (double)dz, (double)q));
}
