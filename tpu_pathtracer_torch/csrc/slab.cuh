// The slab test shared by the Hopper (sm_90a) kernels that test rays against
// axis-aligned boxes: B1 (chunk_kernels.cu), B4 (light_sort_kernels.cu) and
// B7 (mode_kernels.cu).  The build hashes this header with each source.
//
// Every expression rounds op for op like ``_slab`` in
// ops/chunk_intersect.py under --fmad=false: t1 = (lo - o) * inv, t2 =
// (hi - o) * inv per axis, the interval's ends by NaN-propagating min/max in
// the order x, y, z.

#pragma once

#include <cuda_runtime.h>

namespace tpt {

// jnp.minimum / torch.minimum semantics: a NaN operand gives NaN (fminf and
// fmaxf would drop it, and NaN-padded boxes rely on propagation to fail
// every comparison).  One instruction each on sm_80 and later; a
// compare-and-select form costs three.  Where both operands are zeros of
// different sign the instruction orders -0 below +0, while
// compare-and-select returns the second operand: the kernels only compare
// the interval's ends or clamp the entry to min_dst >= 0 with a select, so
// the sign of a zero never reaches an output.
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// 1/d with a zero component taken as 1e-30, so an origin on a slab plane
// gives t = 0 instead of 0 * inf = NaN.
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// The interval [t_lo, t_hi] of the ray (o, 1/d = inv) inside the box
// [lo, hi]; NaN ends for a NaN box.
__device__ __forceinline__ void slab_interval(
    float lo0, float lo1, float lo2, float hi0, float hi1, float hi2,
    float o0, float o1, float o2, float i0, float i1, float i2,
    float* t_lo, float* t_hi) {
  float t1 = (lo0 - o0) * i0;
  float t2 = (hi0 - o0) * i0;
  float a = nan_min(t1, t2);
  float b = nan_max(t1, t2);
  t1 = (lo1 - o1) * i1;
  t2 = (hi1 - o1) * i1;
  a = nan_max(a, nan_min(t1, t2));
  b = nan_min(b, nan_max(t1, t2));
  t1 = (lo2 - o2) * i2;
  t2 = (hi2 - o2) * i2;
  *t_lo = nan_max(a, nan_min(t1, t2));
  *t_hi = nan_min(b, nan_max(t1, t2));
}

}  // namespace tpt
