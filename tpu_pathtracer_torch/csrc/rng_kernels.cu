// Hand-written Hopper (sm_90a) kernel of the counter-based threefry draws.
//
// Built by tpu_pathtracer_torch/kernels.py like the other kernel libraries
// (nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false, a plain C
// interface called through ctypes on PyTorch's current stream).
//
// ---------------------------------------------------------------------------
// uniforms_kernel
//   Replaces no TPU kernel: the JAX package leaves ops/rng.py's
//   lane_uniforms (tpu_pathtracer/ops/rng.py) to XLA, which fuses the
//   integer threefry into the elementwise program around it.  The eager
//   PyTorch twin (tpu_pathtracer_torch/ops/rng.py: lane_uniforms_key_plain)
//   runs the u32 arithmetic in int64 with a mask after every add and shift:
//   ~770 device operations a render iteration, 43% of the loop's launches.
//   What it computes, per lane i of R: the stage key
//     (a0, a1) = threefry2x32((k0, k1), (sample[i], depth[i]))
//   then for every counter block b < ceil(n_draws / 2)
//     (x0, x1) = threefry2x32((a0, a1), (pixel[i], b))
//   and out[2b][i], out[2b + 1][i] = the top 23 bits of x0, x1 as a float
//   in [1, 2) minus 1.  Integer arithmetic is exact and the last subtraction
//   is exact, so the output equals the twin bit for bit.
//   Inputs: sample, depth and pixel are each the u32 sum of an optional
//   [R] int32 array, an optional int64 device scalar and a constant; the
//   key words are device scalars or constants.  The traced values of a
//   render (the seed's key words, the first sample, the pool's first pixel)
//   come through device pointers, never as launch arguments, so a CUDA
//   graph that captured the launch serves every seed, pass and chunk.
//   Bound on the H100: integer operations.  A counter block is 71 32-bit
//   integer operations (20 rounds of add, rotate and xor, five key
//   injections of two adds, x1's first add: the key, its parity word, the
//   injections' key-plus-constant words and x0's first add are the same in
//   every block of a lane), the stage-key block 72, and a draw a shift and
//   an or, at 64 INT32 lanes per clock per SM, plus a float32 subtract a
//   draw: the 10 draws of 65,536 lanes are ~29 M integer operations,
//   ~1.75 us at 1.98 GHz, against 3.4 MB read and written (~1.0 us at
//   3.35 TB/s).
//   Design: one thread per lane, everything in registers, stores coalesced
//   along the lane axis (one [R] row per draw).  Nothing to stage: the
//   kernel reads 12 bytes a lane and writes 4 a draw.
// ---------------------------------------------------------------------------

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (the twin's ops/rng.py:tf2x32).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// One input of the stream: array[i] (if any) + *scalar (if any) + constant.
__device__ __forceinline__ uint32_t word(const int32_t* array, const long long* scalar,
                                         uint32_t constant, int i) {
  uint32_t v = constant;
  if (array != nullptr) v += (uint32_t)array[i];
  if (scalar != nullptr) v += (uint32_t)(unsigned long long)*scalar;
  return v;
}

__global__ void __launch_bounds__(kThreads) uniforms_kernel(
    const long long* k0_p, const long long* k1_p, uint32_t k0_c, uint32_t k1_c,
    const int32_t* sample, const long long* sample_s, uint32_t sample_c,
    const int32_t* depth, const long long* depth_s, uint32_t depth_c,
    const int32_t* pixel, const long long* pixel_s, uint32_t pixel_c,
    int n_rays, int n_draws, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const uint32_t k0 = word(nullptr, k0_p, k0_c, 0);
  const uint32_t k1 = word(nullptr, k1_p, k1_c, 0);
  uint32_t a0, a1;
  threefry(k0, k1, word(sample, sample_s, sample_c, i), word(depth, depth_s, depth_c, i), a0, a1);
  const uint32_t p = word(pixel, pixel_s, pixel_c, i);
  for (int b = 0; 2 * b < n_draws; ++b) {
    uint32_t x0, x1;
    threefry(a0, a1, p, (uint32_t)b, x0, x1);
    out[(size_t)(2 * b) * n_rays + i] = bits_to_unit(x0);
    if (2 * b + 1 < n_draws) out[(size_t)(2 * b + 1) * n_rays + i] = bits_to_unit(x1);
  }
}

}  // namespace

extern "C" int tpt_uniforms(
    const void* k0_p, const void* k1_p, unsigned k0_c, unsigned k1_c,
    const void* sample, const void* sample_s, unsigned sample_c,
    const void* depth, const void* depth_s, unsigned depth_c,
    const void* pixel, const void* pixel_s, unsigned pixel_c,
    int n_rays, int n_draws, void* out, void* stream) {
  if (n_rays > 0 && n_draws > 0) {
    uniforms_kernel<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)k0_p, (const long long*)k1_p, k0_c, k1_c, (const int32_t*)sample,
        (const long long*)sample_s, sample_c, (const int32_t*)depth, (const long long*)depth_s,
        depth_c, (const int32_t*)pixel, (const long long*)pixel_s, pixel_c, n_rays, n_draws,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
