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
//   runs the u32 arithmetic in int64 with a mask after every add and shift.
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
//   render (the seed, the first sample, the pool's first pixel) come
//   through device pointers, never as launch arguments, so a CUDA graph
//   that captured the launch serves every seed, pass and chunk, and the
//   render passes its carries and those scalars apart: one launch is the
//   whole of a draws call, with no sum or cast around it.
//   Bound on the H100: the bytes, with the ALU pipe close behind.  Each of
//   an SM's four schedulers dispatches one warp instruction a clock; the
//   ALU pipe (IADD3, LOP3, SHF, LEA) and the FMA pipe (IMAD in every form,
//   FADD) each take 16 lanes a clock of it, 64 a clock an SM.  A threefry
//   round is an add, a rotate (SHF) and a xor (LOP3); the rotate and the
//   xor have no form off the ALU pipe, the add has one.  ptxas alone puts
//   about two adds in three on the FMA pipe (IMAD.IADD) and the rest on the
//   ALU pipe (IADD3, which can fuse two); written as x1 * one + x0, with a
//   multiplier the compiler cannot see is 1, every round's add is an IMAD,
//   and 65,536 lanes take ~5% less time.  What must stay on the ALU pipe is
//   252 instructions a lane of 10 draws (120 rotates, 122 xors with the two
//   parity words, 10 shift-ors); the adds fit beside the 10 subtracts on
//   the FMA pipe, so 65,536 lanes need ~0.99 us there, under the ~1.02 us
//   that their 3.4 MB take at 3.35 TB/s (chip_smoke.rng_lane_ops).  Moving
//   the key injections too (more IMADs than the IADD3s they replace) or a
//   draw's shift and or (one LEA.HI; an IMAD.HI and an IMAD instead)
//   measured no faster at 65,536 lanes, nor did rotating by an IMAD.WIDE
//   (PERF.md has the counts and the times).
//   What costs more than the bound is the launch: timed back to back, a
//   launch costs ~2 us whatever its lane count (an empty one ~1.8 us), and
//   65,536 lanes add ~1.6 us of work at ~62% of the ALU pipe's rate
//   (~64% of the memory's).
//   Design: one thread a lane, everything in registers, stores coalesced
//   along the lane axis (one [R] row per draw).  The counts of draws the
//   port launches (10 bounce draws, 2 jitter draws, 4 homebrew bounce
//   draws) are template instances: their counter blocks unroll, so the
//   blocks of a lane, independent once its stage key is known, interleave
//   as independent chains (a one-lane launch of 10 draws ~2.7 us against
//   ~3.1 us for the loop; at 65,536 lanes the 4 draws ~2.97 us against
//   ~3.17 and the 2 draws ~2.86 against ~2.96 for the loop); any other
//   count runs the generic instance of the same kernel, a loop on the
//   runtime count.  65,536 lanes are 2,048 warps, at most 16 on each of
//   132 SMs whatever the block shape, which 256-thread blocks already give
//   (128 and 512 measured no faster): the grid needs no device query.
// ---------------------------------------------------------------------------

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

// The rotation of round j of group i (Random123's R_32x2).
__device__ __forceinline__ constexpr int rotation(int i, int j) {
  return (i % 2) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// One input word of the stream: array[i] (if any) + *scalar (if any) +
// constant.
struct Word {
  const int32_t* array;
  const long long* scalar;
  uint32_t constant;
};

struct Stream {
  Word k0, k1, sample, depth, pixel;
};

// The part of a word that is the same on every lane: scalar + constant.
__device__ __forceinline__ uint32_t lane_base(const Word& w) {
  uint32_t v = w.constant;
  if (w.scalar != nullptr) v += (uint32_t)(unsigned long long)*w.scalar;
  return v;
}

__device__ __forceinline__ uint32_t at(const Word& w, uint32_t base, int i) {
  return w.array != nullptr ? base + (uint32_t)w.array[i] : base;
}

// Threefry-2x32, 20 rounds (the twin's ops/rng.py:tf2x32), under a key
// whose injection words are precomputed: ks = (k0, k1, k0 ^ k1 ^ parity).
// ``one`` is 1, from a launch argument, so that each round's x1 * one + x0
// stays an IMAD on the FMA pipe.
__device__ __forceinline__ void threefry(const uint32_t (&ks)[3], uint32_t c0, uint32_t c1,
                                         uint32_t one, uint32_t& y0, uint32_t& y1) {
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 = x1 * one + x0;
      x1 = __funnelshift_l(x1, x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Counter block b of a lane: draws 2b and 2b + 1 (the latter if < draws).
__device__ __forceinline__ void counter_block(const uint32_t (&ks)[3], uint32_t p, int b,
                                              int draws, int n_rays, int i, uint32_t one,
                                              float* __restrict__ out) {
  uint32_t x0, x1;
  threefry(ks, p, (uint32_t)b, one, x0, x1);
  out[(size_t)(2 * b) * n_rays + i] = bits_to_unit(x0);
  if (2 * b + 1 < draws) out[(size_t)(2 * b + 1) * n_rays + i] = bits_to_unit(x1);
}

// kDraws > 0: an instance for that many draws (n_draws is kDraws); 0: the
// generic instance, a loop over ceil(n_draws / 2) counter blocks.
template <int kDraws>
__global__ void __launch_bounds__(kThreads) uniforms_kernel(const Stream s, int n_rays,
                                                            int n_draws, uint32_t one,
                                                            float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const uint32_t k0 = lane_base(s.k0), k1 = lane_base(s.k1);
  const uint32_t key[3] = {k0, k1, k0 ^ k1 ^ kParity};
  uint32_t a0, a1;
  threefry(key, at(s.sample, lane_base(s.sample), i), at(s.depth, lane_base(s.depth), i), one,
           a0, a1);
  const uint32_t stage[3] = {a0, a1, a0 ^ a1 ^ kParity};
  const uint32_t p = at(s.pixel, lane_base(s.pixel), i);
  if constexpr (kDraws > 0) {
#pragma unroll
    for (int b = 0; b < (kDraws + 1) / 2; ++b)
      counter_block(stage, p, b, kDraws, n_rays, i, one, out);
  } else {
#pragma unroll 1
    for (int b = 0; 2 * b < n_draws; ++b)
      counter_block(stage, p, b, n_draws, n_rays, i, one, out);
  }
}

template <int kDraws>
cudaError_t launch(const Stream& s, int n_rays, int n_draws, float* out, cudaStream_t stream) {
  uniforms_kernel<kDraws><<<(n_rays + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      s, n_rays, n_draws, 1u, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpt_uniforms(
    const void* k0_p, const void* k1_p, unsigned k0_c, unsigned k1_c,
    const void* sample, const void* sample_s, unsigned sample_c,
    const void* depth, const void* depth_s, unsigned depth_c,
    const void* pixel, const void* pixel_s, unsigned pixel_c,
    int n_rays, int n_draws, void* out, void* stream) {
  if (n_rays <= 0 || n_draws <= 0) return (int)cudaGetLastError();
  const Stream s{
      {nullptr, (const long long*)k0_p, k0_c},
      {nullptr, (const long long*)k1_p, k1_c},
      {(const int32_t*)sample, (const long long*)sample_s, sample_c},
      {(const int32_t*)depth, (const long long*)depth_s, depth_c},
      {(const int32_t*)pixel, (const long long*)pixel_s, pixel_c},
  };
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_draws) {
    case 10: return (int)launch<10>(s, n_rays, n_draws, o, st);  // the bounce draws
    case 4: return (int)launch<4>(s, n_rays, n_draws, o, st);    // the homebrew bounces
    case 2: return (int)launch<2>(s, n_rays, n_draws, o, st);    // the camera jitter
    default: return (int)launch<0>(s, n_rays, n_draws, o, st);
  }
}
