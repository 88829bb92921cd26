// Pieces shared by the Hopper (sm_90a) kernels that walk Woop blocks: the
// ordering key of a ray's candidates, asynchronous staging of a block into
// shared memory by one bulk copy (cp.async.bulk, the Tensor Memory
// Accelerator's 1D form) completed on an mbarrier, and the Woop test of one
// (ray, triangle) pair on the triangle-major layout (three float4 per
// triangle: the rows 4c..4c+3 of barycentric component c).
//
// Included by chunk_kernels.cu (B2), light_sort_kernels.cu (B3) and
// mode_kernels.cu (B5's key, B6); the build hashes it with each source.
// Every expression rounds op for op like the plain-torch twins of
// ops/chunk_intersect.py under --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises each barrier with the arrivals that complete a
// phase (one for a barrier that only the copy's starter arrives on), then
// the block synchronises.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// (the block's reads of a stage, made visible by __syncthreads) before the
// bulk copy that overwrites the stage.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion counts down the barrier's bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One arrival without bytes (release: the thread's earlier reads and writes
// of shared memory are ordered before it).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Block until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// mbar_wait for a kernel whose barriers are arrived on by other warps of the
// block (B6's producer and consumers): a phase still open after 2^26 polls
// (more than half a second; a wait in a correct run ends within a slot's
// time, microseconds) is a fault in the protocol, and the kernel traps (the
// launch fails) instead of hanging the card.  The loop is PTX like
// mbar_wait's: written in C++ it cost B6 2-3%.  B2 and B3, where the waiting
// block's own thread started the copy, keep the bare loop: B2 ran 2% slower
// with this one (47 registers against 45, another schedule of its pair loop).
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      ".reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.eq.u32 P1, polls, 0x4000000;\n"
      "@P1 trap;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The 64-bit key B2, B5 and B6 order a ray's candidates by: the float bits
// of t (t >= min_dst > 0, so the bits order like the floats) above a 32-bit
// order index; the minimum key is the first minimum in that order.
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float t, unsigned int low) {
  return ((unsigned long long)__float_as_uint(t) << 32) | low;
}

__device__ __forceinline__ float key_time(unsigned long long key) {
  return __uint_as_float((unsigned int)(key >> 32));
}

// The final pass of B2 and B6 for ray i: the lexicographic minimum of (t,
// triangle id) between its minimum key and (tmin0, tidx0).
__device__ __forceinline__ void decode_tri_key(
    unsigned long long key, int i, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  if (key != kNoKey && key < make_key(tmin0[i], (unsigned int)tidx0[i])) {
    t_out[i] = key_time(key);
    tri_out[i] = (int32_t)(key & 0xFFFFFFFFu);
  } else {
    t_out[i] = tmin0[i];
    tri_out[i] = tidx0[i];
  }
}

// Woop test of the ray (o, d) against one triangle given as its three rows
// a = (w0..w3), b = (w4..w7), c = (w8..w11), in the operation order of
// _contract_o / _contract_d: p = ((o0*w0 + w3) + o1*w1) + o2*w2, q = (d0*w0
// + d1*w1) + d2*w2.  Returns whether the hit is valid (barycentrics inside,
// t >= min_dst), with t = -p2 / q2 and q2 in the out-parameters.
__device__ __forceinline__ bool woop_hit(const float4 a, const float4 b, const float4 c,
                                         float o0, float o1, float o2, float d0, float d1,
                                         float d2, float min_dst, float* t, float* q2) {
  float p0 = o0 * a.x + a.w;
  p0 = p0 + o1 * a.y;
  p0 = p0 + o2 * a.z;
  float p1 = o0 * b.x + b.w;
  p1 = p1 + o1 * b.y;
  p1 = p1 + o2 * b.z;
  float p2 = o0 * c.x + c.w;
  p2 = p2 + o1 * c.y;
  p2 = p2 + o2 * c.z;
  float q0 = d0 * a.x;
  q0 = q0 + d1 * a.y;
  q0 = q0 + d2 * a.z;
  float q1 = d0 * b.x;
  q1 = q1 + d1 * b.y;
  q1 = q1 + d2 * b.z;
  float qn = d0 * c.x;
  qn = qn + d1 * c.y;
  qn = qn + d2 * c.z;
  const float tt = -p2 / qn;
  const float beta = p0 + tt * q0;
  const float gamma = p1 + tt * q1;
  *t = tt;
  *q2 = qn;
  return beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f && tt >= min_dst;
}

}  // namespace tpt
