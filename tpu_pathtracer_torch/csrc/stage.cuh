// Pieces shared by the Hopper (sm_90a) kernels that walk Woop blocks:
// asynchronous staging of a block into shared memory by one bulk copy
// (cp.async.bulk, the Tensor Memory Accelerator's 1D form) completed on an
// mbarrier, and the Woop test of one (ray, triangle) pair on the
// triangle-major layout (three float4 per triangle: the rows 4c..4c+3 of
// barycentric component c).
//
// Included by chunk_kernels.cu (B2) and light_sort_kernels.cu (B3); the
// build hashes it with each source.  Every expression rounds op for op like
// the plain-torch twins of ops/chunk_intersect.py under --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises each barrier with one arrival (the thread that
// issues the copy), then the block synchronises.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
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
