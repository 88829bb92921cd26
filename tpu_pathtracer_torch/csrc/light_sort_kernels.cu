// Hand-written Hopper (sm_90a) kernels of the many-light pdf and the
// "target" wavefront sort key.
//
// Built by tpu_pathtracer_torch/kernels.py with the same flags as
// chunk_kernels.cu (-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false)
// into its own shared library with a plain C interface, called through
// ctypes on PyTorch's current stream.  --fmad=false keeps every Woop and slab
// expression rounded op for op like the plain-torch twins in
// ops/chunk_intersect.py.  Each C entry returns cudaGetLastError() of its
// launch.
//
// ---------------------------------------------------------------------------
// B3  light_pdf_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:1493
//   (_kernel_light_pdf_items, via light_pdf_sum_chunks :1545).
//   All-hits light pdf over the pierced light clusters: for each ray, the sum
//   over every light of every cluster in its tile's worklist of
//   t^2 |d|^2 k / |q2| where the Woop test passes and t >= min_dst.
//   Bound on the H100: ALU (~45 float ops and two divides per (ray, light)
//   pair; the inputs per cluster are a 6.6 KB block read by 128 rays).
//   The Pallas grid walked (tile, cluster) items in order with one resident
//   [RT, 1] sum per tile, seeded from the previous SMEM window (sum0) and
//   patched for unvisited tiles; blocks here run in no order, so each block
//   owns a 128-ray slice of one tile (512 blocks at 65,536 rays), walks its
//   tile's worklist itself, stages each cluster's [12, 128] Woop block and
//   k[128] in shared memory, and each thread keeps its ray's sum in a
//   register and writes it once: no seeding, no patch, no atomics, so the
//   result is the same from run to run.
//
// B4  nearest_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:1673 (_nearest_kernel,
//   via nearest_box_ids :1714).
//   Per ray, the id of the group AABB with the smallest slab entry distance
//   max(t_enter, min_dst); first minimum wins, -1 when no box is entered.
//   Bound on the H100: ALU (~25 float ops per (ray, box) pair; the boxes are
//   24 bytes each and shared by every ray).  Design: one thread per ray with
//   (o, 1/d) and the running (best entry, id) in registers; the boxes are
//   staged through shared memory 512 at a time and read as broadcasts.  A
//   strict < over boxes in id order gives the first minimum, which is what
//   the Pallas kernel's per-block argmin plus strict < across blocks gives.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPdfThreads = 128;     // rays per light-pdf block (a tile slice)
constexpr int kNearThreads = 256;    // rays per nearest-box block
constexpr int kNearStage = 512;      // boxes staged in shared memory at once

// jnp.minimum / torch.minimum semantics: a NaN operand gives NaN, so the
// NaN boxes of padding groups never pass the slab test.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void light_pdf_kernel(
    const float* __restrict__ rays,          // [R, 8] (o, 1, d, 0)
    const float* __restrict__ cluster_woop,  // [C, 12, cw]
    const float* __restrict__ cluster_k,     // [C, cw]
    const int32_t* __restrict__ idx,         // [T, cap]
    const int32_t* __restrict__ counts,      // [T]
    int cap, int cw, int ray_tile, float min_dst,
    float* __restrict__ out) {               // [R]
  extern __shared__ float sm[];  // [12][cw] Woop block, then k[cw]
  float* w = sm;
  float* k = sm + 12 * cw;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int tile = (int)(((size_t)blockIdx.x * blockDim.x) / ray_tile);
  const float* ray = rays + i * 8;
  const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
  const float d0 = ray[4], d1 = ray[5], d2 = ray[6];
  const float dd = (d0 * d0 + d1 * d1) + d2 * d2;
  float acc = 0.0f;
  const int n = counts[tile];
  for (int s = 0; s < n; ++s) {
    const int c = idx[(size_t)tile * cap + s];
    __syncthreads();  // previous cluster's readers are done
    const float* src = cluster_woop + (size_t)c * 12 * cw;
    for (int e = threadIdx.x; e < 12 * cw; e += blockDim.x) w[e] = src[e];
    for (int e = threadIdx.x; e < cw; e += blockDim.x) k[e] = cluster_k[(size_t)c * cw + e];
    __syncthreads();
    float csum = 0.0f;
    for (int j = 0; j < cw; ++j) {
      float p0 = o0 * w[0 * cw + j] + w[3 * cw + j];
      p0 = p0 + o1 * w[1 * cw + j];
      p0 = p0 + o2 * w[2 * cw + j];
      float p1 = o0 * w[4 * cw + j] + w[7 * cw + j];
      p1 = p1 + o1 * w[5 * cw + j];
      p1 = p1 + o2 * w[6 * cw + j];
      float p2 = o0 * w[8 * cw + j] + w[11 * cw + j];
      p2 = p2 + o1 * w[9 * cw + j];
      p2 = p2 + o2 * w[10 * cw + j];
      float q0 = d0 * w[0 * cw + j];
      q0 = q0 + d1 * w[1 * cw + j];
      q0 = q0 + d2 * w[2 * cw + j];
      float q1 = d0 * w[4 * cw + j];
      q1 = q1 + d1 * w[5 * cw + j];
      q1 = q1 + d2 * w[6 * cw + j];
      float q2 = d0 * w[8 * cw + j];
      q2 = q2 + d1 * w[9 * cw + j];
      q2 = q2 + d2 * w[10 * cw + j];
      const float t = -p2 / q2;
      const float beta = p0 + t * q0;
      const float gamma = p1 + t * q1;
      if (beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f && t >= min_dst) {
        csum = csum + t * t * dd * k[j] / fabsf(q2);
      }
    }
    acc = acc + csum;
  }
  out[i] = acc;
}

__global__ void nearest_kernel(
    const float* __restrict__ rays,   // [R, 8]
    const float* __restrict__ bmin,   // [G, 3]
    const float* __restrict__ bmax,   // [G, 3]
    int n_rays, int n_boxes, float min_dst,
    float* __restrict__ t_out,        // [R]
    int32_t* __restrict__ id_out) {   // [R]
  __shared__ float box[kNearStage * 6];  // lo xyz, hi xyz per box
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  float o[3] = {0.0f, 0.0f, 0.0f};
  float inv[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    for (int a = 0; a < 3; ++a) {
      o[a] = rays[(size_t)i * 8 + a];
      const float d = rays[(size_t)i * 8 + 4 + a];
      inv[a] = 1.0f / (d == 0.0f ? 1e-30f : d);
    }
  }
  float best = INFINITY;
  int32_t arg = -1;
  for (int g0 = 0; g0 < n_boxes; g0 += kNearStage) {
    const int n = min(kNearStage, n_boxes - g0);
    __syncthreads();  // previous stage's readers are done
    for (int e = threadIdx.x; e < n * 3; e += blockDim.x) {
      const int g = e / 3, a = e % 3;
      box[g * 6 + a] = bmin[(size_t)g0 * 3 + e];
      box[g * 6 + 3 + a] = bmax[(size_t)g0 * 3 + e];
    }
    __syncthreads();
    if (!live) continue;
    for (int g = 0; g < n; ++g) {
      const float* b = box + g * 6;
      float t1 = (b[0] - o[0]) * inv[0];
      float t2 = (b[3] - o[0]) * inv[0];
      float t_lo = nan_min(t1, t2);
      float t_hi = nan_max(t1, t2);
      t1 = (b[1] - o[1]) * inv[1];
      t2 = (b[4] - o[1]) * inv[1];
      t_lo = nan_max(t_lo, nan_min(t1, t2));
      t_hi = nan_min(t_hi, nan_max(t1, t2));
      t1 = (b[2] - o[2]) * inv[2];
      t2 = (b[5] - o[2]) * inv[2];
      t_lo = nan_max(t_lo, nan_min(t1, t2));
      t_hi = nan_min(t_hi, nan_max(t1, t2));
      if (t_lo <= t_hi && t_hi >= min_dst) {
        const float e = t_lo > min_dst ? t_lo : min_dst;
        if (e < best) {
          best = e;
          arg = g0 + g;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best;
    id_out[i] = arg;
  }
}

}  // namespace

extern "C" int tpt_light_pdf(
    const void* rays, const void* cluster_woop, const void* cluster_k,
    const void* idx, const void* counts, int n_rays, int cap, int cw,
    int ray_tile, float min_dst, void* out, void* stream) {
  const size_t smem = (size_t)13 * cw * sizeof(float);
  light_pdf_kernel<<<n_rays / kPdfThreads, kPdfThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)cluster_woop, (const float*)cluster_k,
      (const int32_t*)idx, (const int32_t*)counts, cap, cw, ray_tile, min_dst,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_nearest(
    const void* rays, const void* bmin, const void* bmax, int n_rays,
    int n_boxes, float min_dst, void* t_out, void* id_out, void* stream) {
  const int blocks = (n_rays + kNearThreads - 1) / kNearThreads;
  nearest_kernel<<<blocks, kNearThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)bmin, (const float*)bmax, n_rays,
      n_boxes, min_dst, (float*)t_out, (int32_t*)id_out);
  return (int)cudaGetLastError();
}
