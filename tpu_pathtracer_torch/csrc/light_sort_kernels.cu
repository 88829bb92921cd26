// Hand-written Hopper (sm_90a) kernels of the many-light pdf and the
// "target" wavefront sort key.
//
// Built by tpu_pathtracer_torch/kernels.py with the same flags as
// chunk_kernels.cu (-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false)
// into its own shared library with a plain C interface, called through
// ctypes on PyTorch's current stream.  --fmad=false keeps every Woop and slab
// expression rounded op for op like the plain-torch twins in
// ops/chunk_intersect.py.  Each C entry returns the first CUDA error of
// its launches (0 when none).
//
// ---------------------------------------------------------------------------
// B3  light_pdf_kernel (+ light_pdf_sum_kernel)
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:1493
//   (_kernel_light_pdf_items, via light_pdf_sum_chunks :1545).
//   All-hits light pdf over the pierced light clusters: for each ray, the sum
//   over every light of every cluster in its tile's worklist of
//   t^2 |d|^2 k / |q2| where the Woop test passes and t >= min_dst.
//   Bound on the H100: ALU (~65 lane ops and two divides per (ray, light)
//   pair that is tested, ~30 per (ray, cluster) box test).  The worklist is
//   per tile, but a ray enters few of the boxes its tile's rays enter, and
//   a light whose Woop test passes lies in its cluster's box: so each ray
//   is first slab-tested against the boxes (grown by BOX_SLACK, no far
//   bound: the pdf sums every hit), and only the pairs whose ray enters
//   the box are Woop-tested.  Design: a tile's worklist is cut into
//   segments of ``seg`` clusters, and each block owns one (128-ray slice,
//   segment): the longest tile no longer sets the time, and the blocks of
//   every tile spread over the SMs.  Each thread slab-tests its ray against
//   the segment's boxes, one ballot a cluster; a cluster no ray of the
//   block enters is never staged.  The entered clusters are staged
//   triangle-major (three float4 of Woop rows per light) with k[128] beside
//   them, each by one cp.async.bulk (TMA) into a two-stage ring completed on
//   an mbarrier, so the next one is in flight while the current one is
//   walked.  For each staged cluster the rays that enter it are compacted
//   into a list (ballot and popc prefix), and the list is walked one warp a
//   ray: lane l tests lights l, l+32, ... in order, and a fixed xor-shuffle
//   tree adds the lanes' sums.  A ray adds its clusters' sums in worklist
//   order and writes the segment's partial sum to scratch [n_seg, R]; a
//   second pass adds a ray's partial sums in segment order.  No float
//   atomics: the result is the same from run to run.  The Woop arithmetic
//   is the twin's op for op, so the set of lights a ray passes is the same;
//   only the order of the sum differs.  Given a work counter, one thread a
//   block adds the segment's (ray, cluster) pairs (tile level) and those
//   whose ray enters the box, by integer atomics.  No tensor cores, for
//   B2's reason (chunk_kernels.cu).
//
// B4  nearest_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:1673 (_nearest_kernel,
//   via nearest_box_ids :1714).
//   Per ray, the id of the group AABB with the smallest slab entry distance
//   max(t_enter, min_dst); first minimum wins, -1 when no box is entered.
//   Bound on the H100: ALU (~30 lane operations per (ray, box) pair with the
//   one-instruction NaN-propagating min/max of slab.cuh; the boxes are 24
//   bytes each and shared by every ray).  The entry written out is clamped
//   to min_dst by a select, so the sign of a zero never reaches t_out.  Design: one thread per ray with
//   (o, 1/d) and the running (best entry, id) in registers; the boxes are
//   staged through shared memory 512 at a time and read as broadcasts.  A
//   strict < over boxes in id order gives the first minimum, which is what
//   the Pallas kernel's per-block argmin plus strict < across blocks gives.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slab.cuh"
#include "stage.cuh"

namespace {

constexpr int kPdfThreads = 128;     // rays per light-pdf block (a tile slice)
constexpr int kPdfWarps = kPdfThreads / 32;
constexpr int kPdfMaxSeg = 32;       // clusters per segment: one bit each of a ray's mask
constexpr int kPdfStages = 2;        // B3's ring of staged clusters
constexpr int kStageAlign = 128;     // bytes before the ring (the barriers)
constexpr int kSumThreads = 256;     // rays per segment-sum block
constexpr int kNearThreads = 256;    // rays per nearest-box block
constexpr int kNearStage = 512;      // boxes staged in shared memory at once
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kPdfThreads) light_pdf_kernel(
    const float* __restrict__ rays,          // [R, 8] (o, 1, d, 0)
    const float4* __restrict__ woop_t,       // [C, cw, 3] triangle-major Woop rows
    const float* __restrict__ cluster_k,     // [C, cw]
    const float* __restrict__ box_lo,        // [C, 3] grown cluster boxes
    const float* __restrict__ box_hi,        // [C, 3]
    const int32_t* __restrict__ idx,         // [T, cap]
    const int32_t* __restrict__ counts,      // [T]
    int n_rays, int cap, int cw, int ray_tile, int seg, float min_dst,
    float* __restrict__ partial,             // [n_seg, R]
    unsigned long long* __restrict__ work) { // [2] (pairs, entered pairs) or null
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);                      // [kPdfStages]
  float4* wring = reinterpret_cast<float4*>(smem + kStageAlign);          // [kPdfStages][cw * 3]
  float* kring = reinterpret_cast<float*>(wring + (size_t)kPdfStages * cw * 3);  // [kPdfStages][cw]
  __shared__ float4 s_ray[kPdfThreads][2];          // (o, |d|^2), (d, 0) of each thread's ray
  __shared__ uint32_t s_ball[kPdfMaxSeg][kPdfWarps];  // who enters each cluster, a word a warp
  __shared__ unsigned char s_list[kPdfThreads];    // the staged cluster's entering rays, compacted
  __shared__ float s_sum[kPdfThreads];             // their sums over the cluster
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int tile = (int)(((size_t)blockIdx.x * blockDim.x) / ray_tile);
  const int s0 = blockIdx.y * seg;
  const int n = min(seg, counts[tile] - s0);
  if (n <= 0) return;  // uniform over the block; the sum pass reads no such segment
  const uint32_t w_bytes = (uint32_t)cw * 3 * sizeof(float4);
  const uint32_t k_bytes = (uint32_t)cw * sizeof(float);
  const int32_t* list = idx + (size_t)tile * cap + s0;

  auto issue = [&](int c, int stage) {  // thread 0: stage cluster c
    tpt::mbar_expect_tx(&bar[stage], w_bytes + k_bytes);
    tpt::bulk_load(wring + (size_t)stage * cw * 3, woop_t + (size_t)c * cw * 3, w_bytes,
                   &bar[stage]);
    tpt::bulk_load(kring + (size_t)stage * cw, cluster_k + (size_t)c * cw, k_bytes, &bar[stage]);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kPdfStages; ++k) tpt::mbar_init(&bar[k]);
    tpt::mbar_init_fence();
  }

  const float* ray = rays + i * 8;
  const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
  const float d0 = ray[4], d1 = ray[5], d2 = ray[6];
  const float dd = (d0 * d0 + d1 * d1) + d2 * d2;
  s_ray[threadIdx.x][0] = make_float4(o0, o1, o2, dd);
  s_ray[threadIdx.x][1] = make_float4(d0, d1, d2, 0.0f);
  const float i0 = tpt::inv_dir(d0), i1 = tpt::inv_dir(d1), i2 = tpt::inv_dir(d2);
  uint32_t mask = 0;  // bit j: this ray enters the box of the segment's cluster j
  for (int j = 0; j < n; ++j) {
    const float* lo = box_lo + (size_t)list[j] * 3;
    const float* hi = box_hi + (size_t)list[j] * 3;
    float t_lo, t_hi;
    tpt::slab_interval(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], o0, o1, o2, i0, i1, i2, &t_lo,
                       &t_hi);
    const bool in = t_lo <= t_hi && t_hi >= min_dst;
    const uint32_t b = __ballot_sync(kFull, in);
    if (lane == 0) s_ball[j][warp] = b;
    mask |= (uint32_t)in << j;
  }
  __syncthreads();  // the ballots, the rays and the barriers are in place

  uint32_t staged = 0;  // bit j: some ray of the block enters cluster j
  int entered = 0;
  for (int j = 0; j < n; ++j) {
    int m = 0;
    for (int w = 0; w < kPdfWarps; ++w) m += __popc(s_ball[j][w]);
    staged |= (uint32_t)(m > 0) << j;
    entered += m;
  }
  if (work != nullptr && threadIdx.x == 0) {
    atomicAdd(work, (unsigned long long)n * kPdfThreads);
    if (entered > 0) atomicAdd(work + 1, (unsigned long long)entered);
  }
  float acc = 0.0f;
  if (staged != 0 && threadIdx.x == 0) issue(list[__ffs(staged) - 1], 0);
  int q = 0;  // staged clusters walked so far: the ring's position
  for (uint32_t rest = staged; rest != 0; rest &= rest - 1, ++q) {
    const int j = __ffs(rest) - 1;
    const uint32_t next = rest & (rest - 1);
    if (next != 0 && threadIdx.x == 0) {
      tpt::fence_proxy_async();  // the stage's last readers passed __syncthreads
      issue(list[__ffs(next) - 1], (q + 1) % kPdfStages);
    }
    int before = 0, m = 0;
    for (int w = 0; w < kPdfWarps; ++w) {
      const int p = __popc(s_ball[j][w]);
      before += w < warp ? p : 0;
      m += p;
    }
    const bool in = (mask >> j) & 1u;
    const int pos = before + __popc(s_ball[j][warp] & ((1u << lane) - 1u));
    if (in) s_list[pos] = (unsigned char)threadIdx.x;
    __syncthreads();  // the list is complete
    tpt::mbar_wait(&bar[q % kPdfStages], (q / kPdfStages) & 1);
    const float4* w = wring + (size_t)(q % kPdfStages) * cw * 3;
    const float* k = kring + (size_t)(q % kPdfStages) * cw;
    for (int p = warp; p < m; p += kPdfWarps) {
      const int r = s_list[p];
      const float4 ro = s_ray[r][0], rd = s_ray[r][1];
      float part = 0.0f;
      for (int l = lane; l < cw; l += 32) {
        float t, q2;
        if (tpt::woop_hit(w[3 * l], w[3 * l + 1], w[3 * l + 2], ro.x, ro.y, ro.z, rd.x, rd.y,
                          rd.z, min_dst, &t, &q2)) {
          part = part + t * t * ro.w * k[l] / fabsf(q2);
        }
      }
      for (int s = 16; s > 0; s >>= 1) part = part + __shfl_xor_sync(kFull, part, s);
      if (lane == 0) s_sum[p] = part;
    }
    __syncthreads();  // the sums are in place; every reader of this stage is done
    if (in) acc = acc + s_sum[pos];
  }
  partial[(size_t)blockIdx.y * n_rays + i] = acc;
}

__global__ void light_pdf_sum_kernel(
    const float* __restrict__ partial,  // [n_seg, R]
    const int32_t* __restrict__ counts,  // [T]
    int n_rays, int ray_tile, int seg,
    float* __restrict__ out) {           // [R]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const int n_seg = (counts[i / ray_tile] + seg - 1) / seg;
  float acc = 0.0f;
  for (int s = 0; s < n_seg; ++s) acc = acc + partial[(size_t)s * n_rays + i];
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
      inv[a] = tpt::inv_dir(rays[(size_t)i * 8 + 4 + a]);
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
      float t_lo, t_hi;
      tpt::slab_interval(b[0], b[1], b[2], b[3], b[4], b[5], o[0], o[1], o[2], inv[0], inv[1],
                         inv[2], &t_lo, &t_hi);
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
    const void* rays, const void* woop_t, const void* cluster_k, const void* box_lo,
    const void* box_hi, const void* idx, const void* counts, int n_rays, int cap, int cw,
    int ray_tile, int seg, float min_dst, void* partial, void* out, void* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (seg < 1 || seg > kPdfMaxSeg) return (int)cudaErrorInvalidValue;
  const int n_seg = (cap + seg - 1) / seg;
  const size_t smem = kStageAlign + (size_t)kPdfStages * cw * (3 * sizeof(float4) + sizeof(float));
  light_pdf_kernel<<<dim3(n_rays / kPdfThreads, n_seg), kPdfThreads, smem, st>>>(
      (const float*)rays, (const float4*)woop_t, (const float*)cluster_k, (const float*)box_lo,
      (const float*)box_hi, (const int32_t*)idx, (const int32_t*)counts, n_rays, cap, cw,
      ray_tile, seg, min_dst, (float*)partial, (unsigned long long*)work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light_pdf_sum_kernel<<<(n_rays + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(
      (const float*)partial, (const int32_t*)counts, n_rays, ray_tile, seg, (float*)out);
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
