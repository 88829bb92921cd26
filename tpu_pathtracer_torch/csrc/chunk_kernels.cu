// Hand-written Hopper (sm_90a) kernels of the chunk-skipping intersector.
//
// Built by tpu_pathtracer_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, called through ctypes on
// PyTorch's current stream.  --fmad=false keeps every slab and Woop
// expression rounded op for op like the plain-torch twins in
// ops/chunk_intersect.py, so m8 / ent / t / tri compare exactly on the card.
// Each C entry returns cudaGetLastError() of its launch.
//
// ---------------------------------------------------------------------------
// B1  activity_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:146 (_activity_body,
//   through _activity_kernel :137 and _activity_kernel_gated :229).
//   Per (ray tile, chunk): slab test of every ray of the tile against the
//   chunk AABB with the per-ray far bound tbest; per 64-ray sub-tile the
//   minimum entry distance; packed sub-tile bits m8, tile entry ent and,
//   when asked, the per-sub-tile entries.
//   Bound on the H100: ALU.  Each (ray, chunk) pair is ~25 float ops on
//   7 floats of ray state and 6 of box; the outputs are 8 bytes per
//   (tile, chunk).  Design: one block per (ray tile, 128 chunk columns);
//   the tile's rays (origin, reciprocal direction, tbest) are staged once in
//   shared memory and read as broadcasts, each thread owns one chunk column
//   and keeps its box in registers, so device memory traffic is one pass
//   over the rays per column block and one write per output.  The coarse
//   gate is one bit per (tile, 512-column block), uniform over a block.
//
// B2  items_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:819 (_kernel_items, with
//   _chunk_body_sub :694 and _contract_o/_contract_d :645-663).
//   Per ray tile: walk the tile's front-to-back worklist of chunk groups;
//   for every (chunk, 64-ray sub-tile) whose mask bit is set, Woop-test the
//   sub-tile's rays against the chunk's 128 triangles and keep the closest
//   hit (first minimum inside a chunk, strict < across chunks).
//   Bound on the H100: ALU (~40 float ops and one divide per pair) and
//   occupancy: the TPU grid ran items in order on one core; here blocks run
//   in parallel, so one block per tile owns its 512 output rows and no item
//   flattening, seeding or patching of unvisited tiles is needed.  Design:
//   one thread per ray keeps (o, d, best t, best tri) in registers; each
//   chunk's [12, 128] Woop block (6 KB) is staged in shared memory by the
//   whole block and read as broadcasts; sub-tiles whose bit is clear idle.
//   Later work: more tiles per SM, warp-level sub-tile scheduling.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kActCols = 512;   // chunks per coarse-gate block
constexpr int kActThreads = 128;  // chunk columns per activity block

// jnp.minimum / torch.minimum semantics: a NaN operand gives NaN (fminf and
// fmaxf would drop it, and NaN-padded boxes rely on propagation to fail).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void activity_kernel(
    const float* __restrict__ rays,       // [R, 8] (o, 1, d, 0)
    const float* __restrict__ cmin,       // [C, 3]
    const float* __restrict__ cmax,       // [C, 3]
    const float* __restrict__ tbest,      // [R] or null (= +inf)
    const int32_t* __restrict__ cbits,    // [T, nwords] or null (= all on)
    int nwords, int n_cols, int ray_tile, int n_sub, float min_dst,
    int32_t* __restrict__ m8,             // [T, C]
    float* __restrict__ ent,              // [T, C]
    float* __restrict__ sub_ent) {        // [T, n_sub, C] or null
  extern __shared__ float sm[];  // [ray_tile][7]: o xyz, 1/d xyz, tbest
  const int tile = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t base = (size_t)tile * ray_tile;
  for (int i = threadIdx.x; i < ray_tile; i += blockDim.x) {
    const float* ray = rays + (base + i) * 8;
    float* s = sm + i * 7;
    s[0] = ray[0];
    s[1] = ray[1];
    s[2] = ray[2];
    for (int a = 0; a < 3; ++a) {
      const float d = ray[4 + a];
      s[3 + a] = 1.0f / (d == 0.0f ? 1e-30f : d);
    }
    s[6] = tbest ? tbest[base + i] : INFINITY;
  }
  __syncthreads();
  if (col >= n_cols) return;

  bool on = true;
  if (cbits) {
    const int b = col / kActCols;
    on = ((cbits[(size_t)tile * nwords + b / 32] >> (b % 32)) & 1) != 0;
  }
  const float lo0 = cmin[col * 3 + 0], lo1 = cmin[col * 3 + 1], lo2 = cmin[col * 3 + 2];
  const float hi0 = cmax[col * 3 + 0], hi1 = cmax[col * 3 + 1], hi2 = cmax[col * 3 + 2];
  const int rows = ray_tile / n_sub;
  int bits = 0;
  float emin = INFINITY;
  for (int st = 0; st < n_sub; ++st) {
    float smin = INFINITY;
    if (on) {
      for (int i = st * rows; i < (st + 1) * rows; ++i) {
        const float* s = sm + i * 7;
        float t1 = (lo0 - s[0]) * s[3];
        float t2 = (hi0 - s[0]) * s[3];
        float t_lo = nan_min(t1, t2);
        float t_hi = nan_max(t1, t2);
        t1 = (lo1 - s[1]) * s[4];
        t2 = (hi1 - s[1]) * s[4];
        t_lo = nan_max(t_lo, nan_min(t1, t2));
        t_hi = nan_min(t_hi, nan_max(t1, t2));
        t1 = (lo2 - s[2]) * s[5];
        t2 = (hi2 - s[2]) * s[5];
        t_lo = nan_max(t_lo, nan_min(t1, t2));
        t_hi = nan_min(t_hi, nan_max(t1, t2));
        if (t_lo <= t_hi && t_hi >= min_dst && t_lo <= s[6]) {
          const float e = t_lo > min_dst ? t_lo : min_dst;
          smin = e < smin ? e : smin;
        }
      }
    }
    if (sub_ent) sub_ent[((size_t)tile * n_sub + st) * n_cols + col] = smin;
    if (smin < INFINITY) bits |= 1 << st;
    emin = smin < emin ? smin : emin;
  }
  m8[(size_t)tile * n_cols + col] = bits;
  ent[(size_t)tile * n_cols + col] = emin;
}

__global__ void items_kernel(
    const float* __restrict__ rays,        // [R, 8]
    const float* __restrict__ tmin0,       // [R]
    const int32_t* __restrict__ tidx0,     // [R]
    const float* __restrict__ chunk_woop,  // [Cpad, 12, cw]
    const int32_t* __restrict__ idx,       // [T, cap]
    const int32_t* __restrict__ counts,    // [T]
    const int32_t* __restrict__ masks,     // [T, cap, W]
    int cap, int n_words, int group, int n_sub, int cw, float min_dst,
    float* __restrict__ t_out,             // [R]
    int32_t* __restrict__ tri_out) {       // [R]
  extern __shared__ float w[];  // [12][cw] Woop block of the current chunk
  const int tile = blockIdx.x;
  const size_t i = (size_t)tile * blockDim.x + threadIdx.x;
  const int st = threadIdx.x / (blockDim.x / n_sub);
  const float* ray = rays + i * 8;
  const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
  const float d0 = ray[4], d1 = ray[5], d2 = ray[6];
  float cur = tmin0[i];
  int32_t cur_i = tidx0[i];
  const int n = counts[tile];
  for (int s = 0; s < n; ++s) {
    const int jg = idx[(size_t)tile * cap + s];
    const int32_t* words = masks + ((size_t)tile * cap + s) * n_words;
    for (int g = 0; g < group; ++g) {
      const int mask = (words[g / 4] >> (8 * (g % 4))) & 0xFF;
      if (mask == 0) continue;  // uniform over the block
      const int chunk = jg * group + g;
      __syncthreads();  // previous chunk's readers are done
      const float* src = chunk_woop + (size_t)chunk * 12 * cw;
      for (int k = threadIdx.x; k < 12 * cw; k += blockDim.x) w[k] = src[k];
      __syncthreads();
      if (!((mask >> st) & 1)) continue;
      float best = INFINITY;
      int arg = 0;
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
        const bool ok = beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f &&
                        t >= min_dst;
        const float tm = ok ? t : INFINITY;
        if (tm < best) {
          best = tm;
          arg = j;
        }
      }
      if (best < cur) {
        cur = best;
        cur_i = chunk * cw + arg;
      }
    }
  }
  t_out[i] = cur;
  tri_out[i] = cur_i;
}

}  // namespace

extern "C" int tpt_activity(
    const void* rays, const void* cmin, const void* cmax, const void* tbest,
    const void* cbits, int nwords, int n_rays, int n_cols, int ray_tile,
    int n_sub, float min_dst, void* m8, void* ent, void* sub_ent,
    void* stream) {
  const int t_tiles = n_rays / ray_tile;
  const dim3 grid((n_cols + kActThreads - 1) / kActThreads, t_tiles);
  const size_t smem = (size_t)ray_tile * 7 * sizeof(float);
  activity_kernel<<<grid, kActThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)cmin, (const float*)cmax,
      (const float*)tbest, (const int32_t*)cbits, nwords, n_cols, ray_tile,
      n_sub, min_dst, (int32_t*)m8, (float*)ent, (float*)sub_ent);
  return (int)cudaGetLastError();
}

extern "C" int tpt_items(
    const void* rays, const void* tmin0, const void* tidx0,
    const void* chunk_woop, const void* idx, const void* counts,
    const void* masks, int n_rays, int t_tiles, int cap, int n_words,
    int group, int n_sub, int cw, float min_dst, void* t_out, void* tri_out,
    void* stream) {
  const int ray_tile = n_rays / t_tiles;
  const size_t smem = (size_t)12 * cw * sizeof(float);
  items_kernel<<<t_tiles, ray_tile, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)tmin0, (const int32_t*)tidx0,
      (const float*)chunk_woop, (const int32_t*)idx, (const int32_t*)counts,
      (const int32_t*)masks, cap, n_words, group, n_sub, cw, min_dst,
      (float*)t_out, (int32_t*)tri_out);
  return (int)cudaGetLastError();
}
