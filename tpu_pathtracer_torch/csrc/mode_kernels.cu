// Hand-written Hopper (sm_90a) kernels of the intersector's modes "dense",
// "twopass" and "bins".
//
// Built by tpu_pathtracer_torch/kernels.py with the same flags as
// chunk_kernels.cu (-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false)
// into its own shared library with a plain C interface, called through
// ctypes on PyTorch's current stream.  --fmad=false keeps every Woop and slab
// expression rounded op for op like the plain-torch twins in
// ops/chunk_intersect.py.  Each C entry returns the first CUDA error of its
// launches (0 when none).
//
// ---------------------------------------------------------------------------
// B5  dense_kernel (+ dense_final_kernel)
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:727 (_kernel_dense, via
//   run_dense :1015).
//   For every (ray tile, chunk) pair whose activity bit is set, the Woop test
//   of the tile's rays against the chunk's triangles, min-accumulated with a
//   strict < over (tmin0, tidx0) in ascending chunk order: the result is the
//   lexicographic minimum of (t, triangle id) among the tested triangles,
//   taken when its t is strictly below tmin0.
//   Bound on the H100: ALU (~40 float ops and one divide per pair), and
//   occupancy: the Pallas grid walked (tile, chunk group) steps in order on
//   one core; here one block per (tile, group of 8 chunks) runs in parallel
//   with every other, and blocks whose group has no active chunk for the
//   tile exit at once.  A thread per ray folds its group's per-chunk first
//   minima (chunk Woop blocks staged in shared memory) and sends the winner
//   as one 64-bit key, the float bits of t (t >= min_dst > 0, so the bits
//   order like the floats) above the triangle id, through one atomicMin; the
//   lexicographic
//   minimum of the keys is the sequential walk's result, ties included, and
//   it does not depend on the order the blocks run in.  A final pass
//   compares the key's t strictly with tmin0.
//
// B6  slots_kernel (+ slots_final_kernel)
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:761 (_kernel_pass, via
//   run_pass :1034).
//   For tile i and slot s < counts[i], group idx[i, s]: each of its chunks is
//   tested on the 64-ray sub-tiles whose bit is set in the slot's mask byte,
//   accumulated in slot order with a strict < over (tmin0, tidx0).  The same
//   function as B2 (items_kernel), run the TPU's way: a (tile, slot) grid,
//   so a tile's slots run in parallel instead of one block walking the whole
//   worklist.  Bound as B2.  Order is kept by the key of B5 with a test-order
//   index (s * group + g) * cw + lane in place of the triangle id (the first
//   minimum in slot, chunk, lane order), decoded back to the triangle
//   (idx[i, s] * group + g) * cw + lane by the final pass.
//
// B7  ray_group_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:421 (_ray_group_kernel,
//   via ray_group_bools :457).
//   out[g, r] = 1 when ray r's slab test passes (t_lo <= t_hi, t_hi >=
//   min_dst, no far bound) for any of group g's chunk AABBs, else 0; the
//   output is group-major [CG, R] int32.
//   Bound on the H100: memory on the output (4 bytes per (group, ray) pair
//   against ~25 float ops per (ray, box) pair x group boxes; 64 MB at the
//   atrium's 256 x 65,536).  Design: one thread per (ray, group), the
//   threads of a warp on consecutive rays of one group so every store is
//   coalesced; a block's groups' boxes are staged in shared memory once and
//   read as broadcasts.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFinalThreads = 256;
constexpr int kDenseGroup = 8;       // chunks per B5 block
constexpr int kGroupThreads = 256;    // rays per B7 block
constexpr int kGroupsPerBlock = 32;   // groups per B7 block
constexpr unsigned long long kNoKey = ~0ull;

// jnp.minimum / torch.minimum semantics: a NaN operand gives NaN, so the
// NaN boxes of padding chunks never pass the slab test.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ unsigned long long make_key(float t, unsigned int low) {
  return ((unsigned long long)__float_as_uint(t) << 32) | low;
}

__device__ __forceinline__ float key_time(unsigned long long key) {
  return __uint_as_float((unsigned int)(key >> 32));
}

// First minimum over one chunk's cw triangles of the Woop test of the ray
// (o, d), the chunk's [12][cw] block in shared memory; the operation order
// of _contract_o / _contract_d.  Returns the t (INFINITY if none) and the
// lane in *arg.
__device__ __forceinline__ float chunk_first_min(
    const float* __restrict__ w, int cw, float o0, float o1, float o2,
    float d0, float d1, float d2, float min_dst, int* arg) {
  float best = INFINITY;
  int a = 0;
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
      a = j;
    }
  }
  *arg = a;
  return best;
}

// Every thread of the block copies its share of one chunk's Woop block.
__device__ __forceinline__ void stage_chunk(float* __restrict__ w,
                                            const float* __restrict__ chunk_woop,
                                            int chunk, int cw) {
  const float* src = chunk_woop + (size_t)chunk * 12 * cw;
  for (int k = threadIdx.x; k < 12 * cw; k += blockDim.x) w[k] = src[k];
}

__global__ void dense_kernel(
    const float* __restrict__ rays,        // [R, 8]
    const float* __restrict__ tmin0,       // [R]
    const float* __restrict__ chunk_woop,  // [C, 12, cw]
    const int32_t* __restrict__ bits,      // [T, nwords]
    int n_chunks, int nwords, int cw, float min_dst,
    unsigned long long* __restrict__ keys) {  // [R], all ones on entry
  extern __shared__ float w[];  // [12][cw] Woop block of the current chunk
  constexpr int group = kDenseGroup;
  const int jg = blockIdx.x;
  const int tile = blockIdx.y;
  const int32_t* row = bits + (size_t)tile * nwords;
  unsigned int on = 0;  // bit g: chunk g of the group is active (uniform)
  for (int g = 0; g < group; ++g) {
    const int j = jg * group + g;
    if (j < n_chunks && ((row[j >> 5] >> (j & 31)) & 1)) on |= 1u << g;
  }
  if (on == 0) return;
  const size_t i = (size_t)tile * blockDim.x + threadIdx.x;
  const float* ray = rays + i * 8;
  const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
  const float d0 = ray[4], d1 = ray[5], d2 = ray[6];
  float best = INFINITY;
  unsigned int best_tri = 0;
  for (int g = 0; g < group; ++g) {
    if (!((on >> g) & 1)) continue;
    const int chunk = jg * group + g;
    __syncthreads();  // previous chunk's readers are done
    stage_chunk(w, chunk_woop, chunk, cw);
    __syncthreads();
    int arg;
    const float t = chunk_first_min(w, cw, o0, o1, o2, d0, d1, d2, min_dst, &arg);
    if (t < best) {  // strict: the earlier chunk keeps a tie
      best = t;
      best_tri = (unsigned int)(chunk * cw + arg);
    }
  }
  if (best < tmin0[i]) atomicMin(keys + i, make_key(best, best_tri));
}

__global__ void dense_final_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, int n_rays,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const unsigned long long key = keys[i];
  if (key != kNoKey && key_time(key) < tmin0[i]) {
    t_out[i] = key_time(key);
    tri_out[i] = (int32_t)(key & 0xFFFFFFFFu);
  } else {
    t_out[i] = tmin0[i];
    tri_out[i] = tidx0[i];
  }
}

__global__ void slots_kernel(
    const float* __restrict__ rays,        // [R, 8]
    const float* __restrict__ tmin0,       // [R]
    const float* __restrict__ chunk_woop,  // [Cpad, 12, cw]
    const int32_t* __restrict__ idx,       // [T, cap]
    const int32_t* __restrict__ counts,    // [T]
    const int32_t* __restrict__ masks,     // [T, cap, W]
    int cap, int n_words, int group, int n_sub, int cw, float min_dst,
    unsigned long long* __restrict__ keys) {  // [R], all ones on entry
  extern __shared__ float w[];  // [12][cw] Woop block of the current chunk
  const int s = blockIdx.x;
  const int tile = blockIdx.y;
  if (s >= counts[tile]) return;
  const int jg = idx[(size_t)tile * cap + s];
  const int32_t* words = masks + ((size_t)tile * cap + s) * n_words;
  const size_t i = (size_t)tile * blockDim.x + threadIdx.x;
  const int st = threadIdx.x / (blockDim.x / n_sub);
  const float* ray = rays + i * 8;
  const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
  const float d0 = ray[4], d1 = ray[5], d2 = ray[6];
  float best = INFINITY;
  unsigned int best_ord = 0;
  for (int g = 0; g < group; ++g) {
    const int mask = (words[g / 4] >> (8 * (g % 4))) & 0xFF;
    if (mask == 0) continue;  // uniform over the block
    __syncthreads();
    stage_chunk(w, chunk_woop, jg * group + g, cw);
    __syncthreads();
    if (!((mask >> st) & 1)) continue;
    int arg;
    const float t = chunk_first_min(w, cw, o0, o1, o2, d0, d1, d2, min_dst, &arg);
    if (t < best) {
      best = t;
      best_ord = (unsigned int)((s * group + g) * cw + arg);
    }
  }
  if (best < tmin0[i]) atomicMin(keys + i, make_key(best, best_ord));
}

__global__ void slots_final_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, const int32_t* __restrict__ idx,
    int n_rays, int ray_tile, int cap, int group, int cw,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const unsigned long long key = keys[i];
  if (key != kNoKey && key_time(key) < tmin0[i]) {
    const unsigned int ord = (unsigned int)(key & 0xFFFFFFFFu);
    const unsigned int lane = ord % cw;
    const unsigned int sg = ord / cw;  // s * group + g
    const int s = sg / group;
    const int g = sg % group;
    const int jg = idx[(size_t)(i / ray_tile) * cap + s];
    t_out[i] = key_time(key);
    tri_out[i] = (int32_t)((jg * group + g) * cw + lane);
  } else {
    t_out[i] = tmin0[i];
    tri_out[i] = tidx0[i];
  }
}

__global__ void ray_group_kernel(
    const float* __restrict__ rays,  // [R, 8]
    const float* __restrict__ cmin,  // [CG * group, 3]
    const float* __restrict__ cmax,  // [CG * group, 3]
    int n_rays, int n_groups, int group, float min_dst,
    int32_t* __restrict__ out) {     // [CG, R]
  extern __shared__ float box[];  // [kGroupsPerBlock * group][6]: min xyz, max xyz
  const int g0 = blockIdx.y * kGroupsPerBlock;
  const int ng = min(kGroupsPerBlock, n_groups - g0);
  const int nbox = ng * group;
  for (int k = threadIdx.x; k < nbox * 3; k += blockDim.x) {
    const int b = k / 3, a = k % 3;
    const size_t c = (size_t)g0 * group + b;
    box[b * 6 + a] = cmin[c * 3 + a];
    box[b * 6 + 3 + a] = cmax[c * 3 + a];
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float* ray = rays + (size_t)r * 8;
  const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
  const float i0 = 1.0f / (ray[4] == 0.0f ? 1e-30f : ray[4]);
  const float i1 = 1.0f / (ray[5] == 0.0f ? 1e-30f : ray[5]);
  const float i2 = 1.0f / (ray[6] == 0.0f ? 1e-30f : ray[6]);
  for (int gl = 0; gl < ng; ++gl) {
    int hit = 0;
    for (int c = 0; c < group; ++c) {
      const float* b = box + (gl * group + c) * 6;
      float t1 = (b[0] - o0) * i0;
      float t2 = (b[3] - o0) * i0;
      float t_lo = nan_min(t1, t2);
      float t_hi = nan_max(t1, t2);
      t1 = (b[1] - o1) * i1;
      t2 = (b[4] - o1) * i1;
      t_lo = nan_max(t_lo, nan_min(t1, t2));
      t_hi = nan_min(t_hi, nan_max(t1, t2));
      t1 = (b[2] - o2) * i2;
      t2 = (b[5] - o2) * i2;
      t_lo = nan_max(t_lo, nan_min(t1, t2));
      t_hi = nan_min(t_hi, nan_max(t1, t2));
      hit |= (t_lo <= t_hi && t_hi >= min_dst) ? 1 : 0;
    }
    out[(size_t)(g0 + gl) * n_rays + r] = hit;
  }
}

}  // namespace

extern "C" int tpt_dense(
    const void* rays, const void* tmin0, const void* tidx0,
    const void* chunk_woop, const void* bits, int n_rays, int t_tiles,
    int n_chunks, int nwords, int cw, float min_dst, void* keys,
    void* t_out, void* tri_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ray_tile = n_rays / t_tiles;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, (size_t)n_rays * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_chunks + kDenseGroup - 1) / kDenseGroup, t_tiles);
  dense_kernel<<<grid, ray_tile, (size_t)12 * cw * sizeof(float), st>>>(
      (const float*)rays, (const float*)tmin0, (const float*)chunk_woop,
      (const int32_t*)bits, n_chunks, nwords, cw, min_dst,
      (unsigned long long*)keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_final_kernel<<<(n_rays + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, st>>>(
      (const unsigned long long*)keys, (const float*)tmin0, (const int32_t*)tidx0,
      n_rays, (float*)t_out, (int32_t*)tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_slots(
    const void* rays, const void* tmin0, const void* tidx0,
    const void* chunk_woop, const void* idx, const void* counts,
    const void* masks, int n_rays, int t_tiles, int cap, int n_words,
    int group, int n_sub, int cw, float min_dst, void* keys, void* t_out,
    void* tri_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ray_tile = n_rays / t_tiles;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, (size_t)n_rays * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (cap > 0) {
    slots_kernel<<<dim3(cap, t_tiles), ray_tile, (size_t)12 * cw * sizeof(float), st>>>(
        (const float*)rays, (const float*)tmin0, (const float*)chunk_woop,
        (const int32_t*)idx, (const int32_t*)counts, (const int32_t*)masks, cap,
        n_words, group, n_sub, cw, min_dst, (unsigned long long*)keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slots_final_kernel<<<(n_rays + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, st>>>(
      (const unsigned long long*)keys, (const float*)tmin0, (const int32_t*)tidx0,
      (const int32_t*)idx, n_rays, ray_tile, cap, group, cw, (float*)t_out,
      (int32_t*)tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_ray_groups(
    const void* rays, const void* cmin, const void* cmax, int n_rays,
    int n_groups, int group, float min_dst, void* out, void* stream) {
  const dim3 grid((n_rays + kGroupThreads - 1) / kGroupThreads,
                  (n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  const size_t smem = (size_t)kGroupsPerBlock * group * 6 * sizeof(float);
  ray_group_kernel<<<grid, kGroupThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)cmin, (const float*)cmax, n_rays,
      n_groups, group, min_dst, (int32_t*)out);
  return (int)cudaGetLastError();
}
