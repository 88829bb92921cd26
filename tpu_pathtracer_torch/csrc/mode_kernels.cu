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
//   tested on the 64-ray sub-tiles whose bit is set in the slot's mask byte;
//   the result is the lexicographic minimum of (t, triangle id) over the
//   tested triangles and (tmin0, tidx0), as B2's (keys with the triangle id
//   in the low word).  The same
//   function as B2 (items_kernel); what is particular to the slot grid is
//   that a slot's group of chunks is one contiguous block of Woop rows (48 KB
//   at 8 chunks of 128 triangles), which the Pallas index map fetched in one
//   copy per (tile, slot) grid step.
//   Bound on the H100: ALU, as B2 (~55 lane operations per (ray, triangle)
//   pair; the groups are read from L2).  On the card a (tile, slot) grid
//   leaves most warps idle: about one sub-tile bit in six is set, and the
//   grid is cap x T blocks of which a quarter are live.
//   Design: the work is the set (chunk, sub-tile) bits of the live slots.
//   ``slot_unit_offsets`` (tensor code, no host read) gives their prefix sum
//   per (tile, slot); a persistent grid (as many blocks as the SMs hold)
//   splits the unit count into equal contiguous ranges, so no block is
//   launched for a dead slot and a long slot may be shared by two blocks.
//   A block is one producer warp and kSlotWarps consumer warps.  The
//   producer walks the slots of the block's range (binary search for the
//   first, a galloping search past dead slots) and stages each slot's group
//   from the triangle-major copy of chunk_woop, one cp.async.bulk per chunk
//   whose mask byte is non-zero, into a ring of kSlotStages groups; a stage
//   is full when its bytes have landed on its mbarrier, and empty again when
//   every consumer warp has arrived on a second mbarrier, so the next slot's
//   group is in flight while this one is walked.  A unit's triangles are
//   cut into kSlotParts parts, and the parts of the block's range are dealt
//   to the consumer warps round robin by number, across slot boundaries, so
//   no warp waits on a clear bit and a warp may run one slot ahead of
//   another (the atrium's slots have ~11 units; whole units dealt to 12
//   warps would leave some waiting at every slot).  A warp tests a part's
//   64 rays, 32 at a time, against its triangles with tpt::woop_hit on
//   three float4 shared loads per triangle.  Order is kept by the key of B5
//   with a test-order index (s * group + g) * cw + lane in place of the
//   triangle id (the first minimum in slot, chunk, lane order), decoded back
//   to the triangle (idx[i, s] * group + g) * cw + lane by the final pass: t
//   and tri equal the plain twin and B2 bit for bit, from run to run.
//
// B7  ray_group_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:421 (_ray_group_kernel,
//   via ray_group_bools :457).
//   out[g, r] = 1 when ray r's slab test passes (t_lo <= t_hi, t_hi >=
//   min_dst, no far bound) for any of group g's chunk AABBs, else 0; the
//   output is group-major [CG, R] int32.
//   Bound on the H100: memory on the output (4 bytes per (group, ray) pair
//   against ~30 lane operations per (ray, box) pair x group boxes, with the
//   one-instruction NaN-propagating min/max of slab.cuh; 64 MB at the
//   atrium's 256 x 65,536).  Design: one thread per (ray, group), the
//   threads of a warp on consecutive rays of one group so every store is
//   coalesced; a block's groups' boxes are staged in shared memory once and
//   read as broadcasts.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "persistent_grid.cuh"
#include "slab.cuh"
#include "stage.cuh"

namespace {

constexpr int kFinalThreads = 256;
constexpr int kDenseGroup = 8;       // chunks per B5 block
constexpr int kGroupThreads = 256;    // rays per B7 block
constexpr int kGroupsPerBlock = 32;   // groups per B7 block
constexpr int kSlotWarps = 12;        // consumer warps per B6 block (one more produces)
constexpr int kSlotStages = 2;        // B6's ring of staged groups
constexpr int kSlotParts = 2;        // a unit's triangles are dealt in this many parts (divides cw)
constexpr int kSlotHead = 128;        // bytes before the ring: barriers, slot records

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
  if (best < tmin0[i]) atomicMin(keys + i, tpt::make_key(best, best_tri));
}

__global__ void dense_final_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, int n_rays,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const unsigned long long key = keys[i];
  if (key != tpt::kNoKey && tpt::key_time(key) < tmin0[i]) {
    t_out[i] = tpt::key_time(key);
    tri_out[i] = (int32_t)(key & 0xFFFFFFFFu);
  } else {
    t_out[i] = tmin0[i];
    tri_out[i] = tidx0[i];
  }
}

// One part of a unit of B6: the rays of a sub-tile (``rows`` from ray
// ``ray0``), 32 at a time, against triangles j0 .. j1-1 of the chunk staged
// at ``w``, whose first triangle id is ``tri0``; each ray's first minimum
// goes to its key when it is not above tmin0 (the final pass settles a tie
// on the triangle id).
__device__ __forceinline__ void slot_part(
    const float4* __restrict__ w, const float* __restrict__ rays,
    const float* __restrict__ tmin0, size_t ray0, int rows, int j0, int j1, unsigned tri0,
    float min_dst, int lane, unsigned long long* __restrict__ keys) {
  for (int r = lane; r < rows; r += 32) {
    const size_t i = ray0 + r;
    const float4 o = reinterpret_cast<const float4*>(rays)[2 * i];
    const float4 d = reinterpret_cast<const float4*>(rays)[2 * i + 1];
    float best = INFINITY;
    int arg = 0;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) {
      float t, q2;
      const bool ok = tpt::woop_hit(w[3 * j], w[3 * j + 1], w[3 * j + 2], o.x, o.y, o.z, d.x, d.y,
                                    d.z, min_dst, &t, &q2);
      const float tm = ok ? t : INFINITY;
      if (tm < best) {  // strict: the first lane keeps a tie
        best = tm;
        arg = j;
      }
    }
    if (best <= tmin0[i] && best < INFINITY)
      atomicMin(keys + i, tpt::make_key(best, tri0 + (unsigned)arg));
  }
}

__global__ void __launch_bounds__((kSlotWarps + 1) * 32) slots_kernel(
    const float* __restrict__ rays,        // [R, 8]
    const float* __restrict__ tmin0,       // [R]
    const float4* __restrict__ woop_t,     // [Cpad, cw, 3] triangle-major Woop rows
    const int32_t* __restrict__ idx,       // [T * cap]
    const int32_t* __restrict__ masks,     // [T * cap, W]
    const int32_t* __restrict__ offsets,   // [T * cap] units, inclusive prefix sum
    int n_slots, int cap, int n_words, int group, int n_sub, int ray_tile, int cw,
    float min_dst,
    unsigned long long* __restrict__ keys) {  // [R], all ones on entry
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);        // [kSlotStages] bytes landed
  uint64_t* empty = full + kSlotStages;                       // [kSlotStages] consumers done
  int4* record = reinterpret_cast<int4*>(smem + 64);          // [kSlotStages] (slot, units before, last)
  float4* ring = reinterpret_cast<float4*>(smem + kSlotHead);  // [kSlotStages][group][cw * 3]
  const long long total = offsets[n_slots - 1];
  const int lo = (int)(total * blockIdx.x / gridDim.x);
  const int hi = (int)(total * (blockIdx.x + 1) / gridDim.x);
  if (lo >= hi) return;  // uniform over the block
  const unsigned submask = (1u << n_sub) - 1u;
  const size_t chunk_f4 = (size_t)cw * 3;
  const size_t stage_f4 = chunk_f4 * group;

  if (threadIdx.x == 0) {
    for (int k = 0; k < kSlotStages; ++k) {
      tpt::mbar_init(&full[k], 1);
      tpt::mbar_init(&empty[k], kSlotWarps);
    }
    tpt::mbar_init_fence();
  }
  __syncthreads();  // the last block-wide barrier: the warps part ways here
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kSlotWarps) {
    // Producer (one lane): the slots with units in [lo, hi), in order.
    if (lane != 0) return;
    int a = 0, b = n_slots - 1;
    while (a < b) {  // the first slot whose prefix sum passes lo
      const int m = (a + b) >> 1;
      if (offsets[m] > lo) b = m; else a = m + 1;
    }
    int slot = a;
    for (int use = 0;; ++use) {
      const int stage = use % kSlotStages;
      if (use >= kSlotStages) {
        // Every consumer warp has left the stage's previous slot.
        tpt::mbar_wait_or_trap(&empty[stage], ((use / kSlotStages) - 1) & 1);
        tpt::fence_proxy_async();
      }
      const int before = slot > 0 ? offsets[slot - 1] : 0;
      const int after = offsets[slot];
      const bool last = after >= hi;
      record[stage] = make_int4(slot, before, last ? 1 : 0, 0);
      const int32_t* words = masks + (size_t)slot * n_words;
      unsigned live = 0;  // bit g: chunk g of the group has a set sub-tile bit
      for (int g = 0; g < group; ++g) {
        if (((unsigned)words[g / 4] >> (8 * (g % 4))) & submask) live |= 1u << g;
      }
      const uint32_t chunk_bytes = (uint32_t)(chunk_f4 * sizeof(float4));
      // The arrival releases the record to the consumers; the phase
      // completes when the chunks' bytes have landed too.
      tpt::mbar_expect_tx(&full[stage], (uint32_t)__popc(live) * chunk_bytes);
      const size_t chunk0 = (size_t)idx[slot] * group;
      for (int g = 0; g < group; ++g) {
        if ((live >> g) & 1)
          tpt::bulk_load(ring + stage * stage_f4 + g * chunk_f4, woop_t + (chunk0 + g) * chunk_f4,
                         chunk_bytes, &full[stage]);
      }
      if (last) return;
      // The next slot with units, by a galloping search over the prefix
      // sum: a tile's dead slots cost O(log gap) loads.
      int lo_s = slot, hi_s = slot + 1, step = 1;
      while (offsets[hi_s] <= after) {  // ends: offsets[n_slots - 1] = total > after
        lo_s = hi_s;
        step <<= 1;
        hi_s = min(slot + step, n_slots - 1);
      }
      while (hi_s - lo_s > 1) {
        const int m = (lo_s + hi_s) >> 1;
        if (offsets[m] > after) hi_s = m; else lo_s = m;
      }
      slot = hi_s;
    }
  }

  // Consumers: part h of unit number u of the block's range belongs to warp
  // ((u - lo) * kSlotParts + h) % kSlotWarps.
  const int rows = ray_tile / n_sub;
  const int part = cw / kSlotParts;
  for (int use = 0;; ++use) {
    const int stage = use % kSlotStages;
    tpt::mbar_wait_or_trap(&full[stage], (use / kSlotStages) & 1);
    const int4 rec = record[stage];
    const int slot = rec.x;
    const int tile = slot / cap;
    const int32_t* words = masks + (size_t)slot * n_words;
    int u = rec.y;  // the number of the slot's first unit
    for (int g = 0; g < group; ++g) {
      unsigned bits = ((unsigned)words[g / 4] >> (8 * (g % 4))) & submask;
      for (; bits; bits &= bits - 1, ++u) {
        if (u < lo || u >= hi) continue;
        const int st = __ffs(bits) - 1;
        for (int h = 0; h < kSlotParts; ++h) {
          if (((u - lo) * kSlotParts + h) % kSlotWarps != warp) continue;
          slot_part(ring + stage * stage_f4 + g * chunk_f4, rays, tmin0,
                    (size_t)tile * ray_tile + (size_t)st * rows, rows, h * part, (h + 1) * part,
                    (unsigned)((idx[slot] * group + g) * cw), min_dst, lane, keys);
        }
      }
    }
    __syncwarp();  // every lane has read its last triangle of the stage
    if (lane == 0) tpt::mbar_arrive(&empty[stage]);
    if (rec.z) return;
  }
}

__global__ void slots_final_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, int n_rays,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  tpt::decode_tri_key(keys[i], i, tmin0, tidx0, t_out, tri_out);
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
  const float i0 = tpt::inv_dir(ray[4]);
  const float i1 = tpt::inv_dir(ray[5]);
  const float i2 = tpt::inv_dir(ray[6]);
  for (int gl = 0; gl < ng; ++gl) {
    int hit = 0;
    for (int c = 0; c < group; ++c) {
      const float* b = box + (gl * group + c) * 6;
      float t_lo, t_hi;
      tpt::slab_interval(b[0], b[1], b[2], b[3], b[4], b[5], o0, o1, o2, i0, i1, i2, &t_lo, &t_hi);
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
    const void* woop_t, const void* idx, const void* masks, const void* offsets,
    int n_rays, int t_tiles, int cap, int n_words,
    int group, int n_sub, int cw, float min_dst, void* keys, void* t_out,
    void* tri_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ray_tile = n_rays / t_tiles;
  const int n_slots = t_tiles * cap;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, (size_t)n_rays * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n_slots > 0) {
    // A persistent grid: as many blocks as the SMs hold at once.  The ring
    // is past the 48 KB a block gets without asking.
    const int threads = (kSlotWarps + 1) * 32;
    const size_t smem = kSlotHead + (size_t)kSlotStages * group * cw * 3 * sizeof(float4);
    int grid = 0;
    if ((err = persistent_grid((const void*)slots_kernel, threads, smem, &grid)) !=
        cudaSuccess)
      return (int)err;
    slots_kernel<<<grid, threads, smem, st>>>(
        (const float*)rays, (const float*)tmin0, (const float4*)woop_t, (const int32_t*)idx,
        (const int32_t*)masks, (const int32_t*)offsets, n_slots, cap, n_words, group, n_sub,
        ray_tile, cw, min_dst, (unsigned long long*)keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slots_final_kernel<<<(n_rays + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, st>>>(
      (const unsigned long long*)keys, (const float*)tmin0, (const int32_t*)tidx0, n_rays,
      (float*)t_out, (int32_t*)tri_out);
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
