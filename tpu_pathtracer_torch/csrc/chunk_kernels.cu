// Hand-written Hopper (sm_90a) kernels of the chunk-skipping intersector.
//
// Built by tpu_pathtracer_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, called through ctypes on
// PyTorch's current stream.  --fmad=false keeps every slab and Woop
// expression rounded op for op like the plain-torch twins in
// ops/chunk_intersect.py, so m8 / ent / t / tri compare exactly on the card.
// Each C entry returns the first CUDA error
// of its launches (0 when none).
//
// ---------------------------------------------------------------------------
// B1  activity_kernel
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:146 (_activity_body,
//   through _activity_kernel :137 and _activity_kernel_gated :229).
//   Per (ray tile, chunk): slab test of every ray of the tile against the
//   chunk AABB with the per-ray far bound tbest; per 64-ray sub-tile the
//   minimum entry distance; packed sub-tile bits m8, tile entry ent and,
//   when asked, the per-sub-tile entries.
//   Bound on the H100: ALU.  A (ray, chunk) pair is ~30 lane operations (12
//   differences and products, 10 NaN-propagating min/max of one instruction
//   each, the three tests and the entry minimum) on 7 floats of ray state
//   and 6 of box; the outputs are 8 bytes per (tile, chunk).  The render
//   launches it at every width from 4 columns (the super-block gate) to
//   the chunk count, so the work has to fill the card at any column count.
//   Design: rays across lanes.  One block per (ray tile, 128 chunk
//   columns); a thread keeps its ray (origin, reciprocal direction, tbest)
//   in registers, loaded as two float4 and inverted once; the block's boxes
//   sit in shared memory as two float4 per column and are read as
//   broadcasts, four columns per step so four independent chains are in
//   flight.  The Pallas kernel's per-sub-tile minimum over rays is a warp
//   reduction here: an entry is >= min_dst >= 0 or +inf, so its bits order
//   as unsigned integers; a warp votes whether any of its rays hit any of
//   the four columns (most steps end there), and only then takes
//   __reduce_min_sync per hit column and sends the warp's minimum by one
//   shared-memory atomicMin to the (sub-tile, column) cell, which joins the
//   warps of a sub-tile.  A sub-tile that is not whole warps (rows % 32
//   != 0) sends its entries lane by lane.  The coarse gate (one bit per
//   (tile, 512-column block), uniform over a block) is read before
//   anything is staged: a gated-off block writes 0 / +inf and leaves.  The
//   minimum is order-free, so the outputs equal the twin's exactly.
//
// B2  items_kernel (+ items_final_kernel)
//   Replaces tpu_pathtracer/ops/pallas_intersect.py:819 (_kernel_items, with
//   _chunk_body_sub :694 and _contract_o/_contract_d :645-663).
//   For tile i, slot s < counts[i], chunk g of group idx[i, s] and every
//   64-ray sub-tile whose mask bit is set: the Woop test of the sub-tile's
//   rays against the chunk's 128 triangles, first minimum inside a chunk,
//   strict < across chunks in (slot, chunk) order, from (tmin0, tidx0).
//   Bound on the H100: ALU.  A (ray, triangle) pair is ~55 lane ops (18 + 15
//   products and sums, one IEEE divide, the barycentric tests and the
//   running minimum); the inputs are 6 KB per chunk, read from L2.
//   Design: the unit of work is one set mask bit, (tile, slot, chunk,
//   sub-tile): 64 rays x 128 triangles.  ``item_unit_offsets`` (tensor code)
//   gives the prefix sum of the units per (tile, slot, chunk) item in test
//   order; a persistent grid of 64-thread blocks (as many as fit on the
//   SMs) splits the unit count into equal contiguous ranges, each block
//   finds its first unit by a binary search over the prefix sum and walks
//   on from there (to the next item with units by a galloping search, so
//   the dead slots of a short worklist cost no step each), so every SM is
//   busy to the last unit and no warp runs on a clear bit.  The chunk's Woop block is staged triangle-major (three
//   float4 per triangle: 3 shared loads per pair instead of 12) from a
//   triangle-major copy of chunk_woop by one cp.async.bulk (TMA) into a
//   two-stage ring completed on an mbarrier: the next unit's chunk is in
//   flight while the current one is walked.  The result is order-fixed:
//   each ray's chunk minimum goes to one 64-bit atomicMin on a key holding
//   the float bits of t (t >= min_dst > 0 orders like the floats) above the
//   test order (slot * group + g) * 128 + lane; the minimum key is the
//   sequential walk's first minimum, ties included, whatever order the
//   blocks run in, and a final pass decodes it to the triangle and keeps
//   (tmin0, tidx0) unless strictly beaten.  So t and tri equal the plain
//   twin bit for bit and from run to run.
//   No tensor cores: the Woop contraction is three terms deep and the
//   port's contract is IEEE rounding op for op under --fmad=false (t to 1
//   ulp of the twin); TF32 or bf16 products in wgmma would break it.  The
//   levers here are occupancy, the asynchronous staging and the shared
//   memory layout.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "persistent_grid.cuh"
#include "slab.cuh"
#include "stage.cuh"

namespace {

constexpr int kActCols = 512;        // chunks per coarse-gate block
constexpr int kActBlockCols = 128;   // chunk columns per activity block
constexpr int kActStep = 4;          // columns per step of a thread
constexpr int kActMaxThreads = 512;  // rays of a tile per pass of a block
constexpr int kActMaxSub = 8;        // sub-tiles per tile, at most
constexpr unsigned kInfBits = 0x7f800000u;  // the bits of +inf
constexpr int kItemThreads = 64;  // rays per B2 step: one 64-ray sub-tile
constexpr int kStages = 2;        // B2's ring of staged chunks
constexpr int kStageAlign = 128;  // bytes before the ring (the barriers)
constexpr int kFinalThreads = 256;

__global__ void __launch_bounds__(kActMaxThreads) activity_kernel(
    const float* __restrict__ rays,       // [R, 8] (o, 1, d, 0)
    const float* __restrict__ cmin,       // [C, 3]
    const float* __restrict__ cmax,       // [C, 3]
    const float* __restrict__ tbest,      // [R] or null (= +inf)
    const int32_t* __restrict__ cbits,    // [T, nwords] or null (= all on)
    int nwords, int n_cols, int ray_tile, int n_sub, float min_dst,
    int32_t* __restrict__ m8,             // [T, C]
    float* __restrict__ ent,              // [T, C]
    float* __restrict__ sub_ent) {        // [T, n_sub, C] or null
  // Per column (lo.x, lo.y, lo.z, hi.x) and (hi.y, hi.z, -, -).
  __shared__ float4 box[kActBlockCols * 2];
  // Entry bits per (sub-tile, column); +inf = no ray of the sub-tile hit.
  __shared__ unsigned acc[kActMaxSub * kActBlockCols];
  const int tile = blockIdx.y;
  const int col0 = blockIdx.x * kActBlockCols;
  const int ncols = min(kActBlockCols, n_cols - col0);
  const size_t out0 = (size_t)tile * n_cols + col0;

  // The gate first: the block's columns lie in one 512-column gate block.
  if (cbits) {
    const int b = col0 / kActCols;
    if (!((cbits[(size_t)tile * nwords + b / 32] >> (b % 32)) & 1)) {
      for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
        m8[out0 + c] = 0;
        ent[out0 + c] = INFINITY;
        if (sub_ent) {
          for (int st = 0; st < n_sub; ++st)
            sub_ent[((size_t)tile * n_sub + st) * n_cols + col0 + c] = INFINITY;
        }
      }
      return;
    }
  }

  // Stage the boxes (NaN boxes fill the last step: they never hit) and
  // clear the cells.
  const int ncols_step = (ncols + kActStep - 1) / kActStep * kActStep;
  for (int c = threadIdx.x; c < ncols_step; c += blockDim.x) {
    float4 p = make_float4(NAN, NAN, NAN, NAN), q = p;
    if (c < ncols) {
      const float* lo = cmin + (size_t)(col0 + c) * 3;
      const float* hi = cmax + (size_t)(col0 + c) * 3;
      p = make_float4(lo[0], lo[1], lo[2], hi[0]);
      q = make_float4(hi[1], hi[2], 0.0f, 0.0f);
    }
    box[2 * c] = p;
    box[2 * c + 1] = q;
  }
  for (int k = threadIdx.x; k < n_sub * kActBlockCols; k += blockDim.x) acc[k] = kInfBits;
  __syncthreads();

  const int rows = ray_tile / n_sub;
  const bool whole_warps = rows % 32 == 0;  // a warp's rays share a sub-tile
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < ray_tile; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    const bool live = r < ray_tile;
    const size_t i = (size_t)tile * ray_tile + (live ? r : 0);
    const float4 ro = reinterpret_cast<const float4*>(rays)[2 * i];
    const float4 rd = reinterpret_cast<const float4*>(rays)[2 * i + 1];
    // A lane past the tile carries a NaN origin: it fails every test.
    const float o0 = live ? ro.x : NAN, o1 = ro.y, o2 = ro.z;
    const float i0 = tpt::inv_dir(rd.x), i1 = tpt::inv_dir(rd.y), i2 = tpt::inv_dir(rd.z);
    const float tb = tbest ? tbest[i] : INFINITY;
    unsigned* cell = acc + (live ? r / rows : 0) * kActBlockCols;
    for (int c = 0; c < ncols_step; c += kActStep) {
      float t_lo[kActStep];
      bool hit[kActStep];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kActStep; ++u) {
        const float4 p = box[2 * (c + u)];
        const float4 q = box[2 * (c + u) + 1];
        float t_hi;
        tpt::slab_interval(p.x, p.y, p.z, p.w, q.x, q.y, o0, o1, o2, i0, i1, i2, &t_lo[u], &t_hi);
        hit[u] = t_lo[u] <= t_hi && t_hi >= min_dst && t_lo[u] <= tb;
        any = any || hit[u];
      }
      if (!__any_sync(0xFFFFFFFFu, any)) continue;
#pragma unroll
      for (int u = 0; u < kActStep; ++u) {
        const float e = t_lo[u] > min_dst ? t_lo[u] : min_dst;
        const unsigned bits = hit[u] ? __float_as_uint(e) : kInfBits;
        if (whole_warps) {
          const unsigned m = __reduce_min_sync(0xFFFFFFFFu, bits);
          if (lane == 0 && m < kInfBits) atomicMin(cell + c + u, m);
        } else if (bits < kInfBits) {
          atomicMin(cell + c + u, bits);
        }
      }
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    int bits = 0;
    unsigned emin = kInfBits;
    for (int st = 0; st < n_sub; ++st) {
      const unsigned v = acc[st * kActBlockCols + c];
      if (sub_ent) sub_ent[((size_t)tile * n_sub + st) * n_cols + col0 + c] = __uint_as_float(v);
      if (v < kInfBits) bits |= 1 << st;
      emin = min(emin, v);
    }
    m8[out0 + c] = bits;
    ent[out0 + c] = __uint_as_float(emin);
  }
}

// The set sub-tile bits of chunk item ``item`` = (tile * cap + slot) *
// group + g: byte g%4 of mask word g/4, none past the tile's count.
__device__ __forceinline__ unsigned item_bits(const int32_t* __restrict__ counts,
                                              const int32_t* __restrict__ masks, int item,
                                              int cap, int n_words, int group,
                                              unsigned submask) {
  const int g = item % group;
  const int ts = item / group;  // tile * cap + slot
  if (ts % cap >= counts[ts / cap]) return 0u;
  return ((unsigned)masks[(size_t)ts * n_words + g / 4] >> (8 * (g % 4))) & submask;
}

__global__ void __launch_bounds__(kItemThreads) items_kernel(
    const float* __restrict__ rays,        // [R, 8]
    const float* __restrict__ tmin0,       // [R]
    const float4* __restrict__ woop_t,     // [Cpad, cw, 3] triangle-major Woop rows
    const int32_t* __restrict__ idx,       // [T, cap]
    const int32_t* __restrict__ counts,    // [T]
    const int32_t* __restrict__ masks,     // [T, cap, W]
    const int32_t* __restrict__ offsets,   // [T * cap * group] units, inclusive prefix sum
    int n_items, int cap, int n_words, int group, int n_sub, int ray_tile, int cw,
    float min_dst,
    unsigned long long* __restrict__ keys) {  // [R], all ones on entry
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);                  // [kStages]
  float4* ring = reinterpret_cast<float4*>(smem + kStageAlign);       // [kStages][cw * 3]
  const long long total = offsets[n_items - 1];
  const long long lo = total * blockIdx.x / gridDim.x;
  const long long hi = total * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;  // uniform over the block
  const int n_units = (int)(hi - lo);
  const unsigned submask = (1u << n_sub) - 1u;
  const int rows = ray_tile / n_sub;
  const uint32_t stage_bytes = (uint32_t)cw * 3 * sizeof(float4);

  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) tpt::mbar_init(&bar[k]);
    tpt::mbar_init_fence();
  }
  __syncthreads();

  // The block's first unit: the first item whose prefix sum passes lo, then
  // its (lo - units before the item)-th set bit.  Every thread walks the
  // same cursor (uniform loads, served by L1).
  int a = 0, b = n_items - 1;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (offsets[m] > lo) b = m; else a = m + 1;
  }
  int item = a;
  unsigned bits = item_bits(counts, masks, item, cap, n_words, group, submask);
  for (long long k = lo - (offsets[item] - (long long)__popc(bits)); k > 0; --k) bits &= bits - 1;

  auto issue = [&](int it, int stage) {  // thread 0: stage item it's chunk
    const int chunk = idx[it / group] * group + it % group;
    tpt::mbar_expect_tx(&bar[stage], stage_bytes);
    tpt::bulk_load(ring + (size_t)stage * cw * 3, woop_t + (size_t)chunk * cw * 3, stage_bytes,
                   &bar[stage]);
  };
  if (threadIdx.x == 0) issue(item, 0);
  int next_item = item;
  int next_st = __ffs(bits) - 1;

  for (int u = 0; u < n_units; ++u) {
    const int it = next_item;
    const int st = next_st;
    if (u + 1 < n_units) {  // decode the next unit and put its chunk in flight
      bits &= bits - 1;
      if (bits == 0) {
        // The next item with units, by a galloping search over the prefix
        // sum: a tile's dead slots (slot >= count, up to cap * group items)
        // cost O(log gap) loads instead of one decode step each.
        const int v = offsets[item];  // the next unit's number
        int a = item, b = item + 1, step = 1;
        while (offsets[b] <= v) {  // ends: offsets[n_items - 1] = total > v
          a = b;
          step <<= 1;
          b = min(item + step, n_items - 1);
        }
        while (b - a > 1) {
          const int m = (a + b) >> 1;
          if (offsets[m] > v) b = m; else a = m;
        }
        item = b;
        bits = item_bits(counts, masks, item, cap, n_words, group, submask);
      }
      next_item = item;
      next_st = __ffs(bits) - 1;
      if (threadIdx.x == 0) {
        tpt::fence_proxy_async();  // the stage's last readers passed __syncthreads
        issue(next_item, (u + 1) % kStages);
      }
    }
    tpt::mbar_wait(&bar[u % kStages], (u / kStages) & 1);
    const float4* w = ring + (size_t)(u % kStages) * cw * 3;
    const int g = it % group;
    const int ts = it / group;
    const unsigned order0 = (unsigned)(((ts % cap) * group + g) * cw);
    for (int r = threadIdx.x; r < rows; r += kItemThreads) {
      const size_t i = (size_t)(ts / cap) * ray_tile + (size_t)st * rows + r;
      const float* ray = rays + i * 8;
      const float o0 = ray[0], o1 = ray[1], o2 = ray[2];
      const float d0 = ray[4], d1 = ray[5], d2 = ray[6];
      float best = INFINITY;
      int arg = 0;
      for (int j = 0; j < cw; ++j) {
        float t, q2;
        const bool ok = tpt::woop_hit(w[3 * j], w[3 * j + 1], w[3 * j + 2], o0, o1, o2, d0, d1,
                                      d2, min_dst, &t, &q2);
        const float tm = ok ? t : INFINITY;
        if (tm < best) {  // strict: the first lane keeps a tie
          best = tm;
          arg = j;
        }
      }
      if (best < tmin0[i]) atomicMin(keys + i, tpt::make_key(best, order0 + (unsigned)arg));
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
}

__global__ void items_final_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, const int32_t* __restrict__ idx,
    int n_rays, int ray_tile, int cap, int group, int cw,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  tpt::decode_order_key(keys[i], i, tmin0, tidx0, idx, ray_tile, cap, group, cw, t_out, tri_out);
}

}  // namespace

extern "C" int tpt_activity(
    const void* rays, const void* cmin, const void* cmax, const void* tbest,
    const void* cbits, int nwords, int n_rays, int n_cols, int ray_tile,
    int n_sub, float min_dst, void* m8, void* ent, void* sub_ent,
    void* stream) {
  const int t_tiles = n_rays / ray_tile;
  const dim3 grid((n_cols + kActBlockCols - 1) / kActBlockCols, t_tiles);
  const int threads = min(kActMaxThreads, (ray_tile + 31) / 32 * 32);
  activity_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)cmin, (const float*)cmax,
      (const float*)tbest, (const int32_t*)cbits, nwords, n_cols, ray_tile,
      n_sub, min_dst, (int32_t*)m8, (float*)ent, (float*)sub_ent);
  return (int)cudaGetLastError();
}

extern "C" int tpt_items(
    const void* rays, const void* tmin0, const void* tidx0, const void* woop_t,
    const void* idx, const void* counts, const void* masks, const void* offsets,
    int n_rays, int t_tiles, int cap, int n_words, int group, int n_sub, int cw,
    float min_dst, void* keys, void* t_out, void* tri_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ray_tile = n_rays / t_tiles;
  const int n_items = t_tiles * cap * group;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, (size_t)n_rays * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n_items > 0) {
    // A persistent grid: as many 64-thread blocks as the SMs hold at once.
    const size_t smem = kStageAlign + (size_t)kStages * cw * 3 * sizeof(float4);
    int grid = 0;
    if ((err = persistent_grid((const void*)items_kernel, kItemThreads, smem, &grid)) !=
        cudaSuccess)
      return (int)err;
    items_kernel<<<grid, kItemThreads, smem, st>>>(
        (const float*)rays, (const float*)tmin0, (const float4*)woop_t, (const int32_t*)idx,
        (const int32_t*)counts, (const int32_t*)masks, (const int32_t*)offsets, n_items, cap,
        n_words, group, n_sub, ray_tile, cw, min_dst, (unsigned long long*)keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  items_final_kernel<<<(n_rays + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, st>>>(
      (const unsigned long long*)keys, (const float*)tmin0, (const int32_t*)tidx0,
      (const int32_t*)idx, n_rays, ray_tile, cap, group, cw, (float*)t_out, (int32_t*)tri_out);
  return (int)cudaGetLastError();
}
