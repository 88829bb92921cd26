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
//   flight while the current one is walked.  The result is order-free:
//   each ray's chunk minimum goes to one 64-bit atomicMin on a key holding
//   the float bits of t (t >= min_dst > 0 orders like the floats) above the
//   triangle id chunk * 128 + lane; the minimum key is the lexicographic
//   minimum of (t, triangle id) over the tested triangles, whatever order
//   the blocks run in and whatever order the worklists test them in, and a
//   final pass keeps (tmin0, tidx0) unless the key is below theirs.  So t
//   and tri equal the plain twin bit for bit and from run to run, and an
//   exact tie goes to the same triangle at any ray tile, gate or pass split.
//   No tensor cores: the Woop contraction is three terms deep and the
//   port's contract is IEEE rounding op for op under --fmad=false (t to 1
//   ulp of the twin); TF32 or bf16 products in wgmma would break it.  The
//   levers here are occupancy, the asynchronous staging and the shared
//   memory layout.
//
// K5  worklist_kernel
//   Replaces no TPU kernel: the bookkeeping of one pass of the cascade,
//   which the JAX package writes as jnp code around its Pallas kernels and
//   XLA fuses (tpu_pathtracer/ops/pallas_intersect.py:907 closest_hit_chunks,
//   with _group_stats, _worklist, _pack_group_masks and _live_block_bits),
//   and which the port ran as 34-50 small torch operations a pass.  One
//   launch writes what that chain writes, bit for bit, from the pass's
//   activity m8 / ent [T, C] and the groups the earlier passes listed
//   (tested [T, CG]): the group stats ga / ge, the front-to-back worklist
//   idx [T, cap] with its clamped counts, the mask words [T, cap, W], B2's
//   unit prefix sum (the port's item_unit_offsets), tested with this pass's
//   groups set, and the next recheck's gate words (_live_block_bits, ANDed
//   with the coarse gate).  Its twin is that chain,
//   ops/chunk_intersect.py:worklist_pass_plain.
//   Bound on the H100: bytes, m8 and ent read once (8 bytes per (tile,
//   chunk)); at the render's shapes one block's chain of dependent steps
//   (stats, sort, look-back, scan) sets the time, not the bytes.
//   Design: one block per ray tile, so no step but the unit prefix crosses
//   blocks.  A thread per group takes the group's stats and puts each active
//   untested group's key (entry bits in float order << 32 | group id) into a
//   row in shared memory, or in global scratch where the wrapper finds the
//   row too long (kernels.WORKLIST_SMEM_KEYS); a bitonic sort orders the
//   row, which is torch's stable argsort of where(ga, ge, inf) wherever an
//   active group's entry is finite (B1 gives a finite entry to every chunk
//   with a set bit).  The tile's unit total is
//   published for a decoupled look-back: blocks take tiles in the order they
//   start (a ticket), so a block waits only for blocks that already run, and
//   warp 0 sums its predecessors 32 at a time.  Then a thread per slot
//   writes its group id, mask words and tested bit, and a block-wide scan
//   of the slots' units gives the offsets.  The gate words take a warp per
//   512-chunk block and a shared word per 32 blocks.
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
    const unsigned tri0 = (unsigned)((idx[ts] * group + g) * cw);
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
      // A tie with tmin0 is settled on the triangle id by the final pass.
      if (best <= tmin0[i] && best < INFINITY)
        atomicMin(keys + i, tpt::make_key(best, tri0 + (unsigned)arg));
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
}

__global__ void items_final_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ tmin0,
    const int32_t* __restrict__ tidx0, int n_rays,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  tpt::decode_tri_key(keys[i], i, tmin0, tidx0, t_out, tri_out);
}

constexpr int kListThreads = 512;
constexpr int kListWarps = kListThreads / 32;
// Look-back words: the flag above a tile's unit count.
constexpr unsigned long long kTileTotal = 1ull << 32;   // the tile's own units
constexpr unsigned long long kTilePrefix = 2ull << 32;  // units up to and with the tile
constexpr unsigned kFull = 0xFFFFFFFFu;

// A float's bits as an unsigned key that orders like torch's sort of the
// floats: -0 equal to +0, NaN after +inf.
__device__ __forceinline__ unsigned float_order(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The exclusive prefix sum of v over the block's threads in thread order;
// *total gets the block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kListWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kListWarps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return before + x - v;
}

__global__ void __launch_bounds__(kListThreads) worklist_kernel(
    const int32_t* __restrict__ m8,     // [T, C] sub-tile bits of each chunk
    const float* __restrict__ ent,      // [T, C] entry of each chunk
    uint8_t* __restrict__ tested,       // [T, CG] groups the earlier passes listed (set here)
    const int32_t* __restrict__ cbits,  // [T, n_gate] coarse gate, or null
    int n_groups, int group, int cap, int n_words, int n_sub, int n_gate, int n_pad,
    unsigned long long* __restrict__ scratch,  // [T, n_pad] key rows, or null: shared memory
    unsigned long long* __restrict__ status,   // [1 + T] zero on entry: ticket, look-back words
    uint8_t* __restrict__ ga,           // [T, CG]
    float* __restrict__ ge,             // [T, CG]
    int32_t* __restrict__ idx,          // [T, cap]
    int32_t* __restrict__ counts,       // [T]
    int32_t* __restrict__ masks,        // [T, cap, n_words]
    int32_t* __restrict__ offsets,      // [T * cap * group]
    int32_t* __restrict__ gate) {       // [T, n_gate], or null
  extern __shared__ unsigned long long dyn[];
  __shared__ int s_tile, s_n, s_base;
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* s_gate = reinterpret_cast<unsigned*>(dyn + (scratch ? 0 : n_pad));  // [n_gate]
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(status, 1ull);
    s_n = 0;
  }
  for (int w = threadIdx.x; w < n_gate && gate; w += kListThreads) s_gate[w] = 0u;
  __syncthreads();
  const int tile = s_tile;
  const int n_cols = n_groups * group;
  const int32_t* m8_row = m8 + (size_t)tile * n_cols;
  const float* ent_row = ent + (size_t)tile * n_cols;
  const size_t g_row = (size_t)tile * n_groups;
  unsigned long long* keys = scratch ? scratch + (size_t)tile * n_pad : dyn;

  // Group stats; the key of each active untested group.
  for (int g = threadIdx.x; g < n_groups; g += kListThreads) {
    const int32_t* m = m8_row + (size_t)g * group;
    const float* e = ent_row + (size_t)g * group;
    bool act = false;
    float emin = e[0];
#pragma unroll 8
    for (int k = 0; k < group; ++k) {  // no short cut: the loads go out together
      act = act | (m[k] != 0);
      emin = tpt::nan_min(emin, e[k]);
    }
    const bool on = act && !tested[g_row + g];
    ga[g_row + g] = on;
    ge[g_row + g] = emin;
    if (on) keys[atomicAdd(&s_n, 1)] = (unsigned long long)float_order(emin) << 32 | (unsigned)g;
  }
  __syncthreads();
  const int n = s_n;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + threadIdx.x; i < n2; i += kListThreads) keys[i] = ~0ull;
  __syncthreads();

  // Bitonic sort of keys[0, n2): ascending (entry, group id).
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += kListThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const unsigned long long a = keys[lo], b = keys[lo + j];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }
  const int count = min(n, cap);
  if (threadIdx.x == 0) counts[tile] = count;
  // A slot's group: the sorted list; past the count the last in-count group
  // again (a retest changes nothing); group 0 in a tile with none.
  auto slot_group = [&](int s) {
    return count ? (int)(unsigned)(keys[min(s, count - 1)] & 0xFFFFFFFFull) : 0;
  };
  const unsigned submask = (1u << n_sub) - 1u;

  // The tile's units (the set sub-tile bits of its in-count slots), then its
  // base: the units of the tiles before it, by decoupled look-back.
  int units = 0;
  for (int s = threadIdx.x; s < count; s += kListThreads) {
    const int32_t* m = m8_row + (size_t)slot_group(s) * group;
#pragma unroll 8
    for (int k = 0; k < group; ++k) units += __popc((unsigned)m[k] & submask);
  }
  int tile_units;
  block_exclusive_sum(units, &tile_units, warp_sums);
  if (warp == 0) {
    int before = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status + 1, kTilePrefix | (unsigned)tile_units);
    } else {
      if (lane == 0) atomicExch(status + 1 + tile, kTileTotal | (unsigned)tile_units);
      for (int top = tile - 1;; top -= 32) {
        const int p = top - lane;  // lane 0: the nearest tile
        unsigned long long w = kTilePrefix;  // before the first tile: no units
        do {
          if (p >= 0) w = *reinterpret_cast<volatile unsigned long long*>(status + 1 + p);
        } while (__any_sync(kFull, (w >> 32) == 0));
        const unsigned pre = __ballot_sync(kFull, (w >> 32) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        int v = lane <= stop ? (int)(unsigned)(w & 0xFFFFFFFFull) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        before += v;
        if (pre) break;
      }
      if (lane == 0) atomicExch(status + 1 + tile, kTilePrefix | (unsigned)(before + tile_units));
    }
    if (lane == 0) s_base = before;
  }
  __syncthreads();

  // A thread per slot: its group, mask words and tested bit, and its items'
  // offsets (units of item (slot, k): the set bits of chunk k, none past
  // the count).
  int carry = s_base;
  for (int s0 = 0; s0 < cap; s0 += kListThreads) {
    const int s = s0 + threadIdx.x;
    const bool live = s < cap;
    const int g = live ? slot_group(s) : 0;
    const int32_t* m = m8_row + (size_t)g * group;
    int slot_units = 0;
    if (live) {
      const size_t ts = (size_t)tile * cap + s;
      idx[ts] = g;
      tested[g_row + g] = 1;
      for (int w = 0; w < n_words; ++w) {
        unsigned word = 0;
        for (int b = 0; b < 4 && 4 * w + b < group; ++b) word += (unsigned)m[4 * w + b] << (8 * b);
        masks[ts * n_words + w] = (int32_t)word;
      }
      if (s < count) {
#pragma unroll 8
        for (int k = 0; k < group; ++k) slot_units += __popc((unsigned)m[k] & submask);
      }
    }
    int round_units;
    int at = carry + block_exclusive_sum(slot_units, &round_units, warp_sums);
    if (live) {
      int32_t* out = offsets + ((size_t)tile * cap + s) * group;
      for (int k = 0; k < group; ++k) {
        if (s < count) at += __popc((unsigned)m[k] & submask);
        out[k] = at;
      }
    }
    carry += round_units;
  }

  if (gate) {
    // The next recheck's gate: a 512-chunk block is on while one of its
    // groups is active and still untested.
    __syncthreads();  // ga and tested, as written above
    const int n_blocks = (n_cols + kActCols - 1) / kActCols;
    for (int b = warp; b < n_blocks; b += kListWarps) {
      const int g0 = (int)((long long)kActCols * b / group);
      const int g1 = min(n_groups, (int)(((long long)kActCols * (b + 1) + group - 1) / group));
      bool live = false;
      for (int g = g0 + lane; g < g1; g += 32) live = live | (ga[g_row + g] && !tested[g_row + g]);
      if (__any_sync(kFull, live) && lane == 0) atomicOr(&s_gate[b / 32], 1u << (b % 32));
    }
    __syncthreads();
    for (int w = threadIdx.x; w < n_gate; w += kListThreads) {
      const size_t at = (size_t)tile * n_gate + w;
      unsigned word = s_gate[w];
      if (cbits) word &= (unsigned)cbits[at];
      gate[at] = (int32_t)word;
    }
  }
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
      (const unsigned long long*)keys, (const float*)tmin0, (const int32_t*)tidx0, n_rays,
      (float*)t_out, (int32_t*)tri_out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_worklist(
    const void* m8, const void* ent, void* tested, const void* cbits, int t_tiles,
    int n_groups, int group, int cap, int n_words, int n_sub, int n_gate, int n_pad,
    void* scratch, void* status, void* ga, void* ge, void* idx, void* counts, void* masks,
    void* offsets, void* gate, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(status, 0, (size_t)(t_tiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  // Shared memory: the key row (unless in scratch), then the gate words.
  const size_t smem = (scratch ? 0 : (size_t)n_pad * sizeof(unsigned long long)) +
                      (size_t)n_gate * sizeof(unsigned);
  worklist_kernel<<<t_tiles, kListThreads, smem, st>>>(
      (const int32_t*)m8, (const float*)ent, (uint8_t*)tested, (const int32_t*)cbits, n_groups,
      group, cap, n_words, n_sub, n_gate, n_pad, (unsigned long long*)scratch,
      (unsigned long long*)status, (uint8_t*)ga, (float*)ge, (int32_t*)idx, (int32_t*)counts,
      (int32_t*)masks, (int32_t*)offsets, (int32_t*)gate);
  return (int)cudaGetLastError();
}
