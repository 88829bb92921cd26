"""Chunk-skipping wavefront intersector: the counterpart of
``tpu_pathtracer/ops/pallas_intersect.py``.

Triangles come spatially ordered in chunks of 128 (``scene.chunk_woop``,
AABBs in ``scene.chunk_aabb_min/max``).  ``closest_hit_chunks`` runs the
intersector mode ``tuning.mode`` (``TPU_PT_INTERSECT``).  The default,
"items", is the cascade:

  super      one AABB per 512-chunk column block gates whole activity
             columns per ray tile (engaged past ``tuning.super_min``
             blocks);
  activity   per (ray tile, chunk): the slab test of every ray against the
             chunk AABB, packed into per-64-ray-sub-tile bits (``m8``) plus
             the tile's nearest entry distance (``ent``) — kernel B1;
  ladder     a few near passes, each testing the next-nearest ``cap`` active
             groups of 8 chunks per tile (front to back by entry distance),
             with the activity RECHECKED against each ray's best t so far
             in between (the wavefront form of the BVH's ordered-descent
             prune) — kernel B2 for the pair tests, B1 for the rechecks;
  residual   one final pass over everything still active and untested.

Every pass min-accumulates (t, triangle) with a strict ``<`` from the
previous pass's result, so retests are idempotent and the result is exactly
the closest hit over the union of tested chunks.  ``cheap_recheck``
(``TPU_PT_CHEAP_RECHECK``) 1 replaces every recheck, and 2 every recheck
but the last, by a comparison of the initial pass's sub-tile entry minima
with each sub-tile's largest best t (plain tensor code, looser, exact all
the same).  The other modes:

  twopass    the same cascade with the slot grid (kernel B6: a slot's
             group of chunks staged as one block) in place of B2;
  dense      every (tile, chunk) pair whose activity bit is set, in one
             bit-gated grid — kernel B5;
  bins       no tile prepass: per-ray group bits (kernel B7), group-major
             binned ray blocks, one B2 pass over them, scatter-min per ray;
             past ``bins_cap`` x R binned rows (``TPU_PT_BINS_CAP``) B5 runs
             instead on tile bits derived from the same per-ray bits.

The same machinery serves two more consumers: ``light_pdf_sum_chunks``, the
all-hits light pdf of scenes with more than 512 lights (B1 on the light
clusters' AABBs, a per-tile worklist of pierced clusters, kernel B3), and
``nearest_box_ids``, the worklist group each ray enters first (kernel B4),
which the "target" wavefront sort key orders by.  The other sort keys
("hint", "dirhint", "cell") are plain tensor code at the end.

The kernels are hand-written CUDA (``csrc/chunk_kernels.cu`` for B1/B2,
``csrc/light_sort_kernels.cu`` for B3/B4, ``csrc/mode_kernels.cu`` for
B5-B7, bound in ``kernels.py``).  Each wrapper here has a plain-torch twin
with the same signature; a CPU tensor goes to the twin, a CUDA tensor to
the kernel, and anything else raises.  Each wrapper counts its kernel
launches in its ``launches`` attribute.

Not ported: the SMEM-budget machinery of the TPU's 1 MB scalar memory
(``max_cap``, ``light_items``, the merged prefetch rows) and what it forced:
the iterating residual, the count-bucketed residual caps of "twopass", and
the light pdf's item windows with their ``sum0`` chaining and visited-tile
patch — on the GPU the residual is always one pass and a block reads its
tile's whole worklist.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import IntersectTuning
from ..kernels import made_once
from .intersect import Hit, winner_barycentrics

RAY_TILE = 512  # rays per tile
CHUNK_TRIS = 128  # triangles per chunk
GROUP = 8  # chunks per worklist group
ACT_COLS = 512  # chunks per super-block (coarse gate granularity)
_INF = float("inf")


def pack_rays(origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """[R, 3] x 2 -> [R, 8] homogeneous rows (o, 1, d, 0)."""
    r = origin.shape[0]
    one = torch.ones((r, 1), dtype=origin.dtype, device=origin.device)
    return torch.cat([origin, one, direction, one * 0], dim=1).contiguous()


def _nan_pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad the leading dim to ``rows`` with NaN (never-hit boxes / Woop)."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    fill = torch.full((pad,) + tuple(x.shape[1:]), float("nan"), dtype=x.dtype, device=x.device)
    return torch.cat([x, fill])


# NaN-padded copies of a scene's chunk tensors, keyed on the identity of the
# source tensor and the padded row count.
_PADDED: dict = {}


def _nan_pad_once(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``_nan_pad(x, rows).contiguous()``, made once per source tensor
    (``kernels.made_once``): a scene's chunk tensors are padded at the first
    call and found again at every later one, so ``kernels.triangle_major``
    finds its copy too."""
    if rows <= x.shape[0]:
        return x.contiguous()
    return made_once(_PADDED, (id(x), rows), x, lambda: _nan_pad(x, rows).contiguous())


def _wrap_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 bit patterns -> int32 with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _bitpack(act: torch.Tensor) -> torch.Tensor:
    """[T, C] 0/1 -> [T, ceil(C/32)] int32 words (bit k of word w = column
    32w + k), composed with shifts and OR."""
    t_tiles, c = act.shape
    bits = F.pad(act.to(torch.int64), (0, (-c) % 32)).reshape(t_tiles, -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=act.device)
    return _wrap_i32((bits << shifts).sum(dim=-1))


def _nanmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmin``: NaN entries ignored, all-NaN slices give NaN."""
    nan = torch.isnan(x)
    m = torch.where(nan, torch.full_like(x, _INF), x).amin(dim=dim)
    return torch.where(nan.all(dim=dim), torch.full_like(m, float("nan")), m)


def _nanmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return -_nanmin(-x, dim)


def group_boxes(chunk_min: torch.Tensor, chunk_max: torch.Tensor, group: int = GROUP):
    """Chunk AABBs -> AABBs of consecutive ``group``-chunk runs (NaN pad rows
    vanish; an all-NaN run yields a NaN, never-hit box)."""
    c = chunk_min.shape[0]
    n = -(-c // group) * group
    lo = _nan_pad(chunk_min, n).reshape(-1, group, 3)
    hi = _nan_pad(chunk_max, n).reshape(-1, group, 3)
    return _nanmin(lo, 1), _nanmax(hi, 1)


# --------------------------------------------------------------------------
# Kernel B1: tile x chunk activity (replaces pallas_intersect._activity_body)
# --------------------------------------------------------------------------


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with a zero component taken as 1e-30, so an origin on a slab
    plane gives t = 0 instead of 0 * inf = NaN."""
    return 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)


def _slab(o: torch.Tensor, inv: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor):
    """[R, 3] origins and reciprocal directions x [B, 3] boxes -> the slab
    interval (t_lo, t_hi), each [R, B], in the kernels' operation order;
    ``torch.minimum/maximum`` propagate NaN, so NaN boxes give NaN."""
    t_lo = t_hi = None
    for a in range(3):
        t1 = (bmin[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t2 = (bmax[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        t_lo = lo if t_lo is None else torch.maximum(t_lo, lo)
        t_hi = hi if t_hi is None else torch.minimum(t_hi, hi)
    return t_lo, t_hi


def tile_chunk_activity_plain(
    rays: torch.Tensor,  # [R, 8] (o, 1, d, 0)
    cmin: torch.Tensor,  # [C, 3] (NaN rows never activate)
    cmax: torch.Tensor,  # [C, 3]
    tbest: Optional[torch.Tensor],  # [R] per-ray far bound (None = inf)
    coarse_bits: Optional[torch.Tensor],  # [T, ceil(nb/32)] 512-column gate
    min_dst: float,
    ray_tile: int,
    n_sub: int,
    want_sub: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain twin of the B1 kernel.  Returns (m8 [T, C] int32: bit s = some
    ray of sub-tile s qualifies; ent [T, C] f32: min over qualifying rays of
    max(t_enter, min_dst), +inf if none; sub_ent [T, n_sub, C] or None).

    A ray qualifies for a chunk when ``t_lo <= t_hi & t_hi >= min_dst &
    t_lo <= tbest``; a zero direction component is taken as 1e-30 so an
    origin on a slab plane gives t = 0 instead of 0 * inf = NaN, and
    ``torch.minimum/maximum`` propagate NaN so NaN boxes never qualify."""
    r = rays.shape[0]
    c = cmin.shape[0]
    t_tiles = r // ray_tile
    rows = ray_tile // n_sub
    o = rays[:, 0:3]
    inv = _inv_dir(rays[:, 4:7])
    tb = (torch.full((r,), _INF, device=rays.device) if tbest is None else tbest)[:, None]
    sub_ent = torch.full((t_tiles, n_sub, c), _INF, device=rays.device)
    for b, c0 in enumerate(range(0, c, ACT_COLS)):
        c1 = min(c0 + ACT_COLS, c)
        t_lo, t_hi = _slab(o, inv, cmin[c0:c1], cmax[c0:c1])
        hit = (t_lo <= t_hi) & (t_hi >= min_dst) & (t_lo <= tb)
        entry = torch.where(hit, torch.clamp_min(t_lo, min_dst), torch.full_like(t_lo, _INF))
        blk = entry.reshape(t_tiles, n_sub, rows, c1 - c0).amin(dim=2)
        if coarse_bits is not None:
            on = ((coarse_bits[:, b // 32] >> (b % 32)) & 1) > 0  # [T]
            blk = torch.where(on[:, None, None], blk, torch.full_like(blk, _INF))
        sub_ent[:, :, c0:c1] = blk
    fin = torch.isfinite(sub_ent).to(torch.int32)
    shifts = torch.arange(n_sub, dtype=torch.int32, device=rays.device)[None, :, None]
    m8 = (fin << shifts).sum(dim=1, dtype=torch.int32)
    ent = sub_ent.amin(dim=1)
    return m8, ent, (sub_ent if want_sub else None)


def tile_chunk_activity(
    rays: torch.Tensor,
    cmin: torch.Tensor,
    cmax: torch.Tensor,
    tbest: Optional[torch.Tensor],
    coarse_bits: Optional[torch.Tensor],
    min_dst: float,
    ray_tile: int,
    n_sub: int = 1,
    want_sub: bool = False,
):
    """B1 wrapper: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors (see ``tile_chunk_activity_plain`` for the contract)."""
    if rays.is_cuda:
        from .. import kernels

        out = kernels.activity(
            rays, cmin, cmax, tbest, coarse_bits, min_dst, ray_tile, n_sub, want_sub
        )
        tile_chunk_activity.launches += 1
        return out
    if rays.device.type == "cpu":
        return tile_chunk_activity_plain(
            rays, cmin, cmax, tbest, coarse_bits, min_dst, ray_tile, n_sub, want_sub
        )
    raise RuntimeError(f"tile_chunk_activity: no kernel for device {rays.device}")


tile_chunk_activity.launches = 0


# --------------------------------------------------------------------------
# Kernel B2: per-tile worklist of Woop pair tests (replaces _kernel_items)
# --------------------------------------------------------------------------


def _contract_o(o, w, r0):
    """(o, 1) against Woop rows r0..r0+2 + constant row r0+3, in the
    kernels' operation order: ((o0*w0 + w3) + o1*w1) + o2*w2."""
    acc = o[..., 0:1] * w[:, None, r0] + w[:, None, r0 + 3]
    acc = acc + o[..., 1:2] * w[:, None, r0 + 1]
    return acc + o[..., 2:3] * w[:, None, r0 + 2]


def _contract_d(d, w, r0):
    """(d, 0) against Woop rows r0..r0+2: (d0*w0 + d1*w1) + d2*w2."""
    acc = d[..., 0:1] * w[:, None, r0]
    acc = acc + d[..., 1:2] * w[:, None, r0 + 1]
    return acc + d[..., 2:3] * w[:, None, r0 + 2]


def _chunk_first_min(o, d, w, min_dst: float):
    """Woop test of [T, RT] rays against one chunk per tile (w [T, 12, CW]):
    per ray the first minimum t over the chunk's triangles (inf if none)
    and its lane."""
    p0, p1, p2 = (_contract_o(o, w, k) for k in (0, 4, 8))
    q0, q1, q2 = (_contract_d(d, w, k) for k in (0, 4, 8))
    tt = -p2 / q2
    beta = p0 + tt * q0
    gamma = p1 + tt * q1
    ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (tt >= min_dst)
    return torch.where(ok, tt, torch.full_like(tt, _INF)).min(dim=-1)


def run_items_plain(
    rays: torch.Tensor,  # [R, 8]
    tmin0: torch.Tensor,  # [R] f32 best t so far
    tidx0: torch.Tensor,  # [R] int32 its triangle
    chunk_woop: torch.Tensor,  # [CG*group, 12, CW]
    idx: torch.Tensor,  # [T, cap] int32 group ids, front to back
    counts: torch.Tensor,  # [T] int32 valid slots per tile
    masks: torch.Tensor,  # [T, cap, W] int32: byte g%4 of word g//4 = sub-tile bits of chunk g
    min_dst: float,
    group: int,
    n_sub: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the B2 kernel: for every tile, every valid slot s in
    order, every chunk g of group idx[tile, s] and every sub-tile whose mask
    bit is set, the Woop test of the sub-tile's rays against the chunk's
    triangles; per ray the first minimum t over the chunk, taken when
    strictly below the ray's current best.  Returns (t [R], tri [R])."""
    t_tiles, cap = idx.shape
    r = rays.shape[0]
    rt = r // t_tiles
    cw = chunk_woop.shape[-1]
    o = rays[:, 0:3].reshape(t_tiles, rt, 3)
    d = rays[:, 4:7].reshape(t_tiles, rt, 3)
    t = tmin0.reshape(t_tiles, rt).clone()
    tri = tidx0.reshape(t_tiles, rt).clone()
    sub_of_ray = torch.arange(rt, device=rays.device) // (rt // n_sub)
    n_slots = int(counts.max()) if counts.numel() else 0
    for s in range(n_slots):
        live = counts > s
        chunks0 = idx[:, s].long() * group
        for g in range(group):
            mask = (masks[:, s, g // 4] >> (8 * (g % 4))) & 0xFF  # [T]
            ray_on = live[:, None] & (((mask[:, None] >> sub_of_ray[None, :]) & 1) > 0)
            chunk = chunks0 + g
            cmin_t, carg = _chunk_first_min(o, d, chunk_woop[chunk], min_dst)
            better = ray_on & (cmin_t < t)
            t = torch.where(better, cmin_t, t)
            tri = torch.where(better, (chunk[:, None] * cw + carg).to(torch.int32), tri)
    return t.reshape(r), tri.reshape(r)


def _item_unit_counts(counts: torch.Tensor, masks: torch.Tensor, group: int, n_sub: int):
    """[T, cap, group] int32: the set sub-tile bits of each chunk item (tile,
    slot, g), 0 for the slots past a tile's count.  Pure tensor code with no
    copy to or from the host (a blocking copy would make the host wait for
    the device at every launch)."""
    cap = masks.shape[1]
    # Byte g of a slot's words is chunk g's sub-tile bits (little-endian).
    byte = masks.view(torch.uint8)[:, :, :group]
    shifts = torch.arange(n_sub, dtype=torch.uint8, device=masks.device)
    units = ((byte[..., None] >> shifts) & 1).sum(dim=3, dtype=torch.int32)
    live = torch.arange(cap, device=masks.device)[None, :] < counts[:, None]
    return units * live[:, :, None]


def item_unit_offsets(counts: torch.Tensor, masks: torch.Tensor, group: int, n_sub: int):
    """The B2 kernel's flattened unit list, in compressed form.

    A unit is one (tile, slot, chunk, sub-tile) whose mask bit is set, with
    slot < counts[tile]; the units of chunk item (tile, slot, g) are its set
    sub-tile bits in ascending order, and items are numbered in test order,
    item = (tile * cap + slot) * group + g.  Returns the inclusive prefix
    sum of the items' unit counts, [T * cap * group] int32: the units of
    item j are numbers offsets[j-1] .. offsets[j]-1, and offsets[-1] is the
    total."""
    units = _item_unit_counts(counts, masks, group, n_sub)
    return torch.cumsum(units.reshape(-1), 0, dtype=torch.int32)


def slot_unit_offsets(counts: torch.Tensor, masks: torch.Tensor, group: int, n_sub: int):
    """The B6 kernel's unit list: the same units in the same order as
    ``item_unit_offsets``, counted per slot.  Returns the inclusive prefix
    sum of the slots' unit counts, [T * cap] int32, slot = tile * cap + s: a
    slot past its tile's count, or with no set bit, has no unit (its entry
    equals the one before), the units of slot j are numbers offsets[j-1] ..
    offsets[j]-1 in (chunk, sub-tile) order, and offsets[-1] is the total."""
    units = _item_unit_counts(counts, masks, group, n_sub).sum(dim=2)
    return torch.cumsum(units.reshape(-1), 0, dtype=torch.int32)


def run_items(rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub):
    """B2 wrapper: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors (see ``run_items_plain`` for the contract)."""
    if rays.is_cuda:
        from .. import kernels

        out = kernels.items(
            rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub
        )
        run_items.launches += 1
        return out
    if rays.device.type == "cpu":
        return run_items_plain(
            rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub
        )
    raise RuntimeError(f"run_items: no kernel for device {rays.device}")


run_items.launches = 0


# --------------------------------------------------------------------------
# Kernel B5: bit-gated dense grid (replaces pallas_intersect._kernel_dense)
# --------------------------------------------------------------------------


def run_dense_plain(
    rays: torch.Tensor,  # [R, 8]
    tmin0: torch.Tensor,  # [R] f32 best t so far
    tidx0: torch.Tensor,  # [R] int32 its triangle
    chunk_woop: torch.Tensor,  # [C, 12, CW]
    bits: torch.Tensor,  # [T, ceil(C/32)] int32: bit j%32 of word j//32 = chunk j active
    min_dst: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the B5 kernel: for every tile and every chunk j whose
    activity bit is set, the Woop test of the tile's rays against the
    chunk, min-accumulated with a strict < over (tmin0, tidx0), walking the
    chunks in ascending order; so on ties the smallest triangle id among
    equal t wins.  Returns (t [R], tri [R])."""
    t_tiles = bits.shape[0]
    r = rays.shape[0]
    rt = r // t_tiles
    c, _, cw = chunk_woop.shape
    o = rays[:, 0:3].reshape(t_tiles, rt, 3)
    d = rays[:, 4:7].reshape(t_tiles, rt, 3)
    t = tmin0.reshape(t_tiles, rt).clone()
    tri = tidx0.reshape(t_tiles, rt).clone()
    shifts = torch.arange(32, dtype=torch.int64, device=rays.device)
    act = (((bits.to(torch.int64)[:, :, None] >> shifts) & 1) > 0).reshape(t_tiles, -1)[:, :c]
    for j in act.any(dim=0).nonzero()[:, 0].tolist():  # chunks no tile needs cost nothing
        cmin_t, carg = _chunk_first_min(o, d, chunk_woop[j:j + 1], min_dst)
        better = act[:, j:j + 1] & (cmin_t < t)
        t = torch.where(better, cmin_t, t)
        tri = torch.where(better, (j * cw + carg).to(torch.int32), tri)
    return t.reshape(r), tri.reshape(r)


def run_dense(rays, tmin0, tidx0, chunk_woop, bits, min_dst):
    """B5 wrapper: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors (see ``run_dense_plain`` for the contract)."""
    if rays.is_cuda:
        from .. import kernels

        out = kernels.dense(rays, tmin0, tidx0, chunk_woop, bits, min_dst)
        run_dense.launches += 1
        return out
    if rays.device.type == "cpu":
        return run_dense_plain(rays, tmin0, tidx0, chunk_woop, bits, min_dst)
    raise RuntimeError(f"run_dense: no kernel for device {rays.device}")


run_dense.launches = 0


# --------------------------------------------------------------------------
# Kernel B6: per-tile slot grid of Woop pair tests (replaces _kernel_pass)
# --------------------------------------------------------------------------


# Plain twin of the B6 kernel.  The slot grid computes the function B2
# computes (tile i, slots s < counts[i] in slot order, strict <), so its twin
# is B2's; the kernels differ in how the card runs it (a slot's whole group
# staged once for a block's warps against one chunk staged per unit).
run_slots_plain = run_items_plain


def run_slots(rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub):
    """B6 wrapper: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors (mode "twopass")."""
    if rays.is_cuda:
        from .. import kernels

        out = kernels.slots(
            rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub
        )
        run_slots.launches += 1
        return out
    if rays.device.type == "cpu":
        return run_slots_plain(
            rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub
        )
    raise RuntimeError(f"run_slots: no kernel for device {rays.device}")


run_slots.launches = 0


# --------------------------------------------------------------------------
# Kernel B7: per-ray group bits (replaces pallas_intersect._ray_group_kernel)
# --------------------------------------------------------------------------


def ray_group_bools_plain(
    rays: torch.Tensor,  # [R, 8]
    cmin: torch.Tensor,  # [CPAD, 3], CPAD a multiple of ACT_COLS (NaN rows never match)
    cmax: torch.Tensor,  # [CPAD, 3]
    min_dst: float,
    group: int,
) -> torch.Tensor:
    """Plain twin of the B7 kernel: [CPAD // group, R] int32 (group-major),
    1 where the ray's slab test passes (t_lo <= t_hi, t_hi >= min_dst; no
    far bound) for any of the group's ``group`` chunk AABBs."""
    r = rays.shape[0]
    o = rays[:, 0:3]
    inv = _inv_dir(rays[:, 4:7])
    gpb = ACT_COLS // group
    out = torch.empty((cmin.shape[0] // group, r), dtype=torch.int32, device=rays.device)
    for b, c0 in enumerate(range(0, cmin.shape[0], ACT_COLS)):
        t_lo, t_hi = _slab(o, inv, cmin[c0:c0 + ACT_COLS], cmax[c0:c0 + ACT_COLS])
        hit = (t_lo <= t_hi) & (t_hi >= min_dst)
        out[b * gpb:(b + 1) * gpb] = hit.reshape(r, gpb, group).any(dim=2).T.to(torch.int32)
    return out


def ray_group_bools(rays, chunk_min, chunk_max, min_dst: float, group: int = GROUP):
    """Per-ray group bits [CPAD // group, R] int32: B7 for CUDA tensors, its
    twin for CPU tensors, on the chunks NaN-padded to a multiple of
    ``ACT_COLS`` as the JAX package pads them (callers keep the first
    ceil(C / group) rows)."""
    cpad = -(-chunk_min.shape[0] // ACT_COLS) * ACT_COLS
    cmin = _nan_pad_once(chunk_min, cpad)
    cmax = _nan_pad_once(chunk_max, cpad)
    if rays.is_cuda:
        from .. import kernels

        out = kernels.ray_groups(rays, cmin, cmax, min_dst, group)
        ray_group_bools.launches += 1
        return out
    if rays.device.type == "cpu":
        return ray_group_bools_plain(rays, cmin, cmax, min_dst, group)
    raise RuntimeError(f"ray_group_bools: no kernel for device {rays.device}")


ray_group_bools.launches = 0


# --------------------------------------------------------------------------
# Cascade glue (plain tensor code around the kernels)
# --------------------------------------------------------------------------


def super_block_bits(rays, chunk_min, chunk_max, min_dst, ray_tile, tbest=None):
    """Coarse gate: one AABB per ``ACT_COLS``-chunk column block, slab-tested
    by B1 at trivial width, bit-packed to [T, ceil(nb/32)] int32.  Valid for
    every recheck too (a per-ray t bound only shrinks activity); ``tbest``
    gives the t-bounded form."""
    cb_min, cb_max = group_boxes(chunk_min, chunk_max, ACT_COLS)
    m8, _, _ = tile_chunk_activity(rays, cb_min, cb_max, tbest, None, min_dst, ray_tile)
    return _bitpack(m8 != 0)


def _group_stats(act: torch.Tensor, ent: torch.Tensor, group: int):
    """Chunk level -> group level: a group is active when any chunk is; its
    entry is the nearest chunk entry."""
    t_tiles, c = act.shape
    ga = act.reshape(t_tiles, c // group, group).any(dim=2)
    ge = ent.reshape(t_tiles, c // group, group).amin(dim=2)
    return ga, ge


def _worklist(ga: torch.Tensor, ge: torch.Tensor, cap: int):
    """Front-to-back per-tile worklist over active groups: (idx [T, cap]
    int32, counts_c [T] = min(count, cap), counts [T]).  Slots past the
    count repeat the last in-count id (retests are idempotent)."""
    t_tiles = ga.shape[0]
    key = torch.where(ga, ge, torch.full_like(ge, _INF))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = ga.sum(dim=1, dtype=torch.int32)
    counts_c = torch.clamp_max(counts, cap)
    idx = order[:, :cap]
    last = idx.gather(1, torch.clamp_min(counts_c - 1, 0)[:, None].long())
    pos = torch.arange(cap, device=ga.device)[None, :]
    return torch.where(pos < counts_c[:, None], idx, last), counts_c, counts


def _pack_group_masks(m8: torch.Tensor, group: int) -> torch.Tensor:
    """[T, C] per-chunk sub-tile bytes -> [T, CG, W] int32 per-group words
    (chunk k of a group owns byte k%4 of word k//4), by shifts and OR."""
    t_tiles, c = m8.shape
    w = -(-group // 4)
    mg = F.pad(m8.reshape(t_tiles, c // group, group).to(torch.int64), (0, 4 * w - group))
    shifts = 8 * torch.arange(4, dtype=torch.int64, device=m8.device)
    return _wrap_i32((mg.reshape(t_tiles, c // group, w, 4) << shifts).sum(dim=-1))


def _live_block_bits(live: torch.Tensor, group: int) -> torch.Tensor:
    """[T, CG] groups still worth rechecking -> [T, ceil(nb/32)] gate words
    per ``ACT_COLS`` column block (a recheck result is only consumed as
    ``act & ~tested`` and only shrinks, so blocks with no live group can be
    skipped)."""
    t_tiles = live.shape[0]
    lc = live.repeat_interleave(group, dim=1)
    lc = F.pad(lc, (0, (-lc.shape[1]) % ACT_COLS))
    return _bitpack(lc.reshape(t_tiles, -1, ACT_COLS).any(dim=2))


def _bins_worklist(gb: torch.Tensor, br: int, p_cap: int):
    """Group-major binned ray list from the [CG, R] per-ray group bits: each
    pierced (group, ray) pair is one row, and each group's segment is padded
    to ``br``-row blocks.  Returns (r_pad [P_pad] int32 ray per row, -1 =
    padding; block_group [NB] int32 group of each block; n_blocks [] int32
    used blocks; overflow [] bool: more than ``p_cap`` pairs, or padded rows
    past the capacity)."""
    cg, r = gb.shape
    dev = gb.device
    counts = gb.sum(dim=1, dtype=torch.int64)
    fid = torch.nonzero(gb.reshape(-1) > 0)[:p_cap, 0]
    fid = torch.cat([fid, torch.full((p_cap - fid.shape[0],), cg * r, device=dev)])
    valid = fid < cg * r
    g = torch.where(valid, fid // r, cg - 1)
    rid = (fid % r).to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    seg_start = torch.cat([zero, torch.cumsum(counts, 0)])
    pad_start = torch.cat([zero, torch.cumsum((counts + br - 1) // br, 0)]) * br
    p_pad_cap = p_cap + cg * (br - 1)  # worst padding: every group partial
    nb_cap = p_pad_cap // br + 1
    p_pad_cap = nb_cap * br
    dst = pad_start[g] + (torch.arange(p_cap, device=dev) - seg_start[g])
    dst = torch.where(valid, torch.clamp(dst, 0, p_pad_cap), p_pad_cap)
    # One spare row past the end takes the dropped writes.
    r_pad = torch.full((p_pad_cap + 1,), -1, dtype=torch.int32, device=dev)
    r_pad[dst] = rid
    boundaries = torch.where(counts > 0, pad_start[:cg] // br, nb_cap).clamp_max(nb_cap)
    bg = torch.full((nb_cap + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, boundaries, torch.arange(cg, device=dev), "amax"
    )
    bg = torch.cummax(bg[:nb_cap], 0).values
    overflow = (seg_start[cg] > p_cap) | (pad_start[cg] > p_pad_cap)
    n_blocks = torch.clamp_max(pad_start[cg] // br, nb_cap).to(torch.int32)
    return r_pad[:p_pad_cap], bg.clamp_min(0).to(torch.int32), n_blocks, overflow


def _closest_hit_bins(rays, chunk_woop, chunk_min, chunk_max, min_dst: float, ray_tile: int,
                      group: int, bins_cap: int):
    """Mode "bins": per-ray group bits (B7) -> group-major binned ray blocks
    -> one B2 pass whose tiles are the binned blocks (one group each, every
    sub-tile on) -> scatter-min per ray, ties to the smallest triangle among
    exactly equal t (the dense sweep's order).  When the pairs overflow
    ``bins_cap`` x R rows, B5 runs instead on tile bits derived from the same
    per-ray bits; the flag is read on the host (one sync per call).  Returns
    (t [R], tri [R])."""
    r = rays.shape[0]
    dev = rays.device
    t_tiles = r // ray_tile
    cg = chunk_woop.shape[0] // group
    gb = ray_group_bools(rays, chunk_min, chunk_max, min_dst, group)[:cg]
    r_pad, bgrp, n_blocks, overflow = _bins_worklist(gb, ray_tile, r * bins_cap)
    if bool(overflow):
        act = (gb > 0).reshape(cg, t_tiles, ray_tile).any(dim=2).T  # [T, CG]
        return run_dense(
            rays, torch.full((r,), _INF, device=dev), torch.zeros((r,), dtype=torch.int32, device=dev),
            chunk_woop, _bitpack(act.repeat_interleave(group, dim=1)), min_dst,
        )
    live = r_pad >= 0
    rb = rays[torch.clamp_min(r_pad, 0).long()]
    # Padding rows: origin parked far away (the dead-lane convention).
    rb = torch.cat([torch.where(live[:, None], rb[:, 0:4], torch.full_like(rb[:, 0:4], 1e30)),
                    rb[:, 4:8]], dim=1)
    p_pad = r_pad.shape[0]
    nb = p_pad // ray_tile
    counts = (torch.arange(nb, device=dev) < n_blocks).to(torch.int32)
    masks = torch.full((nb, 1, -(-group // 4)), -1, dtype=torch.int32, device=dev)
    t_rows, i_rows = run_items(
        rb.contiguous(), torch.full((p_pad,), _INF, device=dev),
        torch.zeros((p_pad,), dtype=torch.int32, device=dev), chunk_woop,
        bgrp[:, None].contiguous(), counts, masks, min_dst, group, 1,
    )
    rid = torch.where(live, r_pad, r).long()
    t_flat = torch.where(live, t_rows, torch.full_like(t_rows, _INF))
    tb = torch.full((r + 1,), _INF, device=dev).scatter_reduce(0, rid, t_flat, "amin")
    won = live & torch.isfinite(t_flat) & (t_flat == tb[rid])
    trib = torch.full((r + 1,), 1 << 30, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(won, rid, r), i_rows, "amin"
    )
    tb = tb[:r]
    return tb, torch.where(torch.isfinite(tb), trib[:r], torch.zeros_like(trib[:r]))


def _winner(rays, woop_rows, t_best, tri) -> Hit:
    """Hit record of the closest hits: winner barycentrics from one [R, 12]
    row gather (rows[t, 4j+k])."""
    r = rays.shape[0]
    hit = torch.isfinite(t_best)
    tri_safe = torch.where(hit, tri, torch.zeros_like(tri))
    w = woop_rows[tri_safe.long()].reshape(r, 3, 4).transpose(1, 2)
    _, beta, gamma = winner_barycentrics(rays[:, 0:4], rays[:, 4:8], w)
    zero = torch.zeros_like(beta)
    return Hit(
        t=torch.where(hit, t_best, torch.full_like(t_best, _INF)),
        tri=tri_safe,
        beta=torch.where(hit, beta, zero),
        gamma=torch.where(hit, gamma, zero),
        hit=hit,
    )


MODES = ("items", "twopass", "dense", "bins")


def check_tuning(tuning: IntersectTuning) -> None:
    """Raise ``ValueError`` for an intersect mode or cheap_recheck form that
    no code path runs (a typo would otherwise time the wrong variant)."""
    if tuning.mode not in MODES:
        raise ValueError(
            f"unknown intersect mode {tuning.mode!r} (TPU_PT_INTERSECT): expected "
            + " | ".join(MODES)
        )
    if tuning.cheap_recheck not in (0, 1, 2):
        raise ValueError(
            f"unknown cheap_recheck {tuning.cheap_recheck!r} (TPU_PT_CHEAP_RECHECK): "
            "expected 0 | 1 | 2"
        )


def closest_hit_chunks(
    origin: torch.Tensor,  # [R, 3], R % ray_tile == 0
    direction: torch.Tensor,  # [R, 3]
    chunk_woop: torch.Tensor,  # [C, 12, CHUNK_TRIS]
    chunk_min: torch.Tensor,  # [C, 3]
    chunk_max: torch.Tensor,  # [C, 3]
    woop_rows: torch.Tensor,  # [N, 12] winner-barycentric view
    min_dst: float,
    ray_tile: int = RAY_TILE,
    group: int = GROUP,
    tuning: IntersectTuning | None = None,
) -> Hit:
    """Closest hit through the intersector mode ``tuning.mode`` (see the
    module doc).  Equal to a brute force over every triangle in the same
    arithmetic up to exact-t ties, except where a ray's own rounded slab
    test cannot reach the chunk of a hit (a hit on a chunk's AABB face, or a
    few 1e-4 from a surface-spawned origin), which the JAX package's modes
    share."""
    tuning = (tuning or IntersectTuning()).resolve()
    check_tuning(tuning)
    mode = tuning.mode
    r = origin.shape[0]
    if r % ray_tile:
        raise ValueError(f"ray count {r} is not a multiple of the ray tile {ray_tile}")
    t_tiles = r // ray_tile
    sub_rows = tuning.sub_rows
    n_sub = max(1, min(8, ray_tile // sub_rows)) if ray_tile % sub_rows == 0 else 1

    c = chunk_woop.shape[0]
    cg = -(-c // group)
    chunk_woop = _nan_pad_once(chunk_woop, cg * group)
    chunk_min = _nan_pad_once(chunk_min, cg * group)
    chunk_max = _nan_pad_once(chunk_max, cg * group)
    rays = pack_rays(origin, direction)
    if mode == "bins":  # no tile activity prepass
        t_best, tri = _closest_hit_bins(
            rays, chunk_woop, chunk_min, chunk_max, min_dst, ray_tile, group, tuning.bins_cap
        )
        return _winner(rays, woop_rows, t_best, tri)
    t_inf = torch.full((r,), _INF, device=rays.device)
    i_zero = torch.zeros((r,), dtype=torch.int32, device=rays.device)

    n_blocks = -(-cg * group // ACT_COLS)
    cbits = None
    if n_blocks > tuning.super_min:
        cbits = super_block_bits(rays, chunk_min, chunk_max, min_dst, ray_tile)
    # Cheap rechecks compare the initial pass's sub-tile entry minima.
    cheap = tuning.cheap_recheck if n_sub > 1 else 0
    m8, ent, sub_ent0 = tile_chunk_activity(
        rays, chunk_min, chunk_max, None, cbits, min_dst, ray_tile, n_sub, want_sub=cheap != 0
    )
    if mode == "dense":
        t_best, tri = run_dense(rays, t_inf, i_zero, chunk_woop, _bitpack(m8 != 0), min_dst)
        return _winner(rays, woop_rows, t_best, tri)
    _, ge = _group_stats(m8 != 0, ent, group)

    def recheck(t_c, live, final):
        """Activity under each ray's best t so far.  Full form: the slab
        test again with the per-ray bound, gated to the column blocks that
        still hold an active untested group.  Cheap form (cheap_recheck 1
        everywhere, 2 between near passes only): the stored sub-tile entry
        minima against the sub-tile maximum of the per-ray bound."""
        if cheap == 1 or (cheap == 2 and not final):
            tb_sub = t_c.reshape(t_tiles, n_sub, ray_tile // n_sub).amax(dim=2)
            ok = torch.isfinite(sub_ent0) & (sub_ent0 <= tb_sub[:, :, None])
            shifts = torch.arange(n_sub, dtype=torch.int32, device=rays.device)[None, :, None]
            return (ok.to(torch.int32) << shifts).sum(dim=1, dtype=torch.int32)
        gate = cbits
        if tuning.gate_recheck:
            gate = _live_block_bits(live, group)
            if cbits is not None:
                gate = gate & cbits
        if cbits is not None and tuning.super_tbound_min and n_blocks >= tuning.super_tbound_min:
            gate = gate & super_block_bits(
                rays, chunk_min, chunk_max, min_dst, ray_tile, tbest=t_c
            )
        return tile_chunk_activity(
            rays, chunk_min, chunk_max, t_c, gate, min_dst, ray_tile, n_sub
        )[0]

    def run_pass(m8_p, ga_p, cap, t_c, i_c):
        """One worklist pass: B6's slot grid under "twopass", B2 otherwise."""
        idx, counts, _ = _worklist(ga_p, ge, cap)
        masks = torch.take_along_dim(
            _pack_group_masks(m8_p, group), idx[:, :, None].long(), dim=1
        )
        kernel = run_slots if mode == "twopass" else run_items
        t_c, i_c = kernel(
            rays, t_c, i_c, chunk_woop, idx.contiguous(), counts.contiguous(),
            masks.contiguous(), min_dst, group, n_sub,
        )
        return t_c, i_c, idx

    base = max(tuning.pass1_min, cg // 9)
    ladder = [int(x) * base // 4 for x in tuning.near.split(",")]
    near_caps = [min(cap, cg) for cap in ladder if cap < cg]
    tested = torch.zeros((t_tiles, cg), dtype=torch.bool, device=rays.device)
    t_cur, i_cur = t_inf, i_zero
    m8_p = m8
    for k, cap in enumerate(near_caps):
        ga_p = _group_stats(m8_p != 0, ent, group)[0] & ~tested
        t_cur, i_cur, idx = run_pass(m8_p, ga_p, cap, t_cur, i_cur)
        tested.scatter_(1, idx.long(), True)
        m8_p = recheck(t_cur, ga_p & ~tested, k == len(near_caps) - 1)
    # Residual: everything still active and untested, in one pass.
    ga_r = _group_stats(m8_p != 0, ent, group)[0] & ~tested
    t_best, tri, _ = run_pass(m8_p, ga_r, cg, t_cur, i_cur)
    return _winner(rays, woop_rows, t_best, tri)


# --------------------------------------------------------------------------
# Kernel B3: all-hits light pdf over pierced light clusters (replaces
# pallas_intersect._kernel_light_pdf_items)
# --------------------------------------------------------------------------


def run_light_pdf_plain(
    rays: torch.Tensor,  # [R, 8]
    cluster_woop: torch.Tensor,  # [C, 12, CL] (NaN rows: padding lights)
    cluster_k: torch.Tensor,  # [C, CL] = 1 / (2 area^2), 0 on padding
    idx: torch.Tensor,  # [T, cap] int32 cluster ids, front to back
    counts: torch.Tensor,  # [T] int32 valid slots per tile
    min_dst: float,
) -> torch.Tensor:
    """Plain twin of the B3 kernel: for every tile and every valid slot s,
    the projection terms t^2 |d|^2 k / |q2| of the tile's rays against the
    lights of cluster idx[tile, s] where the Woop test passes and t >=
    min_dst, summed over the cluster and added to each ray's running sum in
    worklist order.  Returns the [R] sum (not yet divided by the light
    count).  t, beta and gamma round op for op like the kernel's, so the
    two pass the same lights; only the order of the sum differs."""
    t_tiles = idx.shape[0]
    r = rays.shape[0]
    rt = r // t_tiles
    o = rays[:, 0:3].reshape(t_tiles, rt, 3)
    d = rays[:, 4:7].reshape(t_tiles, rt, 3)
    dd = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])[..., None]
    total = torch.zeros((t_tiles, rt), device=rays.device)
    n_slots = int(counts.max()) if counts.numel() else 0
    for s in range(n_slots):
        c = idx[:, s].long()
        w = cluster_woop[c]  # [T, 12, CL]
        k = cluster_k[c][:, None, :]  # [T, 1, CL]
        p0, p1, p2 = (_contract_o(o, w, j) for j in (0, 4, 8))
        q0, q1, q2 = (_contract_d(d, w, j) for j in (0, 4, 8))
        t = -p2 / q2
        beta = p0 + t * q0
        gamma = p1 + t * q1
        ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst)
        term = t * t * dd * k / torch.abs(q2)
        csum = torch.where(ok, term, torch.zeros_like(term)).sum(dim=-1)
        total = torch.where((counts > s)[:, None], total + csum, total)
    return total.reshape(r)


def run_light_pdf(rays, cluster_woop, cluster_k, idx, counts, min_dst):
    """B3 wrapper: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors (see ``run_light_pdf_plain`` for the contract)."""
    if rays.is_cuda:
        from .. import kernels

        out = kernels.light_pdf(rays, cluster_woop, cluster_k, idx, counts, min_dst)
        run_light_pdf.launches += 1
        return out
    if rays.device.type == "cpu":
        return run_light_pdf_plain(rays, cluster_woop, cluster_k, idx, counts, min_dst)
    raise RuntimeError(f"run_light_pdf: no kernel for device {rays.device}")


run_light_pdf.launches = 0


def light_pdf_sum_chunks(
    origin: torch.Tensor,  # [R, 3], R % ray_tile == 0
    direction: torch.Tensor,  # [R, 3]
    cluster_woop: torch.Tensor,  # [C, 12, CL]
    cluster_k: torch.Tensor,  # [C, CL]
    cluster_min: torch.Tensor,  # [C, 3] (NaN: empty cluster)
    cluster_max: torch.Tensor,  # [C, 3]
    light_count: int,
    min_dst: float,
    ray_tile: int = RAY_TILE,
) -> torch.Tensor:
    """The all-hits light pdf (sum / count) at a cost that scales with the
    clusters a tile's rays pierce, not with the light count: the cluster
    AABBs' slab test (B1, one bit per tile), a per-tile worklist of the
    pierced clusters, and B3 over each worklist.  Exact: a cluster whose
    box no ray of the tile enters contributes 0 from all its lights.

    Not ported: the TPU's SMEM-budget windows over the item list (the
    ``light_items`` knob, the ``sum0`` chaining and the visited-tile
    patch); a GPU block reads its tile's worklist in one pass."""
    r = origin.shape[0]
    if r % ray_tile:
        raise ValueError(f"ray count {r} is not a multiple of the ray tile {ray_tile}")
    c = cluster_woop.shape[0]
    rays = pack_rays(origin, direction)
    m8, ent, _ = tile_chunk_activity(
        rays, cluster_min.contiguous(), cluster_max.contiguous(), None, None, min_dst, ray_tile
    )
    ga, ge = _group_stats(m8 != 0, ent, 1)
    idx, counts, _ = _worklist(ga, ge, c)
    total = run_light_pdf(
        rays, cluster_woop.contiguous(), cluster_k.contiguous(), idx.contiguous(),
        counts.contiguous(), min_dst,
    )
    return total / float(max(light_count, 1))


# --------------------------------------------------------------------------
# Kernel B4: first-entered box per ray (replaces pallas_intersect._nearest_kernel)
# --------------------------------------------------------------------------


def nearest_box_ids_plain(
    rays: torch.Tensor,  # [R, 8]
    box_min: torch.Tensor,  # [G, 3] (NaN rows never match)
    box_max: torch.Tensor,  # [G, 3]
    min_dst: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the B4 kernel: per ray, over the boxes with t_lo <=
    t_hi and t_hi >= min_dst, the smallest entry max(t_lo, min_dst) and its
    box id (the first minimum); (inf, -1) where no box is entered.  Column
    blocks of ``ACT_COLS`` bound the memory: inside a block the argmin is
    the first minimum and a strict < across blocks keeps the earlier block,
    so the result is the first minimum overall."""
    r = rays.shape[0]
    o = rays[:, 0:3]
    inv = _inv_dir(rays[:, 4:7])
    tmin = torch.full((r,), _INF, device=rays.device)
    arg = torch.full((r,), -1, dtype=torch.int32, device=rays.device)
    for g0 in range(0, box_min.shape[0], ACT_COLS):
        t_lo, t_hi = _slab(o, inv, box_min[g0:g0 + ACT_COLS], box_max[g0:g0 + ACT_COLS])
        ok = (t_lo <= t_hi) & (t_hi >= min_dst)
        entry = torch.where(ok, torch.clamp_min(t_lo, min_dst), torch.full_like(t_lo, _INF))
        bm, ba = entry.min(dim=1)
        better = bm < tmin
        tmin = torch.where(better, bm, tmin)
        arg = torch.where(better, (ba + g0).to(torch.int32), arg)
    return tmin, arg


def nearest_box_ids(
    origin: torch.Tensor,  # [R, 3], R % ray_tile == 0
    direction: torch.Tensor,  # [R, 3]
    box_min: torch.Tensor,  # [G, 3] (NaN rows never match)
    box_max: torch.Tensor,  # [G, 3]
    min_dst: float,
    ray_tile: int = RAY_TILE,
) -> torch.Tensor:
    """The box each ray FIRST enters ([R] int32 id, -1 = none): B4 for CUDA
    tensors, its plain twin for CPU tensors, on the boxes NaN-padded to a
    multiple of ``ACT_COLS`` as the JAX package pads them."""
    r = origin.shape[0]
    if r % ray_tile:
        raise ValueError(f"ray count {r} is not a multiple of the ray tile {ray_tile}")
    gpad = -(-box_min.shape[0] // ACT_COLS) * ACT_COLS
    bmin = _nan_pad_once(box_min, gpad)
    bmax = _nan_pad_once(box_max, gpad)
    rays = pack_rays(origin, direction)
    if rays.is_cuda:
        from .. import kernels

        _, ids = kernels.nearest(rays, bmin, bmax, min_dst)
        nearest_box_ids.launches += 1
        return ids
    if rays.device.type == "cpu":
        return nearest_box_ids_plain(rays, bmin, bmax, min_dst)[1]
    raise RuntimeError(f"nearest_box_ids: no kernel for device {rays.device}")


nearest_box_ids.launches = 0


# --------------------------------------------------------------------------
# Wavefront sort keys
# --------------------------------------------------------------------------

_SORT_CELLS = 16  # origin-cell grid resolution per axis of the "cell" key


def scene_bounds(chunk_min: torch.Tensor, chunk_max: torch.Tensor):
    """Scene AABB over the chunk boxes (NaN padding chunks ignored)."""
    return _nanmin(chunk_min, 0), _nanmax(chunk_max, 0)


def _dir_octant(direction: torch.Tensor) -> torch.Tensor:
    """[R, 3] -> [R] int32 direction octant."""
    return (
        (direction[:, 0] > 0).to(torch.int32) * 4
        + (direction[:, 1] > 0).to(torch.int32) * 2
        + (direction[:, 2] > 0).to(torch.int32)
    )


def ray_sort_key_hint(direction, alive, hint, n_chunks: int) -> torch.Tensor:
    """Coherence key: direction octant (major) x the spatially ordered chunk
    id of the surface the ray spawned from; hintless rays share one bucket
    past the chunk ids, dead rays sort last."""
    bucket = torch.clamp(torch.where(hint >= 0, hint, n_chunks), 0, n_chunks)
    key = _dir_octant(direction) * (n_chunks + 1) + bucket
    return torch.where(alive, key, torch.full_like(key, 1 << 28))


def ray_sort_key_target(origin, direction, alive, group_min, group_max, min_dst: float,
                        ray_tile: int = RAY_TILE) -> torch.Tensor:
    """Coherence key from the worklist group each ray will FIRST enter
    (``nearest_box_ids``, major) x direction octant (minor); rays that enter
    nothing share one bucket before the dead rays."""
    g = group_min.shape[0]
    tgt = nearest_box_ids(origin, direction, group_min, group_max, min_dst, ray_tile)
    key = torch.where(tgt >= 0, tgt, g) * 8 + _dir_octant(direction)
    return torch.where(alive, key, torch.full_like(key, 1 << 28))


def ray_sort_key_dirhint(direction, alive, hint, n_chunks: int) -> torch.Tensor:
    """Fine-direction-major key: (dominant axis, 4x4 bins of the two minor
    direction components), then the spawn-surface chunk id, then the
    octant; dead rays take the int32 maximum.  The bins are clamped before
    the integer conversion, which equals truncating then clamping for the
    finite directions of live rays."""
    octant = _dir_octant(direction)
    dom = torch.argmax(direction.abs(), dim=1)
    minor0 = torch.where(dom == 0, direction[:, 1], direction[:, 0])
    minor1 = torch.where(dom == 2, direction[:, 1], direction[:, 2])
    b0 = torch.clamp((minor0 + 1.0) * 2.0, 0.0, 3.0).to(torch.int32)
    b1 = torch.clamp((minor1 + 1.0) * 2.0, 0.0, 3.0).to(torch.int32)
    dir4 = (dom.to(torch.int32) * 4 + b0) * 4 + b1
    bucket = torch.clamp(torch.where(hint >= 0, hint, n_chunks), 0, n_chunks)
    key = (dir4 * (n_chunks + 1) + bucket) * 8 + octant
    return torch.where(alive, key, torch.full_like(key, 2**31 - 1))


def ray_sort_key(origin, direction, alive, scene_lo, scene_hi) -> torch.Tensor:
    """The "cell" key: direction octant (major) x the Morton-interleaved
    origin cell of a 16^3 grid over the scene bounds; dead rays sort last.
    The cell is clamped before the integer conversion (equal to clamping
    after it, and defined for the far-parked origins of dead lanes)."""
    ext = torch.clamp_min(scene_hi - scene_lo, 1e-30)
    cell = torch.clamp(
        (origin - scene_lo) / ext * float(_SORT_CELLS), 0.0, _SORT_CELLS - 1.0
    ).to(torch.int32)

    def spread(x):  # up to 8 bits -> every 3rd bit (Morton)
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    morton = spread(cell[:, 0]) * 4 + spread(cell[:, 1]) * 2 + spread(cell[:, 2])
    key = _dir_octant(direction) * _SORT_CELLS**3 + morton
    return torch.where(alive, key, torch.full_like(key, 1 << 20))
