"""Chunk-skipping wavefront intersector: the counterpart of
``tpu_pathtracer/ops/pallas_intersect.py``.

Triangles come spatially ordered in chunks of 128 (``scene.chunk_woop``,
AABBs in ``scene.chunk_aabb_min/max``).  ``closest_hit_chunks`` runs the
JAX package's default mode "items" cascade:

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
the closest hit over the union of tested chunks.

The two kernels are hand-written CUDA (``csrc/chunk_kernels.cu``, bound in
``kernels.py``).  Each wrapper here has a plain-torch twin with the same
signature; a CPU tensor goes to the twin, a CUDA tensor to the kernel, and
anything else raises.  Each wrapper counts its kernel launches in its
``launches`` attribute.

Not ported: the TPU-only modes ("dense", "twopass", "bins"), the cheap
recheck forms, the SMEM-budget caps (``max_cap``) and the iterating
residual they forced — on the GPU the residual is always one pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_pathtracer.config import IntersectTuning

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
    d = rays[:, 4:7]
    inv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-30), d)
    tb = (torch.full((r,), _INF, device=rays.device) if tbest is None else tbest)[:, None]
    sub_ent = torch.full((t_tiles, n_sub, c), _INF, device=rays.device)
    for b, c0 in enumerate(range(0, c, ACT_COLS)):
        c1 = min(c0 + ACT_COLS, c)
        t_lo = t_hi = None
        for a in range(3):
            t1 = (cmin[None, c0:c1, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
            t2 = (cmax[None, c0:c1, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
            lo = torch.minimum(t1, t2)
            hi = torch.maximum(t1, t2)
            t_lo = lo if t_lo is None else torch.maximum(t_lo, lo)
            t_hi = hi if t_hi is None else torch.minimum(t_hi, hi)
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
            w = chunk_woop[chunk]  # [T, 12, CW]
            p0, p1, p2 = (_contract_o(o, w, k) for k in (0, 4, 8))
            q0, q1, q2 = (_contract_d(d, w, k) for k in (0, 4, 8))
            tt = -p2 / q2
            beta = p0 + tt * q0
            gamma = p1 + tt * q1
            ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (tt >= min_dst)
            cmin_t, carg = torch.where(ok, tt, torch.full_like(tt, _INF)).min(dim=-1)
            better = ray_on & (cmin_t < t)
            t = torch.where(better, cmin_t, t)
            tri = torch.where(better, (chunk[:, None] * cw + carg).to(torch.int32), tri)
    return t.reshape(r), tri.reshape(r)


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
# Cascade glue (plain tensor code around the two kernels)
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
    """Closest hit through the mode "items" cascade (see the module doc).
    Equal to a brute force over every triangle in the same arithmetic up to
    exact-t ties, except where a ray's own rounded slab test cannot reach
    the chunk of a hit (a hit on a chunk's AABB face, or a few 1e-4 from a
    surface-spawned origin), which the JAX cascade shares."""
    tuning = (tuning or IntersectTuning()).resolve()
    if tuning.mode != "items":
        raise NotImplementedError(
            f"intersect mode {tuning.mode!r}: only 'items' is ported (ROADMAP "
            "Queue B: B5 dense, B6 twopass, B7 bins)"
        )
    if tuning.cheap_recheck != 0:
        raise NotImplementedError(
            "cheap_recheck != 0 is not ported: the port always runs the full "
            "slab recheck (ROADMAP: next slices, engine and config parity)"
        )
    r = origin.shape[0]
    if r % ray_tile:
        raise ValueError(f"ray count {r} is not a multiple of the ray tile {ray_tile}")
    t_tiles = r // ray_tile
    sub_rows = tuning.sub_rows
    n_sub = max(1, min(8, ray_tile // sub_rows)) if ray_tile % sub_rows == 0 else 1

    c = chunk_woop.shape[0]
    cg = -(-c // group)
    chunk_woop = _nan_pad(chunk_woop, cg * group).contiguous()
    chunk_min = _nan_pad(chunk_min, cg * group).contiguous()
    chunk_max = _nan_pad(chunk_max, cg * group).contiguous()
    rays = pack_rays(origin, direction)

    n_blocks = -(-cg * group // ACT_COLS)
    cbits = None
    if n_blocks > tuning.super_min:
        cbits = super_block_bits(rays, chunk_min, chunk_max, min_dst, ray_tile)
    m8, ent, _ = tile_chunk_activity(
        rays, chunk_min, chunk_max, None, cbits, min_dst, ray_tile, n_sub
    )
    _, ge = _group_stats(m8 != 0, ent, group)

    def recheck(t_c, live):
        """Activity under each ray's best t so far, gated to the column
        blocks that still hold an active untested group."""
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
        idx, counts, _ = _worklist(ga_p, ge, cap)
        masks = torch.take_along_dim(
            _pack_group_masks(m8_p, group), idx[:, :, None].long(), dim=1
        )
        t_c, i_c = run_items(
            rays, t_c, i_c, chunk_woop, idx.contiguous(), counts.contiguous(),
            masks.contiguous(), min_dst, group, n_sub,
        )
        return t_c, i_c, idx

    base = max(tuning.pass1_min, cg // 9)
    ladder = [int(x) * base // 4 for x in tuning.near.split(",")]
    near_caps = [min(cap, cg) for cap in ladder if cap < cg]
    tested = torch.zeros((t_tiles, cg), dtype=torch.bool, device=rays.device)
    t_cur = torch.full((r,), _INF, device=rays.device)
    i_cur = torch.zeros((r,), dtype=torch.int32, device=rays.device)
    m8_p = m8
    for cap in near_caps:
        ga_p = _group_stats(m8_p != 0, ent, group)[0] & ~tested
        t_cur, i_cur, idx = run_pass(m8_p, ga_p, cap, t_cur, i_cur)
        tested.scatter_(1, idx.long(), True)
        m8_p = recheck(t_cur, ga_p & ~tested)
    # Residual: everything still active and untested, in one pass.
    ga_r = _group_stats(m8_p != 0, ent, group)[0] & ~tested
    t_best, tri, _ = run_pass(m8_p, ga_r, cg, t_cur, i_cur)

    # Winner barycentrics: one [R, 12] row gather (rows[t, 4j+k]).
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
