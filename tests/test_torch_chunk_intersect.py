"""The chunk cascade's plain twins and glue vs the JAX package: the B1 twin
against the Pallas activity kernel in interpret mode, the cascade against
the dense sweep, and the worklist helpers against their jnp originals; the
worklist pass's wrapper (K5's plain path) against the cascade's chain and
a statement of each output in plain Python."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import pallas_intersect as jpi
from tpu_pathtracer.ops.intersect import closest_hit as jax_closest_hit
from tpu_pathtracer.scene.accel import LEAF_SIZE, build_leaves, chunk_aabbs, morton_order
from tpu_pathtracer_torch.config import IntersectTuning
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.scene.gltf import build_chunk_woop, build_woop, tri_capacity

from test_torch_cuda import worklist_caps, worklist_case

torch.set_num_threads(1)

EPS = 1e-4


def _scene(n_tris, seed, spread=5.0):
    """Random triangle soup in Morton order (as tests/test_pallas_intersect)."""
    rs = np.random.default_rng(seed)
    center = rs.uniform(-spread, spread, size=(n_tris, 1, 3))
    verts = center + rs.uniform(-0.5, 0.5, size=(n_tris, 3, 3))
    cap = tri_capacity(n_tris)
    out = np.full((cap, 3, 3), 1e30)
    out[:n_tris] = verts
    valid = np.zeros(cap, bool)
    valid[:n_tris] = True
    perm = morton_order(out, valid)
    verts, valid = out[perm], valid[perm]
    woop = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    cmin, cmax = chunk_aabbs(lmin, lmax, ci.CHUNK_TRIS // LEAF_SIZE)
    cw = build_chunk_woop(woop)
    rows = np.ascontiguousarray(woop.reshape(4, cap, 3).transpose(1, 2, 0).reshape(cap, 12))
    return verts, valid, woop, rows, cmin, cmax, cw


def _rays(rs, r, box, aim=None):
    o = rs.uniform(-box, box, size=(r, 3)).astype(np.float32)
    d = (rs.uniform(-aim, aim, size=(r, 3)).astype(np.float32) - o) if aim else rs.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_torch_activity_twin_matches_jax_interpret(bounded, gated):
    """B1 twin vs the Pallas activity kernel (interpret mode): 2 tiles of 128
    rays x one 512-column block, n_sub 2, with NaN-padded chunks (1,100
    triangles in a 2,048 capacity) and origins exactly on chunk-AABB planes
    with a zero direction component.  m8, ent, sub_ent and the coarse
    super-block bits must be exactly equal."""
    _, _, _, _, cmin, cmax, _ = _scene(1100, seed=7)
    assert np.isnan(cmin[:, 0]).sum() >= 2  # padding chunks present
    rs = np.random.default_rng(8)
    o, d = _rays(rs, 256, 8.0)
    # 32 rays start on chunk-AABB faces and run inside the face plane.
    real = np.nonzero(np.isfinite(cmin[:, 0]))[0]
    for i in range(32):
        c = real[i % len(real)]
        a = i % 3
        o[i] = (cmin[c] + cmax[c]) / 2
        o[i, a] = cmin[c, a] if i % 2 else cmax[c, a]
        d[i, a] = 0.0
        d[i] /= np.linalg.norm(d[i])
    rays = np.concatenate([o, np.ones((256, 1), np.float32), d, np.zeros((256, 1), np.float32)], 1)
    tbest = rs.uniform(0.5, 12.0, size=256).astype(np.float32) if bounded else None
    jb = None if tbest is None else jnp.asarray(tbest)
    tb = None if tbest is None else _t(tbest)
    jbits = tbits = None
    if gated:
        jbits = jpi.super_block_bits(jnp.asarray(rays), jnp.asarray(cmin), jnp.asarray(cmax),
                                     EPS, 128, True, tbest=jb)
        tbits = ci.super_block_bits(_t(rays), _t(cmin), _t(cmax), EPS, 128, tbest=tb)
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
        # Clear tile 1's gate so the skipped-block path runs too.
        jbits = jbits.at[1].set(0)
        tbits = tbits.clone()
        tbits[1] = 0
    _, ent_j, m8_j, sub_j = jpi.tile_chunk_activity(
        jnp.asarray(rays), jnp.asarray(cmin), jnp.asarray(cmax), EPS, ray_tile=128,
        interpret=True, tbest=jb, coarse_bits=jbits, n_sub=2, want_sub_ent=True,
    )
    m8, ent, sub = ci.tile_chunk_activity(_t(rays), _t(cmin), _t(cmax), tb, tbits, EPS, 128,
                                          n_sub=2, want_sub=True)
    np.testing.assert_array_equal(m8.numpy(), np.asarray(m8_j))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(ent_j))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(sub_j))
    assert (m8.numpy() != 0).any()
    assert not m8.numpy()[:, np.isnan(cmin[:, 0])].any()


def _cascade_vs_dense(n_tris, seed, spread, group, box, aim=None):
    _, _, woop, rows, cmin, cmax, cw = _scene(n_tris, seed, spread)
    rs = np.random.default_rng(seed + 1)
    o, d = _rays(rs, 256, box, aim)
    dense = jax_closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(woop), EPS)
    got = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                ray_tile=128, group=group)
    # The criteria of tests/test_pallas_intersect.py:62-72.
    hd, hp = np.asarray(dense.hit), got.hit.numpy()
    assert (hd == hp).mean() > 0.995
    both = hd & hp
    assert both.sum() > 30
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(dense.t)[both], rtol=1e-5, atol=1e-6)
    assert (got.tri.numpy()[both] == np.asarray(dense.tri)[both]).mean() > 0.99
    np.testing.assert_allclose(got.beta.numpy()[both], np.asarray(dense.beta)[both],
                               rtol=1e-4, atol=1e-5)


def test_torch_cascade_matches_dense():
    _cascade_vs_dense(2000, seed=0, spread=5.0, group=ci.GROUP, box=8.0)


def test_torch_cascade_ladder_and_residual_match_dense(monkeypatch):
    """group=1 over 128 chunks: two near passes (caps 7 and 21) with
    rechecks, then the residual — three item passes — on wide rays that keep
    many groups active."""
    calls = []
    real = ci.run_items

    def spy(*args):
        calls.append(args[4].shape[1])  # the pass's worklist cap
        return real(*args)

    monkeypatch.setattr(ci, "run_items", spy)
    _cascade_vs_dense(16000, seed=31, spread=20.0, group=1, box=24.0, aim=12.0)
    assert calls == [7, 21, 128]


def test_torch_worklist_glue_matches_jax():
    """_bitpack, _pack_group_masks, _live_block_bits, _group_stats and
    _worklist equal their jnp originals (int32 bit fields included)."""
    rs = np.random.default_rng(3)
    t_tiles, group, cg = 4, 8, 70
    m8 = rs.integers(0, 256, size=(t_tiles, cg * group)).astype(np.int32)
    m8[rs.random(m8.shape) < 0.7] = 0
    ent = np.where(m8 != 0, rs.uniform(0, 9, size=m8.shape), np.inf).astype(np.float32)
    act = (m8 != 0).astype(np.int32)
    np.testing.assert_array_equal(ci._bitpack(_t(act)).numpy(), np.asarray(jpi._bitpack(jnp.asarray(act))))
    np.testing.assert_array_equal(ci._pack_group_masks(_t(m8), group).numpy(),
                                  np.asarray(jpi._pack_group_masks(jnp.asarray(m8), group)))
    live = rs.random((t_tiles, cg)) < 0.2
    np.testing.assert_array_equal(ci._live_block_bits(_t(live), group).numpy(),
                                  np.asarray(jpi._live_block_bits(jnp.asarray(live), group)))
    ga_t, ge_t = ci._group_stats(_t(act) != 0, _t(ent), group)
    ga_j, ge_j = jpi._group_stats(jnp.asarray(act), jnp.asarray(ent), group)
    np.testing.assert_array_equal(ga_t.numpy(), np.asarray(ga_j))
    np.testing.assert_array_equal(ge_t.numpy(), np.asarray(ge_j))
    for cap in (3, 11, cg):
        got = ci._worklist(ga_t, ge_t, cap)
        want = jpi._worklist(ga_j, ge_j, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_torch_sort_key_and_group_boxes_match_jax():
    rs = np.random.default_rng(5)
    d = rs.normal(size=(300, 3)).astype(np.float32)
    d[:10, 0] = 0.0
    alive = rs.random(300) < 0.8
    hint = rs.integers(-1, 40, size=300).astype(np.int32)
    want = jpi.ray_sort_key_hint(jnp.asarray(d), jnp.asarray(alive), jnp.asarray(hint), 37)
    got = ci.ray_sort_key_hint(_t(d), _t(alive), _t(hint), 37)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cmin = rs.uniform(-5, 4, size=(37, 3)).astype(np.float32)
    cmax = cmin + 1.0
    cmin[20:24] = np.nan
    cmax[20:24] = np.nan
    for g in (8, 512):
        for a, b in zip(ci.group_boxes(_t(cmin), _t(cmax), g),
                        jpi.group_boxes(jnp.asarray(cmin), jnp.asarray(cmax), g)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_kernel_wrappers_reject_other_devices():
    """A CPU tensor goes to the twin, a CUDA tensor to the kernel; any other
    device raises instead of falling back."""
    rays = torch.zeros((128, 8), device="meta")
    box = torch.zeros((4, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.tile_chunk_activity(rays, box, box, None, None, EPS, 128)
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.run_items(rays, rays[:, 0], idx[0], torch.zeros((8, 12, 128), device="meta"),
                     idx, idx[0], idx[:, :, None], EPS, 8, 2)
    m8 = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.worklist_pass(m8, m8.float(), torch.zeros((1, 2), dtype=torch.bool, device="meta"),
                         1, 8, 2)


def _kernel_units(offsets, counts, masks, group, n_sub, n_blocks):
    """The B2 kernel's walk over its units, block by block, in plain Python
    (``items_kernel`` in csrc/chunk_kernels.cu): the unit count split into
    equal contiguous ranges, a binary search for each block's first unit
    over the prefix sum, and the cursor that moves to the next set bit, and
    past an exhausted item by a galloping search for the next item with
    units.  Returns the (item, sub-tile) units in the order the blocks take
    them."""
    off = offsets.tolist()
    n_items, total = len(off), off[-1]
    _, cap, n_words = masks.shape
    words = masks.reshape(-1).tolist()
    cnt = counts.tolist()

    def bits_of(item):
        g, ts = item % group, item // group
        if ts % cap >= cnt[ts // cap]:
            return 0
        return ((words[ts * n_words + g // 4] & 0xFFFFFFFF) >> (8 * (g % 4))) & ((1 << n_sub) - 1)

    units = []
    for b in range(n_blocks):
        lo, hi = total * b // n_blocks, total * (b + 1) // n_blocks
        if lo >= hi:
            continue
        a, z = 0, n_items - 1
        while a < z:
            m = (a + z) // 2
            a, z = (a, m) if off[m] > lo else (m + 1, z)
        item, bits = a, bits_of(a)
        for _ in range(lo - (off[item] - bin(bits).count("1"))):
            bits &= bits - 1
        for u in range(hi - lo):
            units.append((item, (bits & -bits).bit_length() - 1))
            if u + 1 < hi - lo:
                bits &= bits - 1
                if bits == 0:
                    v = off[item]
                    a, z, step = item, item + 1, 1
                    while off[z] <= v:
                        a, step = z, step * 2
                        z = min(item + step, n_items - 1)
                    while z - a > 1:
                        m = (a + z) // 2
                        a, z = (a, m) if off[m] > v else (m, z)
                    item, bits = z, bits_of(z)
    return units, bits_of


def _items_from_units(rays, tmin0, tidx0, chunk_woop, idx, masks, units, group, n_sub):
    """Plain-torch evaluation driven by the unit list, as the B2 kernel
    computes it: per unit, the first minimum of the sub-tile's rays over the
    chunk, sent as the 64-bit key (t bits, triangle id) to a per-ray minimum
    where not above tmin0; then the key is kept only where below the key of
    (tmin0, tidx0)."""
    t_tiles, cap, _ = masks.shape
    r = rays.shape[0]
    ray_tile = r // t_tiles
    rows = ray_tile // n_sub
    cw = chunk_woop.shape[-1]
    keys = torch.full((r,), 2**63 - 1, dtype=torch.int64)
    for item, st in units:
        g, ts = item % group, item // group
        tile, s = ts // cap, ts % cap
        ray_ids = torch.arange(rows) + tile * ray_tile + st * rows
        chunk = int(idx[tile, s]) * group + g
        o, d = rays[ray_ids, 0:3][None], rays[ray_ids, 4:7][None]
        tmin, arg = ci._chunk_first_min(o, d, chunk_woop[chunk:chunk + 1], EPS)
        tmin, arg = tmin[0], arg[0]
        key = (tmin.view(torch.int32).to(torch.int64) << 32) | (chunk * cw + arg)
        sent = (tmin <= tmin0[ray_ids]) & torch.isfinite(tmin)
        keys[ray_ids] = torch.where(sent, torch.minimum(keys[ray_ids], key), keys[ray_ids])
    found = keys != 2**63 - 1
    t_key = (keys >> 32).to(torch.int32).view(torch.float32)
    tri = (keys & 0xFFFFFFFF).to(torch.int32)
    key0 = (tmin0.view(torch.int32).to(torch.int64) << 32) | tidx0.to(torch.int64)
    won = found & (keys < key0)
    return torch.where(won, t_key, tmin0), torch.where(won, tri, tidx0)


@pytest.mark.parametrize("n_sub", [1, 2, 4])
def test_torch_item_units_cover_every_bit_and_match_twin(n_sub):
    """``item_unit_offsets`` and the kernel's walk over it: for any number
    of blocks, every set mask bit of a slot below the count is taken exactly
    once, in test order, and the evaluation driven by the units is bit-equal
    to ``run_items_plain`` (t and tri), from a partly finished (tmin0, tidx0)
    so the comparison with it matters.  The cascade's real glue makes
    the worklist: 4 tiles of 128 rays over 2,000 triangles, one of them
    with no slot and one with 3, so the walk crosses dead slots and a dead
    tile."""
    _, _, _, _, cmin, cmax, cw = _scene(2000, seed=0)
    group = 2
    cg = -(-cw.shape[0] // group)
    chunk_woop = ci._nan_pad(_t(cw), cg * group)
    cmin_t, cmax_t = ci._nan_pad(_t(cmin), cg * group), ci._nan_pad(_t(cmax), cg * group)
    o, d = _rays(np.random.default_rng(1), 512, 8.0)
    rays = ci.pack_rays(_t(o), _t(d))
    m8, ent, _ = ci.tile_chunk_activity(rays, cmin_t, cmax_t, None, None, EPS, 128, n_sub)
    ga, ge = ci._group_stats(m8 != 0, ent, group)
    idx, counts, _ = ci._worklist(ga, ge, cg - 1)
    counts = torch.clamp_max(counts, torch.tensor([cg - 1, 0, 3, cg - 1], dtype=torch.int32))
    masks = torch.take_along_dim(ci._pack_group_masks(m8, group), idx[:, :, None].long(), dim=1)
    rs = np.random.default_rng(2)
    tmin0 = _t(np.where(rs.random(512) < 0.5, np.inf, rs.uniform(1, 12, 512)).astype(np.float32))
    tidx0 = _t(rs.integers(0, 1000, 512).astype(np.int32))

    offsets = ci.item_unit_offsets(counts, masks, group, n_sub)
    assert offsets.dtype == torch.int32 and offsets.shape == (4 * (cg - 1) * group,)
    want_t, want_tri = ci.run_items_plain(rays, tmin0, tidx0, chunk_woop, idx, counts, masks,
                                          EPS, group, n_sub)
    assert torch.isfinite(want_t).sum() > 30
    for n_blocks in (1, 7, 10_000):
        units, bits_of = _kernel_units(offsets, counts, masks, group, n_sub, n_blocks)
        every = [(item, st) for item in range(offsets.numel()) for st in range(n_sub)
                 if bits_of(item) >> st & 1]
        assert units == every and len(units) == int(offsets[-1]) >= 20
    t, tri = _items_from_units(rays, tmin0, tidx0, chunk_woop, idx, masks, units, group, n_sub)
    assert torch.equal(t, want_t) and torch.equal(tri, want_tri)


def _slot_kernel_parts(offsets, masks, group, n_sub, n_blocks, n_warps, n_parts):
    """The B6 kernel's walk, block by block, in plain Python (``slots_kernel``
    in csrc/mode_kernels.cu): the unit count split into equal contiguous
    ranges; the producer's walk over the slots with units in a block's range
    (a binary search for the first, a galloping search for each next one over
    the prefix sum); and the consumers' dealing of each unit's parts to the
    warps, part h of unit u to warp ((u - lo) * n_parts + h) % n_warps.
    Returns the (slot, chunk, sub-tile, part) taken, in block, slot, warp
    order, and the slots each block staged."""
    off = offsets.tolist()
    n_slots = len(off)
    words = masks.reshape(n_slots, -1).tolist()
    total = off[-1]
    taken, staged = [], []
    for b in range(n_blocks):
        lo, hi = total * b // n_blocks, total * (b + 1) // n_blocks
        if lo >= hi:
            continue
        a, z = 0, n_slots - 1
        while a < z:
            m = (a + z) // 2
            a, z = (a, m) if off[m] > lo else (m + 1, z)
        slot, slots = a, []
        while True:  # the producer
            before, after = (off[slot - 1] if slot else 0), off[slot]
            slots.append((slot, before))
            if after >= hi:
                break
            a, z, step = slot, slot + 1, 1
            while off[z] <= after:
                a, step = z, step * 2
                z = min(slot + step, n_slots - 1)
            while z - a > 1:
                m = (a + z) // 2
                a, z = (a, m) if off[m] > after else (m, z)
            slot = z
        staged.append([s for s, _ in slots])
        for slot, u0 in slots:  # the consumers
            for warp in range(n_warps):
                u = u0
                for g in range(group):
                    bits = ((words[slot][g // 4] & 0xFFFFFFFF) >> (8 * (g % 4))) & ((1 << n_sub) - 1)
                    while bits:
                        st = (bits & -bits).bit_length() - 1
                        if lo <= u < hi:
                            taken += [(slot, g, st, h) for h in range(n_parts)
                                      if ((u - lo) * n_parts + h) % n_warps == warp]
                        bits &= bits - 1
                        u += 1
    return taken, staged


@pytest.mark.parametrize("n_sub", [1, 2, 4])
def test_torch_slot_units_cover_every_bit_and_match_twin(n_sub):
    """``slot_unit_offsets`` and the B6 kernel's walk over it: for any number
    of blocks, warps and parts, every part of every set mask bit of a slot
    below its tile's count is taken exactly once, a block stages only slots
    with units, in ascending order, and the evaluation driven by the units
    is bit-equal to ``run_slots_plain``.  The worklist is that of the B2
    unit test: 4 tiles, one with no slot and one with 3, so the walk crosses
    dead slots and a dead tile."""
    _, _, _, _, cmin, cmax, cw = _scene(2000, seed=0)
    group = 2
    cg = -(-cw.shape[0] // group)
    chunk_woop = ci._nan_pad(_t(cw), cg * group)
    cmin_t, cmax_t = ci._nan_pad(_t(cmin), cg * group), ci._nan_pad(_t(cmax), cg * group)
    o, d = _rays(np.random.default_rng(1), 512, 8.0)
    rays = ci.pack_rays(_t(o), _t(d))
    m8, ent, _ = ci.tile_chunk_activity(rays, cmin_t, cmax_t, None, None, EPS, 128, n_sub)
    ga, ge = ci._group_stats(m8 != 0, ent, group)
    idx, counts, _ = ci._worklist(ga, ge, cg - 1)
    cap = cg - 1
    counts = torch.clamp_max(counts, torch.tensor([cap, 0, 3, cap], dtype=torch.int32))
    masks = torch.take_along_dim(ci._pack_group_masks(m8, group), idx[:, :, None].long(), dim=1)
    rs = np.random.default_rng(2)
    tmin0 = _t(np.where(rs.random(512) < 0.5, np.inf, rs.uniform(1, 12, 512)).astype(np.float32))
    tidx0 = _t(rs.integers(0, 1000, 512).astype(np.int32))

    offsets = ci.slot_unit_offsets(counts, masks, group, n_sub)
    assert offsets.dtype == torch.int32 and offsets.shape == (4 * cap,)
    # The same units as B2's list, counted per slot.
    items = ci.item_unit_offsets(counts, masks, group, n_sub)
    assert torch.equal(offsets, items[group - 1::group])
    live = (torch.arange(cap)[None, :] < counts[:, None]).reshape(-1).tolist()
    words = masks.reshape(4 * cap, -1).tolist()
    every = [(slot, g, st) for slot in range(4 * cap) if live[slot] for g in range(group)
             for st in range(n_sub)
             if ((words[slot][g // 4] & 0xFFFFFFFF) >> (8 * (g % 4))) >> st & 1]
    assert len(every) == int(offsets[-1]) >= 20
    for n_blocks, n_warps, n_parts in ((1, 12, 2), (7, 3, 1), (10_000, 12, 4), (5, 8, 4)):
        taken, staged = _slot_kernel_parts(offsets, masks, group, n_sub, n_blocks, n_warps, n_parts)
        assert sorted(taken) == [u + (h,) for u in every for h in range(n_parts)]
        for slots in staged:
            assert slots == sorted(set(slots)) and all(live[s] for s in slots)
    units = sorted({((slot * group + g), st) for slot, g, st, _ in taken})
    t, tri = _items_from_units(rays, tmin0, tidx0, chunk_woop, idx, masks, units, group, n_sub)
    want_t, want_tri = ci.run_slots_plain(rays, tmin0, tidx0, chunk_woop, idx, counts, masks,
                                          EPS, group, n_sub)
    assert torch.isfinite(want_t).sum() > 30
    assert torch.equal(t, want_t) and torch.equal(tri, want_tri)


def test_torch_slot_units_empty_worklist():
    """A worklist with no unit: every count 0, or counts with all-zero
    masks.  The prefix sum ends at 0, so no block of the B6 walk has a range
    and none reads a slot; a zero-width worklist has no entry at all, and the
    twin returns (tmin0, tidx0) unchanged."""
    masks = torch.full((3, 5, 1), -1, dtype=torch.int32)
    zero = torch.zeros(3, dtype=torch.int32)
    off = ci.slot_unit_offsets(zero, masks, 2, 4)
    assert off.shape == (15,) and int(off[-1]) == 0
    assert _slot_kernel_parts(off, masks, 2, 4, 7, 12, 2) == ([], [])
    off = ci.slot_unit_offsets(torch.full((3,), 5, dtype=torch.int32), torch.zeros_like(masks), 2, 4)
    assert int(off[-1]) == 0
    assert ci.slot_unit_offsets(zero, masks[:, :0], 2, 4).shape == (0,)
    # Bits above n_sub and bytes past the group are not units.
    off = ci.slot_unit_offsets(torch.ones(3, dtype=torch.int32), masks, 2, 4)
    assert off.tolist()[::5] == [8, 16, 24]
    rays = ci.pack_rays(torch.zeros(384, 3), torch.ones(384, 3))
    tmin0 = torch.full((384,), 2.5)
    tidx0 = torch.arange(384, dtype=torch.int32)
    t, tri = ci.run_slots(rays, tmin0, tidx0, torch.zeros(4, 12, 128),
                          torch.zeros((3, 5), dtype=torch.int32), zero, masks, EPS, 2, 4)
    assert torch.equal(t, tmin0) and torch.equal(tri, tidx0)


@pytest.mark.parametrize("n_sub", [1, 8])
@pytest.mark.parametrize("columns", [1, 4, 200])
def test_torch_activity_twin_matches_jax_at_kernel_edges(columns, n_sub):
    """B1 twin vs the Pallas activity kernel (interpret mode) at the shapes
    the CUDA kernel treats specially: a single column and the super-block
    gate's 4 columns (one step of a thread), a column count that is not a
    multiple of the kernel's 128-column block, and n_sub 1 and 8 (a sub-tile
    of whole warps against 16-ray sub-tiles), t-bounded, with NaN boxes among
    the columns.  m8, ent and sub_ent must be exactly equal."""
    _, _, _, _, cmin, cmax, _ = _scene(1100, seed=7)
    real = np.nonzero(np.isfinite(cmin[:, 0]))[0]
    rs = np.random.default_rng(11)
    pick = rs.choice(real, size=columns, replace=columns > len(real))
    bmin, bmax = cmin[pick].copy(), cmax[pick].copy()
    if columns > 4:
        bmin[5::17] = np.nan
        bmax[5::17] = np.nan
    o, d = _rays(rs, 256, 8.0)
    d[:8, 1] = 0.0  # a zero direction component
    rays = np.concatenate([o, np.ones((256, 1), np.float32), d, np.zeros((256, 1), np.float32)], 1)
    tbest = rs.uniform(0.5, 12.0, size=256).astype(np.float32)
    _, ent_j, m8_j, sub_j = jpi.tile_chunk_activity(
        jnp.asarray(rays), jnp.asarray(bmin), jnp.asarray(bmax), EPS, ray_tile=128,
        interpret=True, tbest=jnp.asarray(tbest), n_sub=n_sub, want_sub_ent=True,
    )
    m8, ent, sub = ci.tile_chunk_activity(_t(rays), _t(bmin), _t(bmax), _t(tbest), None, EPS, 128,
                                          n_sub=n_sub, want_sub=True)
    assert m8.shape == (2, columns) and sub.shape == (2, n_sub, columns)
    np.testing.assert_array_equal(m8.numpy(), np.asarray(m8_j))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(ent_j))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(sub_j))
    assert (m8.numpy() != 0).any()


def test_torch_activity_twin_matches_jax_all_gated_off():
    """B1 twin vs the Pallas activity kernel (interpret mode) under a gate
    with every 512-column block off for every tile, over two column blocks
    (600 columns): m8 all 0, ent and sub_ent all +inf, equal to JAX's."""
    rs = np.random.default_rng(12)
    bmin = rs.uniform(-5, 4, size=(600, 3)).astype(np.float32)
    bmax = bmin + 2.0
    o, d = _rays(rs, 256, 8.0)
    rays = np.concatenate([o, np.ones((256, 1), np.float32), d, np.zeros((256, 1), np.float32)], 1)
    gate = np.zeros((2, 1), np.int32)
    _, ent_j, m8_j, sub_j = jpi.tile_chunk_activity(
        jnp.asarray(rays), jnp.asarray(bmin), jnp.asarray(bmax), EPS, ray_tile=128,
        interpret=True, coarse_bits=jnp.asarray(gate), n_sub=8, want_sub_ent=True,
    )
    m8, ent, sub = ci.tile_chunk_activity(_t(rays), _t(bmin), _t(bmax), None, _t(gate), EPS, 128,
                                          n_sub=8, want_sub=True)
    np.testing.assert_array_equal(m8.numpy(), np.asarray(m8_j))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(ent_j))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(sub_j))
    assert not m8.numpy().any() and np.isinf(ent.numpy()).all() and np.isinf(sub.numpy()).all()
    # The same boxes ungated are active: the gate is what cleared them.
    assert (ci.tile_chunk_activity(_t(rays), _t(bmin), _t(bmax), None, None, EPS, 128)[0] != 0).any()


def test_torch_triangle_major_copy_is_made_once():
    """``kernels.triangle_major``: the [C, cw, 12] copy the B2, B3 and B6
    launchers stage from is made at a tensor's first launch and found again
    afterwards, remade after an in-place write, and dropped with the tensor."""
    import gc

    from tpu_pathtracer_torch import kernels

    woop = torch.arange(2 * 12 * 8, dtype=torch.float32).reshape(2, 12, 8)
    first = kernels.triangle_major(woop)
    assert first.shape == (2, 8, 12) and first.is_contiguous()
    assert torch.equal(first, woop.transpose(1, 2))
    assert kernels.triangle_major(woop) is first
    other = kernels.triangle_major(woop.clone())
    assert other is not first and torch.equal(other, first)
    woop[0, 0, 0] = -1.0
    again = kernels.triangle_major(woop)
    assert again is not first and float(again[0, 0, 0]) == -1.0
    key = id(woop)
    assert key in kernels._TRIANGLE_MAJOR
    del woop
    gc.collect()
    assert key not in kernels._TRIANGLE_MAJOR


def _chain_before_k5(m8_p, ent, tested, cap, group, n_sub, cbits, want_gate):
    """One pass's glue as ``closest_hit_chunks`` ran it as torch code: the
    group stats, ``_worklist``, the packed masks gathered by slot, B2's unit
    prefix sum, the scatter into ``tested`` and the live-block gate."""
    ga_p, ge = ci._group_stats(m8_p != 0, ent, group)
    ga_p = ga_p & ~tested
    idx, counts, _ = ci._worklist(ga_p, ge, cap)
    masks = torch.take_along_dim(ci._pack_group_masks(m8_p, group), idx[:, :, None].long(), dim=1)
    offsets = ci.item_unit_offsets(counts, masks, group, n_sub)
    tested.scatter_(1, idx.long(), True)
    gate = None
    if want_gate:
        gate = ci._live_block_bits(ga_p & ~tested, group)
        gate = gate if cbits is None else gate & cbits
    return ga_p, ge, idx, counts, masks, offsets, gate


def _worklist_in_python(m8, ent, tested, cap, group, n_sub, cbits, want_gate):
    """Each output of one pass stated element by element in plain Python:
    a group is active when a chunk has a bit and no earlier pass listed
    it; the worklist is the active groups by (least entry, group id), the
    last one repeated past ``cap`` or the count (group 0 with none); a
    slot's word w holds chunk 4w + b's bits in byte b; an item's units are
    its chunk's set bits below ``n_sub`` in an in-count slot, summed over
    the items in (tile, slot, chunk) order; the gate has block b's bit
    where a group over its 512 chunks is active and still untested after
    the pass.  ``tested`` is updated in place (a numpy bool array)."""
    t_tiles, c = m8.shape
    cg = c // group
    n_words, n_blocks = -(-group // 4), -(-c // 512)
    ga = (m8.reshape(t_tiles, cg, group) != 0).any(axis=2) & ~tested
    ge = ent.reshape(t_tiles, cg, group).min(axis=2)
    idx = np.zeros((t_tiles, cap), np.int64)
    counts = np.zeros(t_tiles, np.int64)
    masks = np.zeros((t_tiles, cap, n_words), np.int64)
    units = []
    gate = np.zeros((t_tiles, -(-n_blocks // 32)), np.int64)
    for t in range(t_tiles):
        order = sorted((g for g in range(cg) if ga[t, g]), key=lambda g: (ge[t, g], g))
        counts[t] = min(len(order), cap)
        for s in range(cap):
            g = order[min(s, counts[t] - 1)] if counts[t] else 0
            idx[t, s] = g
            for b in range(group):
                masks[t, s, b // 4] += int(m8[t, g * group + b]) << (8 * (b % 4))
                bits = int(m8[t, g * group + b]) & ((1 << n_sub) - 1)
                units.append(bin(bits).count("1") if s < counts[t] else 0)
        tested[t, idx[t]] = True
        for b in range(n_blocks):
            if any(ga[t, g] and not tested[t, g] for g in range(cg)
                   if g * group < 512 * (b + 1) and (g + 1) * group > 512 * b):
                gate[t, b // 32] |= 1 << (b % 32)
    gate = np.where(gate >= 2**31, gate - 2**32, gate)
    if cbits is not None:
        gate &= cbits.numpy()
    masks = np.where(masks >= 2**31, masks - 2**32, masks)
    return ga, ge, idx, counts, masks, np.cumsum(units), gate if want_gate else None


WORKLIST_CASES = {  # (tiles, groups, group, generator options)
    "ties": (4, 45, 8, dict(ties=True)),  # 45 groups: not a multiple of 32
    "empty_tiles": (5, 64, 8, dict(empty_tiles=2)),
    "over_cap": (3, 81, 2, dict(p_active=0.8)),
    "group3": (4, 37, 3, dict(ties=True, empty_tiles=1)),
    "past_a_gate_word": (2, 2100, 8, dict(p_active=0.05)),  # 33 blocks of 512 chunks
}


@pytest.mark.parametrize("with_cbits", [False, True])
@pytest.mark.parametrize("n_sub", [1, 8])
@pytest.mark.parametrize("case", list(WORKLIST_CASES))
def test_torch_worklist_pass_equals_the_chain(case, n_sub, with_cbits):
    """``worklist_pass`` on CPU tensors (K5's plain path) over a whole
    cascade's passes, ``tested`` carried from pass to pass, against the
    cascade's chain and against the plain-Python statement, every output:
    exact ties in group entry, tiles with no active group, counts past the
    cap, group counts that are no multiple of 32, groups of 3 chunks, more
    than one gate word, with and without the coarse gate."""
    t_tiles, cg, group, opts = WORKLIST_CASES[case]
    m8s, ent, cbits = worklist_case(len(case) + n_sub, t_tiles, cg, group, n_sub,
                                    with_cbits=with_cbits, **opts)
    tested = torch.zeros((t_tiles, cg), dtype=torch.bool)
    tested_chain, tested_py = tested.clone(), tested.numpy().copy()
    over_cap = False
    for m8, cap in zip(m8s, worklist_caps(cg)):
        want_gate = cap < cg
        got = ci.worklist_pass(m8, ent, tested, cap, group, n_sub, cbits, want_gate)
        chain = _chain_before_k5(m8, ent, tested_chain, cap, group, n_sub, cbits, want_gate)
        py = _worklist_in_python(m8.numpy(), ent.numpy(), tested_py, cap, group, n_sub, cbits,
                                 want_gate)
        for name, g, c, p in zip(ci.Worklist._fields, got, chain, py):
            assert (g is None) == (c is None) == (p is None), name
            if g is not None:
                assert g.dtype == c.dtype and torch.equal(g, c), (name, cap)
                np.testing.assert_array_equal(g.numpy(), p, err_msg=f"{name} cap {cap}")
        assert torch.equal(tested, tested_chain)
        np.testing.assert_array_equal(tested.numpy(), tested_py)
        over_cap |= bool((got.ga.sum(dim=1) > cap).any())
    assert over_cap


def test_torch_cascade_builds_each_worklist_in_one_pass_call(monkeypatch):
    """``closest_hit_chunks`` makes each pass's worklist in one
    ``worklist_pass`` call (the near passes asking for the next recheck's
    gate words, the residual not), hands its unit list to B2, and gates each
    recheck with those words; the hits equal the dense mode's."""
    calls, gates = [], []
    real_pass, real_items, real_act = ci.worklist_pass, ci.run_items, ci.tile_chunk_activity

    def worklist_pass(*args):
        out = real_pass(*args)
        calls.append((args[3], args[7], out))
        return out

    def run_items(*args):
        assert args[10] is calls[-1][2].offsets
        return real_items(*args)

    def tile_chunk_activity(*args, **kw):
        if args[3] is not None:  # a recheck
            gates.append(args[4])
        return real_act(*args, **kw)

    monkeypatch.setattr(ci, "worklist_pass", worklist_pass)
    monkeypatch.setattr(ci, "run_items", run_items)
    monkeypatch.setattr(ci, "tile_chunk_activity", tile_chunk_activity)
    _, _, _, rows, cmin, cmax, cw = _scene(16000, seed=31, spread=20.0)
    o, d = _rays(np.random.default_rng(32), 256, 24.0, 12.0)
    got = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                ray_tile=128, group=1)
    assert [(cap, want_gate) for cap, want_gate, _ in calls] == [(7, True), (21, True),
                                                                 (128, False)]
    assert len(gates) == 2 and all(g is out.gate for g, (_, _, out) in zip(gates, calls))
    dense = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                  ray_tile=128, group=1, tuning=IntersectTuning(mode="dense"))
    assert got.hit.any() and torch.equal(got.t, dense.t) and torch.equal(got.tri, dense.tri)


def test_torch_super_block_boxes_made_once():
    """The coarse gate's column-block boxes are ``group_boxes`` over 512
    chunks, made at a scene's first gate and found again at every later
    one."""
    _, _, _, _, cmin, cmax, _ = _scene(9000, seed=3)
    cmin, cmax = _t(cmin), _t(cmax)
    lo, hi = ci._block_boxes_once(cmin, -1.0), ci._block_boxes_once(cmax, 1.0)
    want = ci.group_boxes(cmin, cmax, ci.ACT_COLS)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    assert ci._block_boxes_once(cmin, -1.0) is lo and ci._block_boxes_once(cmax, 1.0) is hi
    o, d = _rays(np.random.default_rng(4), 256, 8.0)
    rays = ci.pack_rays(_t(o), _t(d))
    m8, _, _ = ci.tile_chunk_activity(rays, *want, None, None, EPS, 128)
    assert torch.equal(ci.super_block_bits(rays, cmin, cmax, EPS, 128), ci._bitpack(m8 != 0))
