"""The chunk cascade's plain twins and glue vs the JAX package: the B1 twin
against the Pallas activity kernel in interpret mode, the cascade against
the dense sweep, and the worklist helpers against their jnp originals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import pallas_intersect as jpi
from tpu_pathtracer.ops.intersect import closest_hit as jax_closest_hit
from tpu_pathtracer.scene.accel import LEAF_SIZE, build_leaves, chunk_aabbs, morton_order
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.scene.gltf import build_chunk_woop, build_woop, tri_capacity

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
