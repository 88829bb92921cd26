"""The intersector's modes "twopass", "dense" and "bins" and the cheap
rechecks in the port vs the JAX package in the same mode (Pallas in
interpret mode), the per-ray group bits (B7 twin) and the bins worklist vs
their jnp originals, and the mode wrappers' device dispatch.

Tolerances: hit masks and triangle ids exactly equal.  t within 1e-6
relative plus the float32 forward-error bound of the Woop contraction, 8 *
2^-24 * (sum |o_k w_k| + |w_3|) / |q_2|: the JAX side runs through XLA,
which may contract p2 = o.w + w3 into fused multiply-adds, and from an
origin near a surface the terms are much larger than p2 (14 ulps measured
on the 16,000-triangle soup, 0.14 of the bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import IntersectTuning as JaxIntersectTuning
from tpu_pathtracer.ops import pallas_intersect as jpi
from tpu_pathtracer_torch.config import IntersectTuning
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from test_torch_chunk_intersect import _rays, _scene, _t

torch.set_num_threads(1)

EPS = 1e-4


def _both(scene, o, d, group=ci.GROUP, **tuning):
    """One mode through the JAX package (interpret mode) and the port, each
    with its own IntersectTuning built from the same keywords."""
    _, _, woop, rows, cmin, cmax, cw = scene
    want = jpi.closest_hit_chunks(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(cw), jnp.asarray(cmin), jnp.asarray(cmax),
        jnp.asarray(woop), EPS, ray_tile=128, interpret=True, group=group,
        tuning=JaxIntersectTuning(**tuning),
    )
    got = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                ray_tile=128, group=group, tuning=IntersectTuning(**tuning))
    return want, got


def _assert_same_hits(want, got, scene, o, d, min_hits=30):
    rows = scene[3]
    hw = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hw)
    assert hw.sum() >= min_hits
    np.testing.assert_array_equal(got.tri.numpy()[hw], np.asarray(want.tri)[hw])
    tw, tg = np.asarray(want.t)[hw], got.t.numpy()[hw]
    w = rows[np.asarray(want.tri)[hw]].astype(np.float64)
    terms = np.abs(o[hw] * w[:, 8:11]).sum(axis=1) + np.abs(w[:, 11])
    q2 = np.abs((d[hw] * w[:, 8:11]).sum(axis=1))
    assert (np.abs(tg - tw) <= 1e-6 * tw + 8 * 2.0**-24 * terms / q2).all()


def _aimed(seed, n_rays=256):
    """Rays from a 48-unit box aimed into the soup's middle: wide worklists,
    so near passes, rechecks and the residual all run."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-24, 24, size=(n_rays, 3)).astype(np.float32)
    d = rs.uniform(-12, 12, size=(n_rays, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("rays", ["local", "wide"])
def test_torch_twopass_matches_dense_interpret(rays, group):
    """"twopass" (B6's slot grid in the cascade) on 128 chunks: equal to the
    port's "items" bit for bit, and to the JAX "twopass" in interpret mode,
    on localized rays (short worklists) and on wide rays piercing most of
    the soup (near-pass truncation and a large residual)."""
    scene = _scene(16000, seed=11, spread=20.0)
    rs = np.random.default_rng(12)
    if rays == "local":
        o = (scene[0][scene[1]][0, 0] + rs.normal(scale=0.5, size=(256, 3))).astype(np.float32)
    else:
        o = rs.uniform(-22, 22, size=(256, 3)).astype(np.float32)
    d = rs.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want, got = _both(scene, o, d, group=group, mode="twopass")
    _assert_same_hits(want, got, scene, o, d, min_hits=20)
    _, _, _, rows, cmin, cmax, cw = scene
    items = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                  ray_tile=128, group=group)
    assert torch.equal(items.t, got.t) and torch.equal(items.tri, got.tri)


def test_torch_dense_mode_matches_jax(monkeypatch):
    """"dense" runs B5 once on the bit-packed initial activity."""
    calls = []
    real = ci.run_dense
    monkeypatch.setattr(ci, "run_dense", lambda *a: calls.append(a[4].shape) or real(*a))
    scene = _scene(2000, seed=0)
    o, d = _rays(np.random.default_rng(1), 256, 8.0)
    want, got = _both(scene, o, d, mode="dense")
    _assert_same_hits(want, got, scene, o, d)
    assert calls == [(2, 1)]  # [tiles, ceil(16 chunks / 32)]


@pytest.mark.parametrize("n_tris,seed", [(2000, 0), (16000, 3)])
def test_torch_bins_mode_matches_dense(n_tris, seed, monkeypatch):
    """"bins" (B7 bits, binned blocks, one B2 pass, scatter-min) vs the JAX
    "bins" and the port's "dense"; B5 must not run (no overflow)."""
    dense_calls = []
    real = ci.run_dense
    monkeypatch.setattr(ci, "run_dense", lambda *a: dense_calls.append(1) or real(*a))
    scene = _scene(n_tris, seed=seed)
    o, d = _rays(np.random.default_rng(seed + 1), 256, 8.0)
    want, got = _both(scene, o, d, mode="bins")
    _assert_same_hits(want, got, scene, o, d)
    assert not dense_calls
    _, _, _, rows, cmin, cmax, cw = scene
    dense = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                  ray_tile=128, tuning=IntersectTuning(mode="dense"))
    assert torch.equal(dense.t, got.t) and torch.equal(dense.tri, got.tri)


def test_torch_bins_overflow_falls_back_dense(monkeypatch):
    """bins_cap 1 (TPU_PT_BINS_CAP) overflows the binned rows: B5 runs on
    the bits derived from the per-ray group bits, B2 does not, and the
    result equals the JAX overflow branch and the port's "dense"."""
    calls = []
    for name in ("run_dense", "run_items"):
        real = getattr(ci, name)
        monkeypatch.setattr(ci, name, lambda *a, real=real, name=name: calls.append(name)
                            or real(*a))
    monkeypatch.setenv("TPU_PT_BINS_CAP", "1")
    scene = _scene(2000, seed=4)
    o, d = _rays(np.random.default_rng(5), 128, 8.0, aim=2.0)  # most rays pierce both groups
    jpi.closest_hit_chunks.clear_cache()
    want, got = _both(scene, o, d, mode="bins")
    jpi.closest_hit_chunks.clear_cache()
    _assert_same_hits(want, got, scene, o, d)
    assert calls == ["run_dense"]
    _, _, _, rows, cmin, cmax, cw = scene
    dense = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                  ray_tile=128, tuning=IntersectTuning(mode="dense"))
    assert torch.equal(dense.t, got.t) and torch.equal(dense.tri, got.tri)


@pytest.mark.parametrize("mode", ["items", "twopass"])
@pytest.mark.parametrize("cheap", [1, 2])
def test_torch_cheap_recheck_matches_dense(cheap, mode, monkeypatch):
    """cheap_recheck 1 (every recheck cheap) and 2 (cheap between near
    passes, full before the residual) on 128 single-chunk groups, n_sub 2:
    equal to the JAX package in the same setting and to the full recheck;
    form 1 must run B1 once only, form 2 once more before the residual."""
    calls = []
    real = ci.tile_chunk_activity
    monkeypatch.setattr(ci, "tile_chunk_activity", lambda *a, **k: calls.append(1) or real(*a, **k))
    scene = _scene(16000, seed=41, spread=20.0)
    o, d = _aimed(42)
    want, got = _both(scene, o, d, group=1, mode=mode, cheap_recheck=cheap)
    _assert_same_hits(want, got, scene, o, d, min_hits=100)
    assert len(calls) == cheap  # the initial pass (+ the final full recheck)
    _, _, _, rows, cmin, cmax, cw = scene
    full = ci.closest_hit_chunks(_t(o), _t(d), _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                 ray_tile=128, group=1)
    assert torch.equal(full.t, got.t) and torch.equal(full.tri, got.tri)


def test_torch_unknown_intersect_mode_rejected():
    _, _, _, rows, cmin, cmax, cw = _scene(512, seed=7, spread=8.0)
    o = torch.zeros((128, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(128, 3).contiguous()
    for tuning, match in ((IntersectTuning(mode="item"), "unknown intersect mode"),
                          (IntersectTuning(cheap_recheck=3), "unknown cheap_recheck")):
        with pytest.raises(ValueError, match=match):
            ci.closest_hit_chunks(o, d, _t(cw), _t(cmin), _t(cmax), _t(rows), EPS,
                                  ray_tile=128, tuning=tuning)


@pytest.mark.parametrize("group", [1, 8])
def test_torch_ray_group_bools_twin_matches_jax(group):
    """B7 twin vs ``ray_group_bools`` in interpret mode: NaN-padded chunks
    (1,100 triangles in a 2,048 capacity, then padded to 512 columns) and
    origins exactly on chunk-AABB planes with a zero direction component.
    Exactly equal bits."""
    _, _, _, _, cmin, cmax, _ = _scene(1100, seed=7)
    rs = np.random.default_rng(8)
    o, d = _rays(rs, 256, 8.0)
    real = np.nonzero(np.isfinite(cmin[:, 0]))[0]
    for i in range(32):
        c = real[i % len(real)]
        a = i % 3
        o[i] = (cmin[c] + cmax[c]) / 2
        o[i, a] = cmin[c, a] if i % 2 else cmax[c, a]
        d[i, a] = 0.0
        d[i] /= np.linalg.norm(d[i])
    rays = np.concatenate([o, np.ones((256, 1), np.float32), d, np.zeros((256, 1), np.float32)], 1)
    want = np.asarray(jpi.ray_group_bools(jnp.asarray(rays), jnp.asarray(cmin), jnp.asarray(cmax),
                                          EPS, 128, group, interpret=True))
    got = ci.ray_group_bools(_t(rays), _t(cmin), _t(cmax), EPS, group)
    assert got.dtype == torch.int32 and got.shape == (512 // group, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    assert not want[-(-cmin.shape[0] // group):].any()  # padding groups never match


@pytest.mark.parametrize("p_cap", [1200, 160], ids=["fits", "overflow"])
def test_torch_bins_worklist_matches_jax(p_cap):
    """_bins_worklist vs its jnp original on every output, at a capacity
    that holds the ~600 pierced pairs and at one that overflows."""
    rs = np.random.default_rng(9)
    gb = (rs.random((13, 256)) < 0.18).astype(np.int32)
    gb[4] = 0  # an empty group
    want = jpi._bins_worklist(jnp.asarray(gb), 32, p_cap)
    got = ci._bins_worklist(_t(gb), 32, p_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == (p_cap == 160)


def test_torch_mode_wrappers_reject_other_devices():
    """B5, B6 and B7's wrappers: a CPU tensor goes to the twin, a CUDA
    tensor to the kernel; any other device raises instead of falling back."""
    rays = torch.zeros((128, 8), device="meta")
    woop = torch.zeros((8, 12, 128), device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    box = torch.zeros((8, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.run_dense(rays, rays[:, 0], idx[0], woop, idx, EPS)
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.run_slots(rays, rays[:, 0], idx[0], woop, idx, idx[0], idx[:, :, None], EPS, 8, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.ray_group_bools(rays, box, box, EPS, 8)
