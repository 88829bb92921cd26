"""Kernels K1 (the flat light-cluster pdf, ``ops.intersect.light_pdf_flat``),
K2 (``hit_info``'s row gather and texture fetch,
``models.pathtracer.hit_info``), K3 and K4 (the bounce's sampling / BSDF
chain before and after the light pdf, ``models.pathtracer.shade_sample``
and ``shade_finish``): their plain twins against the JAX functions on the
same numpy inputs (K3's and K4's around the light pdf against the JAX
package's ``bounce_step``), the CPU dispatch to the twins, the C
signatures of the kernel library, and (marker ``cuda``) each kernel against
its twin on the card.

Tolerances.  Twin and JAX function compute in float32 in the same operation
order, but XLA's CPU backend and PyTorch round pow and the sqrt / divide
chains of ``normalize`` an ulp or two apart and sum 3 and 128 terms in
other orders, so floats are held to rtol 1e-5 / atol 1e-6
(``tests/test_torch_ops.py``'s rule); the pdf's zero pattern and the
``inside`` flags are exact.  On the card K2 is held to at most 2 ulp from
its twin (the goal, measured so far, is 0) and K1 to its twin's zero
pattern with a relative error of at most 1e-5 (its sum over a cluster runs
in the kernel's own order); K3 and K4 to their twins bit for bit, and the
atrium's frame through them to the eager loop's and to the twin chain's
bit for bit.  Run the card cases with
``python -m pytest tests/test_torch_shade_kernels.py -m cuda``.
"""

import ctypes
import dataclasses
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer import config as jcfg
from tpu_pathtracer.models import pathtracer as jpt
from tpu_pathtracer.ops import intersect as jisect
from tpu_pathtracer.scene import types as jtypes
from tpu_pathtracer_torch import kernels
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import intersect as tisect
from tpu_pathtracer_torch.scene import gltf as tgltf
from tpu_pathtracer_torch.scene import types as ttypes

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
R = 512
EPS = 1e-4
MISSES = 32  # lanes 0..31 of every shading batch are missed rays (tri 0)
FIELDS = ("normal", "shading_normal", "color", "emission", "metallic", "roughness", "ior")


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# K2: hit_info
# ---------------------------------------------------------------------------


def _images(rs):
    """Atlas images: the two builtin 1x1 textures, three of the scene's
    (one of them 1x1) and a normal map."""
    nrm = np.concatenate([rs.uniform(0.3, 0.7, (6, 4, 2)), rs.uniform(0.8, 1.0, (6, 4, 1)),
                          np.ones((6, 4, 1))], axis=-1)
    return [
        np.array([[[1, 1, 1, 1]]], np.float32),
        np.array([[[0.5, 0.5, 1, 0]]], np.float32),
        rs.random((5, 7, 4)).astype(np.float32),
        rs.random((8, 3, 4)).astype(np.float32),
        rs.random((1, 1, 4)).astype(np.float32),
        nrm.astype(np.float32),
    ]


def _atlases(images, quad):
    """The same atlas for both packages (flat pool, or flat + quad pool)."""
    offs = np.cumsum([0] + [im.shape[0] * im.shape[1] for im in images[:-1]]).astype(np.int32)
    arrays = dict(
        texels=np.concatenate([im.reshape(-1, 4) for im in images]),
        offset=offs,
        width=np.array([im.shape[1] for im in images], np.int32),
        height=np.array([im.shape[0] for im in images], np.int32),
        quad=tgltf.quad_pool(images, 1 << 20) if quad else None,
    )
    jat = jtypes.TextureAtlas(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    tat = ttypes.TextureAtlas(**{k: None if v is None else torch.from_numpy(v)
                                 for k, v in arrays.items()})
    return jat, tat


def _shade_case(seed, tex_slots, quad=False, builtin_only=False):
    """A batch of R hits on 64 random triangles with random materials:
    (JAX scene, port scene, JAX hit, port hit, direction).  Each used
    slot's texture ids include a 1x1 texture; lanes 0..31 are missed rays
    (tri 0, barycentrics 0), as the intersectors give them."""
    rs = np.random.default_rng(seed)
    n = 64
    attrs = np.zeros((n, 48), np.float32)
    attrs[:, 0:9] = rs.uniform(-2, 2, (n, 9))
    attrs[:, 9:18] = _unit(rs, 3 * n).reshape(n, 9)
    attrs[:, 18:24] = rs.uniform(-3, 3, (n, 6))
    attrs[:, 24:33] = _unit(rs, 3 * n).reshape(n, 9)
    attrs[:, 33:37] = rs.uniform(0.1, 1.0, (n, 4))
    attrs[:, 37:40] = rs.uniform(0.0, 2.0, (n, 3))
    attrs[:, 40] = rs.choice([0.0, 0.5, 1.0], n)
    attrs[:, 41] = rs.uniform(0.05, 1.0, n)
    attrs[:, 42] = rs.uniform(1.0, 2.0, n)
    for col, ids in ((43, [0, 2, 3, 4]), (44, [0, 2, 3, 4]), (45, [0, 2, 3]), (46, [1, 5])):
        attrs[:, col] = rs.choice(ids, n)
    tri = rs.integers(0, n, R).astype(np.int32)
    u, v = rs.random(R).astype(np.float32), rs.random(R).astype(np.float32)
    flip = u + v > 1
    beta = np.where(flip, 1 - u, u).astype(np.float32)
    gamma = np.where(flip, 1 - v, v).astype(np.float32)
    hit = np.ones(R, bool)
    tri[:MISSES], beta[:MISSES], gamma[:MISSES], hit[:MISSES] = 0, 0, 0, False
    t = np.where(hit, rs.uniform(0.1, 5, R), np.inf).astype(np.float32)
    d = _unit(rs, R)
    images = _images(rs)
    jat, tat = _atlases(images[:2] if builtin_only else images, quad)
    jscene = types.SimpleNamespace(shade_attrs=jnp.asarray(attrs), atlas=jat, tex_slots=tex_slots)
    tscene = types.SimpleNamespace(shade_attrs=torch.from_numpy(attrs), atlas=tat,
                                   tex_slots=tex_slots)
    jhit = jisect.Hit(*(jnp.asarray(a) for a in (t, tri, beta, gamma, hit)))
    thit = tisect.Hit(*(torch.from_numpy(a) for a in (t, tri, beta, gamma, hit)))
    return jscene, tscene, jhit, thit, d


def _assert_hit_info_equal(want, got):
    inside = np.asarray(want["inside"])
    np.testing.assert_array_equal(got["inside"].numpy(), inside)
    assert inside.any() and not inside.all()
    for key in FIELDS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("pool", ["flat", "quad"])
@pytest.mark.parametrize("slots", range(16))
def test_torch_hit_info_twin_matches_jax(slots, pool):
    """K2's twin (``hit_info`` on CPU tensors) against the JAX package's
    ``hit_info`` with every on / off combination of the four texture slots
    (bit k: color, emissive, metallic-roughness, normal), from the flat and
    from the quad texel pool, over 1x1 textures, inside hits and missed
    lanes."""
    tex_slots = tuple(bool(slots >> k & 1) for k in range(4))
    jscene, tscene, jhit, thit, d = _shade_case(slots, tex_slots, quad=pool == "quad")
    want = jpt.hit_info(jscene, jnp.asarray(d), jhit, jcfg.RenderConfig())
    got = pt.hit_info(tscene, torch.from_numpy(d), thit, RenderConfig())
    _assert_hit_info_equal(want, got)
    if slots:  # a used slot samples a 1x1 texture on some lanes
        ids = tscene.shade_attrs[thit.tri.long()][:, 43:47].long()
        one = (tscene.atlas.width * tscene.atlas.height)[ids] == 1
        assert one[:, [k for k in range(4) if tex_slots[k]]].any()


@pytest.mark.parametrize("case", ["use_textures_off", "builtin_atlas"])
def test_torch_hit_info_twin_without_textures_matches_jax(case):
    """No texture is fetched when the config turns textures off or the atlas
    holds only the two builtin 1x1 textures, whatever the slot bits say:
    the material's factors come through unchanged, in both packages."""
    jscene, tscene, jhit, thit, d = _shade_case(21, (True,) * 4,
                                                builtin_only=case == "builtin_atlas")
    use = case != "use_textures_off"
    want = jpt.hit_info(jscene, jnp.asarray(d), jhit, jcfg.RenderConfig(use_textures=use))
    got = pt.hit_info(tscene, torch.from_numpy(d), thit, RenderConfig(use_textures=use))
    _assert_hit_info_equal(want, got)
    row = tscene.shade_attrs[thit.tri.long()]
    assert torch.equal(got["color"], row[:, 33:37]) and torch.equal(got["emission"], row[:, 37:40])


# ---------------------------------------------------------------------------
# K1: the flat light-cluster pdf
# ---------------------------------------------------------------------------

# Light counts whose padded light sets fill 1, 2, 3 and 4 clusters of 128.
LIGHT_COUNTS = {1: 6, 2: 200, 3: 300, 4: 500}


def _light_case(n_clusters, seed=3):
    """(origins, directions, cluster_woop, cluster_k, count): random light
    triangles packed into clusters as the loader packs them (padding lanes:
    NaN Woop rows, k = 0); half the rays aimed at a light, half random."""
    rs = np.random.default_rng(seed + n_clusters)
    count = LIGHT_COUNTS[n_clusters]
    cap = ttypes.pad_to(count)
    lverts = np.full((cap, 3, 3), 1e30, np.float32)
    centers = rs.uniform(-3, 3, (count, 1, 3))
    lverts[:count] = centers + rs.uniform(-0.5, 0.5, (count, 3, 3))
    _, _, cw, ck = tgltf.light_clusters(lverts, count)
    assert cw.shape[0] == n_clusters and np.isnan(cw).any()
    o = rs.uniform(-5, 5, (R, 3)).astype(np.float32)
    target = lverts[rs.integers(0, count, R)].mean(axis=1) + rs.uniform(-0.05, 0.05, (R, 3))
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    d[R // 2:] = _unit(rs, R - R // 2)
    return o, d.astype(np.float32), cw, ck, count


@pytest.mark.parametrize("n_clusters", [1, 2, 3, 4])
def test_torch_light_pdf_flat_twin_matches_jax(n_clusters):
    """K1's twin (``light_pdf_flat`` on CPU tensors) against the JAX
    package's ``light_pdf_sum_flat`` at 1 to 4 clusters with padded lanes:
    the same zero pattern, values to the module tolerance."""
    o, d, cw, ck, count = _light_case(n_clusters)
    want = np.asarray(jisect.light_pdf_sum_flat(jnp.asarray(o), jnp.asarray(d), jnp.asarray(cw),
                                                jnp.asarray(ck), jnp.asarray(count), EPS))
    got = tisect.light_pdf_flat(*(torch.from_numpy(a) for a in (o, d, cw, ck)), count, EPS)
    assert (want > 0).sum() > R // 4
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_clusters", [1, 2, 3, 4])
def test_torch_light_pdf_nan_lanes_add_nothing(n_clusters):
    """The rule K1 skips lanes by: a light with any NaN among its 12 Woop
    values adds exactly nothing to the twin's sum.  Padding lanes keep the
    sum bit for bit with their k made NaN (a lane that passed the test
    would add NaN); valid lights with one random Woop value made NaN give
    the same bits as with all twelve made NaN."""
    o, d, cw, ck, count = _light_case(n_clusters)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    base = tisect.light_pdf_sum_flat(t(o), t(d), t(cw), t(ck), count, EPS)
    pad = np.isnan(cw).any(axis=1)  # [C, cw] lanes with a NaN value
    ck_nan = np.where(pad, np.nan, ck).astype(np.float32)
    assert torch.equal(tisect.light_pdf_sum_flat(t(o), t(d), t(cw), t(ck_nan), count, EPS), base)
    rs = np.random.default_rng(n_clusters)
    c, lane = np.nonzero(~pad)
    pick = rs.choice(len(c), size=min(5, len(c)), replace=False)
    one, every = cw.copy(), cw.copy()
    for k in pick:
        one[c[k], rs.integers(0, 12), lane[k]] = np.nan
        every[c[k], :, lane[k]] = np.nan
    got_one = tisect.light_pdf_sum_flat(t(o), t(d), t(one), t(ck), count, EPS)
    got_every = tisect.light_pdf_sum_flat(t(o), t(d), t(every), t(ck), count, EPS)
    assert torch.isfinite(got_one).all() and torch.equal(got_one, got_every)


# ---------------------------------------------------------------------------
# K3 / K4: the bounce's sampling / BSDF chain around the light pdf
# ---------------------------------------------------------------------------

CHAIN_R = 512  # a multiple of the light worklists' ray tile (B3's twin)


def _chain_scenes(tmp_path, monkeypatch, env, lights):
    """(JAX scene, port scene, port config, JAX config) of the Cornell box
    (lights "rows": its ceiling light, at most 4 clusters; "none": a light
    set with no rows) or of the thousand-light field ("many": past 512
    light slots), with the HDR environment map or the background colour;
    the port's scene is the JAX scene's arrays through the bridge."""
    from test_torch_many_lights import _thousand_light_gltf
    from test_torch_scene import jax_config, jax_scene_arrays, same_host_path

    from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
    from tpu_pathtracer_torch.bridge import scene_from_arrays
    from tpu_pathtracer_torch.scene import fixtures

    same_host_path(monkeypatch)
    config = RenderConfig()
    if env == "env":
        config = RenderConfig(use_env_map=True,
                              env_map_path=fixtures.make_env_hdr(str(tmp_path / "env.hdr")))
    if lights == "many":
        path = _thousand_light_gltf(str(tmp_path / "m" / "s.gltf"), True)
    else:
        path = fixtures.make_cornell_gltf(str(tmp_path / "c" / "c.gltf"))
    jconfig = jax_config(config)
    js = jax_parse(path, 1.0, jconfig)
    js = dataclasses.replace(js, camera=js.camera.with_dims(16, 16))
    if lights == "none":
        js = dataclasses.replace(js, lights=dataclasses.replace(
            js.lights, verts=jnp.zeros((0, 3, 3), jnp.float32),
            normal=jnp.zeros((0, 3), jnp.float32), area=jnp.zeros((0,), jnp.float32),
            count=jnp.asarray(0, jnp.int32), cluster_min=None, cluster_max=None,
            cluster_woop=None, cluster_k=None))
    arrays, statics = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, {**statics, "width": 16, "height": 16})
    assert ts.has_env == (env == "env") and ts.lights.capacity == (0 if lights == "none" else
                                                                   ts.lights.capacity)
    return js, ts, config, jconfig


def _chain_rays(ts, config, seed):
    """Lanes: the primaries of the camera's pixels and one bounce of them
    (the secondaries, dead lanes included), with a random throughput and
    radiance, every 5th lane dead, and the bounce draws of ``config`` at
    depth 1 (CHAIN_R lanes at 16x16)."""
    from tpu_pathtracer_torch.ops.rng import jitter_uniforms

    g = torch.Generator().manual_seed(seed)
    n = ts.camera.width * ts.camera.height
    pids = torch.arange(n, dtype=torch.int32)
    o, d = pt.gen_rays(ts.camera, pids, jitter_uniforms(seed, 0, pids))
    ones = torch.ones(n, dtype=torch.bool)
    o2, d2, _, _, alive2, _ = pt.bounce_step(ts, config, o, d, torch.ones_like(o),
                                             torch.zeros_like(o), ones,
                                             pt.bounce_draws(seed, 0, 0, pids, config))
    o, d = torch.cat([o, o2]), torch.cat([d, d2])
    alive = torch.cat([ones, alive2])
    alive[::5] = False
    lanes = torch.arange(2 * n, dtype=torch.int32) % n
    return dict(o=o, d=d, alive=alive, throughput=0.1 + torch.rand((2 * n, 3), generator=g),
                radiance=torch.rand((2 * n, 3), generator=g),
                draws=pt.bounce_draws(seed, 0, 1, lanes, config))


@pytest.mark.parametrize("lowdisc", ["off", "sobol"])
@pytest.mark.parametrize("lights", ["rows", "none", "many"])
@pytest.mark.parametrize("env", ["env", "bg"])
def test_torch_shade_chain_twins_match_jax_bounce(tmp_path, monkeypatch, env, lights, lowdisc):
    """K3's and K4's twins around the light pdf (``shade_sample_plain`` ->
    ``light_pdf`` -> ``shade_finish_plain``) against the JAX package's
    ``bounce_step`` on the same rays, draws and hits (the port's hits, given
    to the JAX function): the next bounce's live lanes and sort hints
    exactly, its origin, direction, throughput and radiance to the module
    tolerance; with an environment map or the background, light rows (the
    flat pdf), none, or past 512 light slots (the cluster worklists, where
    the JAX package on the CPU takes the dense sum), Sobol draws or not."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    js, ts, config, jconfig = _chain_scenes(tmp_path, monkeypatch, env, lights)
    config = dataclasses.replace(config, lowdisc=lowdisc)
    jconfig = dataclasses.replace(jconfig, lowdisc=lowdisc)
    x = _chain_rays(ts, config, seed=7)
    hit = pt.scene_closest_hit(ts, x["o"], x["d"], config.eps, config.tuning)
    info = pt.hit_info(ts, x["d"], hit, config)
    pos, new_dir, radiance, flags = pt.shade_sample_plain(
        ts, config, x["o"], x["d"], x["throughput"], x["radiance"], x["alive"], x["draws"],
        hit, info)
    worklists = []
    real = ci.run_light_pdf
    monkeypatch.setattr(ci, "run_light_pdf", lambda *a: worklists.append(1) or real(*a))
    p_light = pt.light_pdf(ts, pos, new_dir, config.eps)
    got = pt.shade_finish_plain(ts, config, x["o"], x["d"], x["throughput"], hit, info, pos,
                                new_dir, flags, p_light)
    got = dict(zip(("o", "d", "throughput", "alive", "hint"), got), radiance=radiance)

    jhit = jisect.Hit(*(jnp.asarray(a.numpy()) for a in hit))
    monkeypatch.setattr(jpt, "scene_closest_hit", lambda *a, **k: jhit)
    j = jnp.asarray
    want = jpt.bounce_step(js, jconfig, j(x["o"].numpy()), j(x["d"].numpy()),
                           j(x["throughput"].numpy()), j(x["radiance"].numpy()),
                           j(x["alive"].numpy()), j(x["draws"].numpy()))
    want = dict(zip(("o", "d", "throughput", "radiance", "alive", "hint"), want))

    shade, miss = flags[:, 0], x["alive"] & ~hit.hit
    assert int(shade.sum()) > CHAIN_R // 8 and int(got["alive"].sum()) > CHAIN_R // 8
    assert bool(miss.any())  # missed live rays take the environment or the background
    assert (p_light is None) == (lights == "none")
    assert bool(worklists) == (lights == "many")
    if p_light is not None:
        assert bool((p_light[shade] > 0).any())
    np.testing.assert_array_equal(got["alive"].numpy(), np.asarray(want["alive"]))
    np.testing.assert_array_equal(got["hint"].numpy(), np.asarray(want["hint"]))
    for key in ("o", "d", "throughput", "radiance"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# Dispatch and the C interface
# ---------------------------------------------------------------------------


def test_torch_shading_kernels_dispatch_cpu_to_twins(monkeypatch):
    """CPU tensors run the twins and never reach a kernel library, and no
    launch is counted."""
    def refuse(name):
        raise AssertionError(f"CPU tensors reached the kernel library {name}")

    monkeypatch.setattr(kernels, "library", refuse)
    o, d, cw, ck, count = _light_case(2)
    args = [torch.from_numpy(a) for a in (o, d, cw, ck)]
    k1, k2 = kernels.launches["k1"], kernels.launches["k2"]
    assert torch.equal(tisect.light_pdf_flat(*args, count, EPS),
                       tisect.light_pdf_sum_flat(*args, count, EPS))
    _, tscene, _, thit, dd = _shade_case(5, (True,) * 4)
    got = pt.hit_info(tscene, torch.from_numpy(dd), thit, RenderConfig())
    want = pt.hit_info_plain(tscene, torch.from_numpy(dd), thit, RenderConfig())
    assert all(torch.equal(got[k], want[k]) for k in FIELDS + ("inside",))
    assert (kernels.launches["k1"], kernels.launches["k2"]) == (k1, k2)


def test_torch_shading_kernels_refuse_other_devices():
    """A tensor on a device that is neither CUDA nor the CPU raises: no
    kernel and no twin runs there."""
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tisect.light_pdf_flat(meta, meta, torch.empty((1, 12, 128), device="meta"),
                              torch.empty((1, 128), device="meta"), 1, EPS)
    _, tscene, _, thit, _ = _shade_case(6, (True,) * 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        pt.hit_info(tscene, torch.empty((R, 3), device="meta"), thit, RenderConfig())


def _cornell_chain(tmp_path):
    """The Cornell box at 16x16 and ``_chain_rays``' inputs with their hits
    and hit record."""
    from tpu_pathtracer_torch.scene import fixtures

    config = RenderConfig()
    ts = tgltf.parse_gltf_scene(fixtures.make_cornell_gltf(str(tmp_path / "c.gltf")), 1.0, config)
    ts = dataclasses.replace(ts, camera=ts.camera.with_dims(16, 16))
    x = _chain_rays(ts, config, seed=3)
    x["hit"] = pt.scene_closest_hit(ts, x["o"], x["d"], config.eps, config.tuning)
    x["info"] = pt.hit_info(ts, x["d"], x["hit"], config)
    return ts, config, x


def test_torch_shade_chain_dispatch_cpu_to_twins(tmp_path, monkeypatch):
    """CPU tensors run K3's and K4's twins through ``shade_sample`` and
    ``shade_finish`` (and so through ``bounce_step``), never reach a kernel
    library, and count no launch; ``bounce_step`` is the twins around the
    light pdf."""
    def refuse(name):
        raise AssertionError(f"CPU tensors reached the kernel library {name}")

    ts, config, x = _cornell_chain(tmp_path)
    monkeypatch.setattr(kernels, "library", refuse)
    n3, n4 = kernels.launches["k3"], kernels.launches["k4"]
    args = (x["o"], x["d"], x["throughput"], x["radiance"], x["alive"], x["draws"], x["hit"],
            x["info"])
    got = pt.shade_sample(ts, config, *args)
    want = pt.shade_sample_plain(ts, config, *args)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    pos, new_dir, radiance, flags = want
    p_light = pt.light_pdf(ts, pos, new_dir, config.eps)
    args = (x["o"], x["d"], x["throughput"], x["hit"], x["info"], pos, new_dir, flags, p_light)
    got = pt.shade_finish(ts, config, *args)
    want = pt.shade_finish_plain(ts, config, *args)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    step = pt.bounce_step(ts, config, x["o"], x["d"], x["throughput"], x["radiance"], x["alive"],
                          x["draws"])
    assert all(_bits_equal(a, b) for a, b in zip(step, want[:3] + (radiance,) + want[3:]))
    assert (kernels.launches["k3"], kernels.launches["k4"]) == (n3, n4)


def test_torch_shade_chain_refuses_other_devices():
    """K3's and K4's wrappers raise for a tensor on a device that is neither
    CUDA nor the CPU: no kernel and no twin runs there."""
    meta = torch.empty((R, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        pt.shade_sample(None, RenderConfig(), meta, meta, meta, meta, None, None, None, None)
    with pytest.raises(RuntimeError, match="no kernel"):
        pt.shade_finish(None, RenderConfig(), meta, meta, meta, None, None, meta, meta, None,
                        None)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "unsigned": ctypes.c_uint}


def _c_entry_points(library):
    """{name: [ctypes argument types]} of the ``extern "C"`` functions of
    ``csrc/<library>.cu``, read from its text."""
    with open(os.path.join(kernels._CSRC, library + ".cu")) as f:
        src = f.read()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[name] = [_C_TYPES[re.sub(r"\s*\w+$", "", " ".join(p.split()))]
                     for p in params.split(",")]
    return out


@pytest.mark.parametrize("entry", [f"{lib}.{fn}" for lib, fns in kernels.LIBRARIES.items()
                                   for fn in fns])
def test_torch_kernel_entry_point_matches_c_signature(entry):
    """Each ``kernels.LIBRARIES`` entry's ctypes argument types are the
    parameters of the ``extern "C"`` function of the same name in its
    ``.cu`` file, in order (a pointer passed as an int would be cut to 32
    bits; a float passed as an int would be garbage)."""
    lib, fn = entry.split(".")
    assert kernels.LIBRARIES[lib][fn] == _c_entry_points(lib)[fn]


def test_torch_kernel_libraries_list_every_entry_point():
    """Every ``.cu`` under ``csrc/`` is a library of ``kernels.LIBRARIES``
    and every ``extern "C"`` function in it is listed (the shade kernels
    K1 to K4 included)."""
    sources = sorted(f[:-3] for f in os.listdir(kernels._CSRC) if f.endswith(".cu"))
    assert sorted(kernels.LIBRARIES) == sources
    for lib in sources:
        assert sorted(kernels.LIBRARIES[lib]) == sorted(_c_entry_points(lib))
    assert set(kernels.LIBRARIES["shade_kernels"]) == {"tpt_light_pdf_flat", "tpt_shade_gather",
                                                       "tpt_shade_sample", "tpt_shade_finish"}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ulps(a, b):
    """Elementwise distance of two float32 tensors in units in the last
    place (two NaNs: 0)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    both = torch.isnan(a) & torch.isnan(b)
    return torch.where(both, 0, (ordered(a) - ordered(b)).abs())


@pytest.mark.cuda
def test_torch_cuda_sum3_and_scalar_division_orders():
    """The two roundings of PyTorch's CUDA kernels that K1 and K2 copy
    (``csrc/shade_kernels.cu``): ``torch.sum`` over a last dimension of 3,
    contiguous or strided, adds (a0 + a2) + a1; a division by a Python
    scalar multiplies by the scalar's float32 reciprocal."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    rows = torch.randn((1 << 20, 16), generator=g).cuda()
    for v in (rows[:, :3].contiguous(), rows[:, 3:6]):
        p = v * v
        assert torch.equal(torch.sum(p, dim=-1), (p[:, 0] + p[:, 2]) + p[:, 1])
        assert not torch.equal(torch.sum(p, dim=-1), (p[:, 0] + p[:, 1]) + p[:, 2])
    x = rows[:, 6].contiguous() * 10
    for count in (3, 6, 7):
        assert torch.equal(x / float(count), x * float(np.float32(1.0) / np.float32(count)))


@pytest.mark.cuda
def test_torch_cuda_roundings_k3_k4_copy():
    """More roundings of PyTorch's CUDA kernels that K3 and K4 copy
    (``csrc/shade_kernels.cu``): ``torch.sum`` over 3 gives +0 where the
    terms are all -0 (each lane's partial starts from 0); ``1.0 / x`` is
    the IEEE divide of ``torch.reciprocal``; ``clamp_min`` and ``clamp``
    return NaN for NaN; a Python float operand is rounded to float32."""
    _needs_card()
    z = torch.full((1024, 3), -0.0, device="cuda")
    assert not bool(torch.signbit(torch.sum(z, dim=-1)).any())
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(1 << 20, generator=g) * 10 + 1e-3).cuda()
    assert torch.equal(1.0 / x, torch.ones_like(x) / x)
    nan = torch.tensor([float("nan"), -2.0, 2.0], device="cuda")
    assert torch.isnan(torch.clamp_min(nan, 0.0)[0]) and torch.isnan(torch.clamp(nan, -1, 1)[0])
    assert torch.equal(torch.clamp(nan, -1.0, 1.0)[1:], torch.tensor([-1.0, 1.0], device="cuda"))
    pi = float(np.float32(np.pi))
    assert torch.equal(x * np.pi, x * pi)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters", [1, 2, 3, 4])
def test_torch_light_pdf_flat_kernel_equals_twin(n_clusters):
    """K1 against its twin on the card: the same zero pattern, relative error
    <= 1e-5 on the non-zero values, the same bits on a second launch, one
    launch counted."""
    _needs_card()
    o, d, cw, ck, count = _light_case(n_clusters)
    args = [torch.from_numpy(a).cuda() for a in (o, d, cw, ck)]
    n0 = kernels.launches["k1"]
    got = tisect.light_pdf_flat(*args, count, EPS)
    assert kernels.launches["k1"] == n0 + 1
    want = tisect.light_pdf_sum_flat(*args, count, EPS)
    nz = want != 0
    assert nz.sum() > R // 4 and torch.equal(got != 0, nz)
    assert float(((got[nz] - want[nz]).abs() / want[nz]).max()) <= 1e-5
    assert torch.equal(tisect.light_pdf_flat(*args, count, EPS), got)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["flat", "quad"])
@pytest.mark.parametrize("slots", [0, 1, 2, 4, 8, 15])
def test_torch_shade_gather_kernel_equals_twin(slots, pool):
    """K2 against its twin on the card: ``inside`` exact and every float of
    the record within 2 ulp (the goal is the same bits), one launch
    counted."""
    _needs_card()
    tex_slots = tuple(bool(slots >> k & 1) for k in range(4))
    _, tscene, _, thit, d = _shade_case(slots, tex_slots, quad=pool == "quad")
    scene = types.SimpleNamespace(
        shade_attrs=tscene.shade_attrs.cuda(), tex_slots=tex_slots,
        atlas=ttypes.TextureAtlas(**{f.name: None if getattr(tscene.atlas, f.name) is None
                                     else getattr(tscene.atlas, f.name).cuda()
                                     for f in dataclasses.fields(tscene.atlas)}))
    hit = tisect.Hit(*(x.cuda() for x in thit))
    dd = torch.from_numpy(d).cuda()
    n0 = kernels.launches["k2"]
    got = pt.hit_info(scene, dd, hit, RenderConfig())
    assert kernels.launches["k2"] == n0 + 1
    want = pt.hit_info_plain(scene, dd, hit, RenderConfig())
    assert torch.equal(got["inside"], want["inside"])
    for key in FIELDS:
        assert int(_ulps(got[key], want[key]).max()) <= 2, key


def _on_card(scene, config, x):
    """``_chain_rays``' inputs on the card with their hits and K2's record,
    every third lane's alpha made 0.3 so the roulette lets rays through."""
    x = {k: v.cuda() for k, v in x.items()}
    x["hit"] = pt.scene_closest_hit(scene, x["o"], x["d"], config.eps, config.tuning)
    rec = pt.hit_info(scene, x["d"], x["hit"], config)["record"].clone()
    rec[::3, 9] = 0.3
    x["info"] = dict(normal=rec[:, 0:3], shading_normal=rec[:, 3:6], color=rec[:, 6:10],
                     emission=rec[:, 10:13], metallic=rec[:, 13], roughness=rec[:, 14],
                     ior=rec[:, 15], record=rec)
    return x


def _card_scene(tmp_path, name):
    """(scene on the card, config) of the atrium, the env-lit sphere field
    with the light triangle, the textured Cornell box or the thousand-light
    field, with a 32x32 camera (2,048 lanes of ``_chain_rays``: whole ray
    tiles of the chunk cascade)."""
    from test_torch_many_lights import _thousand_light_gltf

    from tpu_pathtracer_torch.scene import fixtures

    config = RenderConfig()
    if name == "atrium":
        path = fixtures.make_atrium_gltf(str(tmp_path / "a.gltf"), detail=1)
    elif name == "env_field":
        path = fixtures.make_sphere_field_gltf(str(tmp_path / "f.gltf"), n_spheres=8, subdiv=2,
                                               textured=True)
        config = RenderConfig(use_env_map=True, add_light_triangle=True,
                              env_map_path=fixtures.make_env_hdr(str(tmp_path / "env.hdr")))
    elif name == "textured_cornell":
        path = fixtures.make_textured_cornell_gltf(str(tmp_path / "t.gltf"))
    else:
        path = _thousand_light_gltf(str(tmp_path / "m.gltf"), True)
    scene = tgltf.parse_gltf_scene(path, 1.0, config)
    return dataclasses.replace(scene, camera=scene.camera.with_dims(32, 32)).to("cuda"), config


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        return bool(((a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["atrium", "env_field", "textured_cornell", "many_lights"])
def test_torch_shade_chain_kernels_equal_twins(tmp_path, name):
    """K3 and K4 against their twins on the card, bit for bit, on primaries
    and secondaries of the atrium, the env-lit field, the textured Cornell
    box and the thousand-light field (the light pdf from the cluster
    worklists), with rays the roulette lets through; one launch each
    counted."""
    _needs_card()
    scene, config = _card_scene(tmp_path, name)
    x = _on_card(scene, config, _chain_rays(scene.to("cpu"), config, seed=5))
    args = (x["o"], x["d"], x["throughput"], x["radiance"], x["alive"], x["draws"], x["hit"],
            x["info"])
    n3, n4 = kernels.launches["k3"], kernels.launches["k4"]
    got = pt.shade_sample(scene, config, *args)
    want = pt.shade_sample_plain(scene, config, *args)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    pos, new_dir, _, flags = want
    assert int(flags[:, 1].sum()) > 0 and int(flags[:, 0].sum()) > 0
    p_light = pt.light_pdf(scene, pos, new_dir, config.eps)
    args = (x["o"], x["d"], x["throughput"], x["hit"], x["info"], pos, new_dir, flags, p_light)
    got = pt.shade_finish(scene, config, *args)
    want = pt.shade_finish_plain(scene, config, *args)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert (kernels.launches["k3"], kernels.launches["k4"]) == (n3 + 1, n4 + 1)


def _twin_chain(monkeypatch):
    """Make ``bounce_step`` run K3's and K4's twins on the card."""
    def sample(*a):
        return pt.shade_sample_plain(*a)

    def finish(*a):
        return pt.shade_finish_plain(*a)

    monkeypatch.setattr(pt, "shade_sample", sample)
    monkeypatch.setattr(pt, "shade_finish", finish)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["persistent", "scan_sobol", "bins"])
def test_torch_shade_chain_frames_on_card(tmp_path, monkeypatch, engine):
    """The atrium at 64x64 @ 2 spp with K3 and K4 equals, bit for bit, the
    frame of the twin chain and the eager loop's frame: under the
    persistent engine's graph, the scan engine with Sobol draws, and the
    intersector's "bins" mode (the eager loop on the card)."""
    from tpu_pathtracer_torch.config import IntersectTuning

    _needs_card()
    scene, config = _card_scene(tmp_path, "atrium")
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    if engine == "scan_sobol":
        config = dataclasses.replace(config, compaction=False, lowdisc="sobol")
    elif engine == "bins":
        config = dataclasses.replace(config, tuning=IntersectTuning(mode="bins"))
    pt.clear_compiled_loops()
    n3, n4 = kernels.launches["k3"], kernels.launches["k4"]
    frame = pt.render(scene, spp=2, seed=9, config=config)
    eager = pt.render(scene, spp=2, seed=9, config=config, eager=True)
    assert kernels.launches["k3"] > n3 and kernels.launches["k4"] > n4
    with monkeypatch.context() as m:
        _twin_chain(m)
        pt.clear_compiled_loops()
        twins = pt.render(scene, spp=2, seed=9, config=config)
    pt.clear_compiled_loops()
    assert np.isfinite(frame).all() and frame.mean() > 0
    assert np.array_equal(frame.view(np.uint32), eager.view(np.uint32))
    assert np.array_equal(frame.view(np.uint32), twins.view(np.uint32))


@pytest.mark.cuda
def test_torch_shade_chain_stage_map_on_card(tmp_path):
    """In the captured block of the persistent loop the ``shade`` class of
    the stage map (``shading`` outside its intersector, hit record and
    light pdf) is K3 and K4 once an iteration, plus at most three copies or
    fills an iteration."""
    from tpu_pathtracer_torch.utils import profiling

    _needs_card()
    scene, config = _card_scene(tmp_path, "atrium")
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(128, 128))
    pt.clear_compiled_loops()
    pt.render(scene, spp=1, seed=0, config=config)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pt.render(scene, spp=1, seed=1, config=config)
    smap = profiling.stage_maps()[-1]
    evs = list(prof.profiler.kineto_results.events())
    first = next(ev.correlation_id() for ev in evs if ev.name() == "cudaGraphLaunch")
    ops = sorted((ev for ev in evs if ev.correlation_id() == first
                  and str(ev.device_type()).endswith("CUDA")), key=lambda ev: ev.start_ns())
    assert len(ops) == smap.nodes
    names = []
    for path, lo, hi in smap.rows:
        parts = path.split("/")
        if "shading" in parts and not {"intersector", "hit_info", "light_pdf"} & set(parts):
            names += [ops[i].name() for i in range(lo, hi + 1)]
    pt.clear_compiled_loops()
    k = pt.LOOP_ITERATIONS
    assert sum("shade_sample_kernel" in n for n in names) == k
    assert sum("shade_finish_kernel" in n for n in names) == k
    assert len(names) <= 2 * k + 3 * k, names
