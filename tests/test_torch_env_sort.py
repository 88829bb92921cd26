"""Environment maps, the camera light triangle and the wavefront sort keys
of the port against the JAX package: the first-entered-box search (kernel
B4's twin) against the Pallas kernel in interpret mode, every sort key,
``env_radiance``, the loader and whole renders under both lighting options,
and the sort keys' freedom from any effect on the image."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.models import pathtracer as jpt
from tpu_pathtracer.ops import pallas_intersect as jpi
from tpu_pathtracer.ops import texture as jtex
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils.image import quantize_u8 as jax_quantize
from tpu_pathtracer.utils.testscenes import (
    make_cornell_gltf,
    make_env_hdr,
    make_env_image,
    make_sphere_field_gltf,
)
from tpu_pathtracer_torch.bridge import scene_from_arrays
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.ops import texture
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm
from test_torch_chunk_intersect import _scene
from test_torch_render import _assert_fp_noise
from test_torch_scene import jax_config, jax_scene_arrays

torch.set_num_threads(1)

EPS = 1e-4
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _boxes_and_rays(seed):
    """700 boxes (two 512-column blocks once padded) with NaN rows, exact
    duplicates and heavy overlap, and 256 rays: some start inside several
    boxes (entry = min_dst for each, so ties), some on a box face with a
    zero direction component."""
    rng = np.random.default_rng(seed)
    g = 700
    lo = rng.uniform(-6, 5, (g, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 2.5, (g, 3)).astype(np.float32)
    lo[600:] = lo[:100]  # duplicates in the second column block
    hi[600:] = hi[:100]
    lo[[5, 77, 512, 699]] = np.nan
    hi[[5, 77, 512, 699]] = np.nan
    o = rng.uniform(-7, 7, (256, 3)).astype(np.float32)
    d = _unit(rng, 256)
    o[:32] = (lo[10:42] + hi[10:42]) / 2  # inside
    for i in range(32, 48):
        b, a = 100 + i, i % 3
        o[i] = (lo[b] + hi[b]) / 2
        o[i, a] = lo[b, a]
        d[i, a] = 0.0
        d[i] /= np.linalg.norm(d[i])
    return lo, hi, o, d


@pytest.mark.parametrize("case", ["overlapping_boxes", "padding_groups"])
def test_torch_nearest_box_ids_matches_jax_interpret(case):
    """The B4 twin against the Pallas kernel in interpret mode: ids exactly
    equal (first minimum on ties), and no NaN box (a padding group) ever
    returned (tests/test_pallas_intersect.py:600-656)."""
    if case == "padding_groups":
        # 1,100 triangles in a 2,048 capacity: chunks 9-15 are padding, so
        # groups of two chunks 5-7 are NaN boxes.
        _, _, _, _, cmin, cmax, _ = _scene(1100, seed=7)
        lo, hi = (x.numpy() for x in ci.group_boxes(_t(cmin), _t(cmax), 2))
        rng = np.random.default_rng(8)
        o = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
        d = _unit(rng, 256)
    else:
        lo, hi, o, d = _boxes_and_rays(seed=3)
    want = np.asarray(jpi.nearest_box_ids(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                          jnp.asarray(hi), EPS, ray_tile=128, interpret=True))
    got = ci.nearest_box_ids(_t(o), _t(d), _t(lo), _t(hi), EPS, ray_tile=128).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got >= 0).sum() > 20 and (got == -1).any()
    pad = np.nonzero(np.isnan(lo[:, 0]))[0]
    assert len(pad) >= 3 and not np.isin(got, pad).any() and got.max() < len(lo)


@pytest.mark.parametrize("key", ["target", "dirhint", "cell", "hint", "none"])
def test_torch_sort_keys_match_jax(tmp_path, key):
    """Each sort key's function, built from the same scene by both packages,
    gives exactly equal int32 keys on the same wavefront (300 lanes, so
    "target" pads to the ray tile), dead lanes included."""
    path = make_sphere_field_gltf(str(tmp_path / "f" / "f.gltf"), n_spheres=3, subdiv=3)
    js = jax_parse(path, 1.0)
    arrays, statics = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, {**statics, "width": 8, "height": 8})
    rng = np.random.default_rng(11)
    r = 300
    o = rng.uniform(-12, 12, (r, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0, 10, r)
    d = _unit(rng, r)
    d[:20, 1] = 0.0
    alive = rng.random(r) < 0.8
    o[~alive] = 1e30
    hint = rng.integers(-1, ts.chunk_woop.shape[0], r).astype(np.int32)
    config = RenderConfig(sort_key=key)
    want = np.asarray(jpt._make_sort_key(js, jax_config(config), r)(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive), jnp.asarray(hint)))
    got = pt._make_sort_key(ts, config, r)(_t(o), _t(d), _t(alive), _t(hint)).numpy()
    assert got.dtype == np.int32 and got.shape == (r,)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[alive])) > (0 if key == "none" else 10)


def test_torch_dirhint_and_cell_keys_match_jax_directly():
    """The two direction- and origin-binned keys on hand-made edge cases:
    axis-aligned and diagonal directions (argmax ties), origins outside the
    scene bounds, and chunk hints past the chunk count."""
    rng = np.random.default_rng(2)
    d = np.concatenate([np.eye(3), -np.eye(3), np.full((1, 3), 3**-0.5), _unit(rng, 121)])
    d = d.astype(np.float32)
    r = d.shape[0]
    o = rng.uniform(-20, 20, (r, 3)).astype(np.float32)
    alive = rng.random(r) < 0.9
    hint = rng.integers(-3, 60, r).astype(np.int32)
    lo = np.array([-5, 0, -4], np.float32)
    hi = np.array([5, 9, 4], np.float32)
    want = jpi.ray_sort_key_dirhint(jnp.asarray(d), jnp.asarray(alive), jnp.asarray(hint), 50)
    got = ci.ray_sort_key_dirhint(_t(d), _t(alive), _t(hint), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jpi.ray_sort_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
                            jnp.asarray(lo), jnp.asarray(hi))
    got = ci.ray_sort_key(_t(o), _t(d), _t(alive), _t(lo), _t(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", ["png", "hdr"])
def test_torch_env_radiance_matches_jax(tmp_path, fmt):
    """The equirect lookup on the loaded atlas (flat and quad pools agree
    already) for random directions, the poles and the +-x seam: abs <= 1e-5,
    since atan2 and asin round differently in the two libraries."""
    env = (make_env_image if fmt == "png" else make_env_hdr)(str(tmp_path / f"env.{fmt}"))
    config = RenderConfig(use_env_map=True, env_map_path=env, env_map_intensity=1.7)
    path = make_cornell_gltf(str(tmp_path / "c" / "c.gltf"))
    js = jax_parse(path, 1.0, jax_config(config))
    ts = parse_gltf_scene(path, 1.0, config)
    assert ts.has_env and ts.env_tex == int(js.env_tex)
    rng = np.random.default_rng(4)
    d = np.concatenate([_unit(rng, 500), [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, -1e-7]]])
    d = d.astype(np.float32)
    want = np.asarray(jtex.env_radiance(js.atlas, js.env_tex, js.bg_color, jnp.asarray(d)))
    got = texture.env_radiance(ts.atlas, ts.env_tex, ts.bg_color, _t(d)).numpy()
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _render_both(path, config, w, h, spp, seed=3):
    """Render one file under ``config`` with both packages (the port's
    scene through the bridge from the JAX scene's arrays) -> two u8
    images as int."""
    js = jax_parse(path, w / h, jax_config(config))
    js = dataclasses.replace(js, camera=js.camera.with_dims(w, h))
    arrays, statics = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, {**statics, "width": w, "height": h})
    jax_hdr = jpt.render(js, spp=spp, seed=seed, config=jax_config(config))
    want = np.asarray(jax_quantize(jnp.asarray(jax_hdr)))
    hdr = pt.render(ts, spp=spp, seed=seed, config=config)
    assert np.isfinite(hdr).all()
    return want.astype(int), quantize_u8(torch.from_numpy(hdr)).numpy().astype(int)


@pytest.mark.parametrize("options", ["env_png_light_triangle", "env_hdr"])
def test_torch_render_env_and_light_triangle_match_jax(tmp_path, options):
    """Cornell with an environment map (PNG with the light triangle, or
    Radiance HDR) rendered by both packages: equal to fp noise."""
    if options == "env_hdr":
        config = RenderConfig(use_env_map=True,
                              env_map_path=make_env_hdr(str(tmp_path / "env.hdr")))
    else:
        config = RenderConfig(use_env_map=True, add_light_triangle=True,
                              env_map_path=make_env_image(str(tmp_path / "env.png")))
    path = make_cornell_gltf(str(tmp_path / "c" / "c.gltf"))
    want, got = _render_both(path, config, 32, 32, 4)
    _assert_fp_noise(want, got)


def test_torch_sort_keys_observationally_free(tmp_path, monkeypatch):
    """Every sort key renders the bit-identical image at 1 spp: the counter
    RNG makes ray order irrelevant to each path (tests/test_pathtracer.py
    :293-314).  Engages the real sort: capacity > 1,024 triangles and a
    2,048-lane wavefront; "target" runs B4's twin."""
    calls = []
    real = ci.nearest_box_ids
    monkeypatch.setattr(ci, "nearest_box_ids", lambda *a: calls.append(1) or real(*a))
    path = make_sphere_field_gltf(str(tmp_path / "f.gltf"), n_spheres=4, subdiv=2)
    scene = parse_gltf_scene(path, 2.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 32), ray_depth=3)
    assert scene.capacity > 1024
    imgs = [pt.render(scene, spp=1, seed=5, config=RenderConfig(sort_key=k))
            for k in ("hint", "cell", "dirhint", "target")]
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.01
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])
    assert len(calls) >= 3


def test_torch_unknown_sort_key_rejected(tmp_path):
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(8, 8))
    with pytest.raises(ValueError, match="unknown sort_key 'taget'"):
        pt.render(scene, spp=1, seed=0, config=RenderConfig(sort_key="taget"))


@pytest.mark.parametrize("golden", ["cornell_env", "cornell_envhdr", "cornell_lt"])
def test_torch_env_and_light_triangle_goldens(tmp_path, golden):
    """Cornell 64x64 @ 64 spp with the environment map (PNG or HDR) or the
    light triangle, against the reference's 4096-spp goldens with the
    thresholds of tests/test_pathtracer.py:120-178."""
    if golden == "cornell_lt":
        config = RenderConfig(add_light_triangle=True)
    else:
        make = make_env_image if golden == "cornell_env" else make_env_hdr
        env = make(str(tmp_path / ("env.png" if golden == "cornell_env" else "env.hdr")))
        config = RenderConfig(use_env_map=True, env_map_path=env)
    path = make_cornell_gltf(str(tmp_path / "c" / "scene.gltf"))
    scene = parse_gltf_scene(path, 1.0, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    img = pt.render(scene, spp=64, seed=0, config=config)
    ours = quantize_u8(torch.from_numpy(img)).numpy().astype(np.float64)
    ref = read_ppm(os.path.join(GOLDEN_DIR, f"{golden}_64x64_4096spp.ppm")).astype(np.float64)
    assert float(np.sqrt(((ours - ref) ** 2).mean())) < 14.0
    assert abs(ours.mean() - ref.mean()) < 3.0
