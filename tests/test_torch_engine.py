"""Engine and sampler parity: the Owen-scrambled Sobol draws bit for bit
against the JAX package, and the scan engine (``compaction=False``) against
the JAX scan engine and the port's own persistent engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.models import pathtracer as jpt
from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer.utils.testscenes import make_cornell_gltf, make_sphere_field_gltf
from tpu_pathtracer_torch import cli
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from test_torch_render import _assert_fp_noise, _render_both
from test_torch_scene import jax_config

torch.set_num_threads(1)

SEEDS = [0, 7, 2**31 + 5]


def _lanes(seed, n=300):
    """Per-lane pixel, sample and depth vectors as the persistent engine
    passes them."""
    rs = np.random.default_rng(seed % 1000)
    return (rs.integers(0, 2**31 - 1, size=n).astype(np.int32),
            rs.integers(0, 70_000, size=n).astype(np.int32),
            rs.integers(0, 9, size=n).astype(np.int32))


def _bits_equal(got: torch.Tensor, want) -> None:
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_sobol_owen_2d_bit_equal(seed):
    pix, sample, _ = _lanes(seed)
    key = jax.random.key(seed)
    for s in (0, 5, sample):
        _bits_equal(trng.sobol_owen_2d(seed, torch.as_tensor(s), torch.from_numpy(pix)),
                    jrng.sobol_owen_2d(key, jnp.asarray(s), jnp.asarray(pix)))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_sobol_owen_pair_bit_equal(seed):
    """Both domain tags, scalar and per-lane (sample, depth)."""
    pix, sample, depth = _lanes(seed)
    key = jax.random.key(seed)
    for tag in (trng.SOBOL_TAG_VNDF, trng.SOBOL_TAG_LIGHT):
        for s, b in ((3, 0), (3, 7), (sample, depth)):
            _bits_equal(
                trng.sobol_owen_pair(seed, torch.as_tensor(s), torch.as_tensor(b),
                                     torch.from_numpy(pix), tag),
                jrng.sobol_owen_pair(key, jnp.asarray(s), jnp.asarray(b), jnp.asarray(pix), tag),
            )
    assert (trng.SOBOL_TAG_VNDF, trng.SOBOL_TAG_LIGHT) == (jrng.SOBOL_TAG_VNDF,
                                                          jrng.SOBOL_TAG_LIGHT)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_bounce_draws_lowdisc_bit_equal(seed):
    """bounce_draws under lowdisc "off" and "sobol" equal the JAX draws;
    an unknown lowdisc raises ValueError."""
    pix, sample, depth = _lanes(seed)
    key = jax.random.key(seed)
    for lowdisc in ("off", "sobol"):
        config = RenderConfig(lowdisc=lowdisc)
        for s, b in ((2, 1), (sample, depth)):
            _bits_equal(
                pt.bounce_draws(seed, torch.as_tensor(s), torch.as_tensor(b),
                                torch.from_numpy(pix), config),
                jpt.bounce_draws(key, jnp.asarray(s), jnp.asarray(b), jnp.asarray(pix), jax_config(config)),
            )
    with pytest.raises(ValueError, match="unknown lowdisc"):
        pt.bounce_draws(seed, 0, 0, torch.from_numpy(pix), RenderConfig(lowdisc="bogus"))


def test_torch_scan_engine_matches_jax(tmp_path):
    """Cornell through the scan engine with Sobol jitter and bounce draws,
    against the JAX scan engine, to fp noise."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    config = RenderConfig(compaction=False, jitter="sobol", lowdisc="sobol")
    _assert_fp_noise(*_render_both(path, 24, 24, 3, config=config))


def test_torch_scan_engine_large_scene_matches_jax(tmp_path, monkeypatch):
    """8 icospheres (10,244 triangles) at 48x48 = 2,560 lanes: the scan
    engine sorts the wavefront every bounce, runs the cascade and undoes
    the permutation; against the JAX scan engine, to fp noise."""
    calls = []
    real = pt.bounce_step
    monkeypatch.setattr(pt, "bounce_step", lambda *a: calls.append(1) or real(*a))
    path = make_sphere_field_gltf(str(tmp_path / "f" / "field.gltf"), n_spheres=8, subdiv=3,
                                  textured=True)
    _assert_fp_noise(*_render_both(path, 48, 48, 1, config=RenderConfig(compaction=False)))
    assert 1 < len(calls) <= 8  # early exit once every ray is dead


def _cornell(tmp_path, w, h):
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(path, w / h)
    return dataclasses.replace(scene, camera=scene.camera.with_dims(w, h))


def test_torch_persistent_engine_matches_scan(tmp_path):
    """The two engines take the same draws per (pixel, sample, depth): equal
    up to the per-pixel summation order."""
    scene = _cornell(tmp_path, 24, 24)
    a = pt.render(scene, spp=5, seed=3, config=RenderConfig(compaction=False))
    b = pt.render(scene, spp=5, seed=3, config=RenderConfig(compaction=True))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_torch_lowdisc_sobol_engines_agree(tmp_path):
    scene = _cornell(tmp_path, 16, 16)
    son = RenderConfig(lowdisc="sobol")
    a = pt.render(scene, spp=3, seed=2, config=dataclasses.replace(son, compaction=False))
    b = pt.render(scene, spp=3, seed=2, config=dataclasses.replace(son, compaction=True))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_torch_cli_sobol_env(tmp_path, monkeypatch):
    """TPU_PATHTRACER_JITTER / TPU_PATHTRACER_LOWDISC reach the render as
    the JAX CLI passes them."""
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    monkeypatch.setenv("TPU_PATHTRACER_JITTER", "sobol")
    monkeypatch.setenv("TPU_PATHTRACER_LOWDISC", "sobol")
    hdr, _ = cli.render_scene_file(path, 8, 8, 2, device=torch.device("cpu"))
    want = pt.render(_cornell(tmp_path, 8, 8), spp=2, seed=0,
                     config=RenderConfig(jitter="sobol", lowdisc="sobol"))
    np.testing.assert_array_equal(hdr, want)
