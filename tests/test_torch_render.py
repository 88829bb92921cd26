"""The port's whole render path on the CPU: renders vs the JAX package's on
the same scene arrays (default and non-default configurations), the Cornell
golden, the CLI contract, and the refusal of unknown configuration values."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.cli import main as jax_main
from tpu_pathtracer.config import IntersectTuning, RenderConfig
from tpu_pathtracer.models.pathtracer import render as jax_render
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils.image import quantize_u8 as jax_quantize
from tpu_pathtracer.utils.testscenes import make_cornell_gltf, make_sphere_field_gltf
from tpu_pathtracer_torch import cli
from tpu_pathtracer_torch.bridge import scene_from_arrays
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_64x64_4096spp.ppm")


def _render_both(path, w, h, spp, seed=3, config=RenderConfig()):
    """Render one file with both packages under ``config``; the port's scene
    comes from the JAX scene's arrays through the bridge.  Returns the two
    u8 images."""
    js = jax_parse(path, w / h)
    js = dataclasses.replace(js, camera=js.camera.with_dims(w, h))
    arrays, statics = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, {**statics, "width": w, "height": h})
    want = np.asarray(jax_quantize(jnp.asarray(jax_render(js, spp=spp, seed=seed, config=config))))
    stats = {}
    hdr = pt.render(ts, spp=spp, seed=seed, config=config, stats=stats)
    assert np.isfinite(hdr).all()
    if config.compaction:  # only the persistent engine counts rays, as in JAX
        assert stats["measured_rays"] > w * h * spp
    else:
        assert not stats
    got = quantize_u8(torch.from_numpy(hdr)).numpy()
    return want.astype(int), got.astype(int)


def _assert_fp_noise(want, got):
    """Equal to fp noise.  Both renders take the same (pixel, sample, depth)
    draws; the Russian-roulette, alpha and strategy coins compare a draw
    against a float computed in another rounding order, so an ulp can flip
    one coin and change one path of one pixel (expected and isolated).
    Hence: at most 0.5% of u8 channels differ by more than 1, and the image
    means agree to 0.1."""
    diff = np.abs(want - got)
    assert (diff > 1).mean() <= 0.005, (diff > 1).mean()
    assert abs(want.mean() - got.mean()) < 0.1


def test_torch_render_matches_jax_cornell(tmp_path):
    """Cornell (36 triangles): the dense-sweep path."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    _assert_fp_noise(*_render_both(path, 32, 32, 4))


def test_torch_render_matches_jax_large_scene(tmp_path, monkeypatch):
    """8 icospheres (10,244 triangles, 88 chunks) at 48x48 = 2,560 lanes: the
    wavefront sort and the cascade's twins run (the JAX side takes its
    leaf traversal on the CPU, an independent closest-hit)."""
    calls = []
    real = ci.run_items
    monkeypatch.setattr(ci, "run_items", lambda *a: calls.append(1) or real(*a))
    path = make_sphere_field_gltf(str(tmp_path / "f" / "field.gltf"), n_spheres=8, subdiv=3,
                                  textured=True)
    want, got = _render_both(path, 48, 48, 2)
    _assert_fp_noise(want, got)
    assert len(calls) > 10


def test_torch_cornell_golden(tmp_path):
    """Cornell 64x64 @ 64 spp through the port vs the reference's 4096-spp
    golden, with the thresholds of tests/test_pathtracer.py: the RMSE bound
    is the MC noise floor at 64 spp, the mean bound catches bias."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    ours = quantize_u8(torch.from_numpy(pt.render(scene, spp=64, seed=0))).numpy().astype(float)
    ref = read_ppm(GOLDEN).astype(float)
    assert float(np.sqrt(((ours - ref) ** 2).mean())) < 14.0
    assert abs(ours.mean() - ref.mean()) < 3.0


def test_torch_cli_errors_match_jax(tmp_path, capsys, monkeypatch):
    """Too few arguments and missing scene files: same message, exit 1."""
    monkeypatch.setenv("TPU_PATHTRACER_NO_CACHE", "1")
    monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
    out = str(tmp_path / "o.ppm")
    for argv in (
        ["prog", "scene.gltf", "8", "8"],
        ["prog", str(tmp_path / "missing.gltf"), "8", "8", "1", out],
        ["prog", str(tmp_path / "missing.txt"), "8", "8", "1", out],
    ):
        assert jax_main(list(argv)) == 1
        want = capsys.readouterr().err
        assert cli.main(list(argv)) == 1
        assert capsys.readouterr().err == want


def test_torch_cli_device_and_slice(tmp_path, capsys, monkeypatch):
    """The CLI refuses to fall back to the CPU silently, refuses homebrew
    scenes, and renders a P6 PPM plus the metrics JSON with the CPU opt-in."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    out = str(tmp_path / "out" / "img.ppm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TPU_PATHTRACER_TORCH_DEVICE", raising=False)
    assert cli.main(["prog", path, "16", "12", "2", out]) == 1
    assert "TPU_PATHTRACER_TORCH_DEVICE=cpu" in capsys.readouterr().err
    monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
    txt = tmp_path / "scene-000.txt"
    txt.write_text("DIMENSIONS 8 8\n")
    assert cli.main(["prog", str(txt), "8", "8", "1", out]) == 1
    assert "ROADMAP" in capsys.readouterr().err
    assert cli.main(["prog", path, "16", "12", "2", out]) == 0
    assert '"measured_rays"' in capsys.readouterr().err.strip().splitlines()[-1]
    img = read_ppm(out)
    assert img.shape == (12, 16, 3) and img.mean() > 0


@pytest.mark.parametrize(
    "change",
    [
        {"compaction": False},
        {"jitter": "sobol"},
        {"lowdisc": "sobol"},
        {"tuning": IntersectTuning(mode="twopass")},
        {"tuning": IntersectTuning(mode="dense")},
        {"tuning": IntersectTuning(cheap_recheck=1)},
    ],
    ids=["scan_engine", "sobol_jitter", "lowdisc", "mode_twopass", "mode_dense", "cheap_recheck"],
)
def test_torch_render_rejects_unported_config(tmp_path, change):
    """Each non-default engine, sampler and intersector setting renders
    Cornell finite and matches the JAX render of the same configuration to
    fp noise (Cornell takes the dense sweep, so the intersector settings
    must leave it untouched)."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    _assert_fp_noise(*_render_both(path, 8, 8, 4, config=dataclasses.replace(RenderConfig(), **change)))


def test_torch_render_rejects_unknown_config(tmp_path):
    """Unknown intersect mode, cheap_recheck, jitter and lowdisc values
    raise ValueError before any work."""
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(8, 8))
    for change, match in (
        ({"tuning": IntersectTuning(mode="item")}, "unknown intersect mode"),
        ({"tuning": IntersectTuning(cheap_recheck=3)}, "unknown cheap_recheck"),
        ({"jitter": "sobl"}, "unknown jitter"),
        ({"lowdisc": "bogus"}, "unknown lowdisc"),
    ):
        with pytest.raises(ValueError, match=match):
            pt.render(scene, spp=1, config=dataclasses.replace(RenderConfig(), **change))


def test_torch_render_retries_failed_chunk(tmp_path, monkeypatch):
    """A chunk whose device execution fails is recomputed; the counter RNG
    makes the recovered frame equal to an undisturbed one."""
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(16, 16))
    want = pt.render(scene, spp=3, seed=4)
    real = pt.render_chunk_persistent
    failures = []

    def flaky(*args, **kw):
        if not failures:
            failures.append(1)
            raise RuntimeError("simulated device failure")
        return real(*args, **kw)

    monkeypatch.setattr(pt, "render_chunk_persistent", flaky)
    np.testing.assert_array_equal(pt.render(scene, spp=3, seed=4), want)
    assert failures == [1]
