"""The port's whole render path on the CPU: renders vs the JAX package's on
the same scene arrays (default and non-default configurations), the Cornell
golden, the CLI contract, and the refusal of unknown configuration values."""

import dataclasses
import inspect
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.cli import main as jax_main
from tpu_pathtracer.cli import render_scene_file as jax_render_scene_file
from tpu_pathtracer.models.pathtracer import render as jax_render
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils.image import quantize_u8 as jax_quantize
from tpu_pathtracer.utils.testscenes import make_cornell_gltf, make_sphere_field_gltf
from tpu_pathtracer_torch import cli
from tpu_pathtracer_torch.bridge import scene_from_arrays
from tpu_pathtracer_torch.config import IntersectTuning, RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm
from tpu_pathtracer_torch.utils.profiling import PhaseTimer
from test_torch_scene import jax_config, jax_scene_arrays

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
    want = np.asarray(jax_quantize(jnp.asarray(jax_render(js, spp=spp, seed=seed, config=jax_config(config)))))
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


@pytest.mark.parametrize("width", [0, -4])
def test_torch_cli_rejects_illegal_image_size(width, tmp_path, capsys, monkeypatch):
    """A width of 0 or below: the CLI prints the message of the reference's
    ``Image`` constructor, "Illegal image size<W>x<H>" (src/image.h:25-29),
    and exits 1 with no image written; ``render_scene_file`` raises
    ``ValueError`` with that message."""
    monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    out = tmp_path / "o.ppm"
    assert cli.main(["prog", path, str(width), "8", "1", str(out)]) == 1
    assert capsys.readouterr().err == f"Illegal image size{width}x8\n"
    assert not out.exists()
    with pytest.raises(ValueError, match=f"^Illegal image size{width}x8$"):
        cli.render_scene_file(path, width, 8, 1, device=torch.device("cpu"))


_WHITTED_TXT = """DIMENSIONS 8 8
RAY_DEPTH 3
BG_COLOR 0.1 0.2 0.4
AMBIENT_LIGHT 0.1 0.1 0.1
NEW_LIGHT
LIGHT_POSITION 1 4 2
LIGHT_INTENSITY 6 6 6
CAMERA_POSITION 0 1 4
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.2
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.6 0.8 0.6
NEW_PRIMITIVE
ELLIPSOID 0.6 0.6 0.6
POSITION 0 0.6 0
COLOR 0.9 0.9 0.9
DIELECTRIC
"""
_MC_TXT = _WHITTED_TXT.replace("RAY_DEPTH 3", "RAY_DEPTH 3\nSAMPLES 4") + """NEW_PRIMITIVE
TRIANGLE -2 3 -2 2 3 -2 0 3 2
EMISSION 4 4 4
"""


def test_torch_cli_device_and_slice(tmp_path, capsys, monkeypatch):
    """The CLI refuses to fall back to the CPU silently; with the CPU opt-in
    it renders glTF and homebrew scenes (Whitted and Monte-Carlo) to a P6
    PPM and prints the phase seconds, then the metrics JSON."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    out = str(tmp_path / "out" / "img.ppm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("TPU_PATHTRACER_TORCH_DEVICE", raising=False)
    assert cli.main(["prog", path, "16", "12", "2", out]) == 1
    assert "TPU_PATHTRACER_TORCH_DEVICE=cpu" in capsys.readouterr().err
    monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
    for name, text in (("scene-000.txt", _WHITTED_TXT), ("practice5.txt", _MC_TXT)):
        txt = tmp_path / name
        txt.write_text(text)
        assert cli.main(["prog", str(txt), "32", "24", "1", out]) == 0
        lines = capsys.readouterr().err.strip().splitlines()
        assert list(json.loads(lines[-2])["phases_seconds"]) == ["load_render", "tonemap_write"]
        assert json.loads(lines[-1])["ray_depth"] == 3
        img = read_ppm(out)
        assert img.shape == (24, 32, 3) and img.mean() > 0
    assert cli.main(["prog", path, "16", "12", "2", out]) == 0
    lines = capsys.readouterr().err.strip().splitlines()
    phases = json.loads(lines[-2])["phases_seconds"]
    assert set(phases) == {"load_render", "tonemap_write", "dispatch", "device_wait_readback"}
    assert '"measured_rays"' in lines[-1]
    img = read_ppm(out)
    assert img.shape == (12, 16, 3) and img.mean() > 0


def test_torch_cli_homebrew_matches_jax(tmp_path, monkeypatch):
    """A homebrew Monte-Carlo scene through the port's CLI and the JAX
    package's ``render_scene_file`` (the sample count of the command line
    replaces SAMPLES): the same image to fp noise."""
    monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
    txt = tmp_path / "practice5.txt"
    txt.write_text(_MC_TXT)
    hdr, metrics = jax_render_scene_file(str(txt), 12, 10, 3, progress=False)
    assert metrics.samples == 3
    out = str(tmp_path / "port.ppm")
    assert cli.main(["prog", str(txt), "12", "10", "3", out]) == 0
    want = np.asarray(jax_quantize(jnp.asarray(hdr))).astype(int)
    _assert_fp_noise(want, read_ppm(out).astype(int))


def test_torch_render_scene_file_takes_jax_parameters(tmp_path):
    """``render_scene_file`` takes the JAX package's parameters in its order,
    then ``device``: a config passed fifth is the config, the seed sixth is
    the seed."""
    jax_params = list(inspect.signature(jax_render_scene_file).parameters)
    assert list(inspect.signature(cli.render_scene_file).parameters) == jax_params + ["device"]
    path = make_cornell_gltf(str(tmp_path / "c.gltf"))
    cpu = torch.device("cpu")
    config = RenderConfig(jitter="sobol")
    hdr, metrics = cli.render_scene_file(path, 8, 8, 2, config, 5, False, None, cpu)
    want = pt.render(_cornell_scene(path, 8, 8), spp=2, seed=5, config=config)
    np.testing.assert_array_equal(hdr, want)
    assert metrics.samples == 2


def _cornell_scene(path, w, h):
    scene = parse_gltf_scene(path, w / h)
    return dataclasses.replace(scene, camera=scene.camera.with_dims(w, h))


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


def test_torch_render_retry_ticks_each_tile_once(tmp_path, monkeypatch, capsys):
    """An execution that raises (any exception, here on the second of three
    passes) is recomputed: the frame and its measured rays equal an
    undisturbed render's, each tile's progress tick is printed once, and the
    timer saw every engine call and the one readback."""
    scene = _cornell_scene(make_cornell_gltf(str(tmp_path / "c.gltf")), 16, 16)
    config = RenderConfig(spp_per_pass=1)
    want_stats = {}
    want = pt.render(scene, spp=3, seed=4, config=config, stats=want_stats)
    real = pt.render_chunk_persistent
    calls = []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise Exception("simulated out-of-memory")
        return real(*args, **kw)

    monkeypatch.setattr(pt, "render_chunk_persistent", flaky)
    capsys.readouterr()
    timer, stats = PhaseTimer(), {}
    got = pt.render(scene, spp=3, seed=4, config=config, progress=True, timer=timer, stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats
    err = capsys.readouterr().err
    assert re.findall(r"(\d+)/3 +\r", err) == ["0", "1", "2"]
    assert "simulated out-of-memory" in err and "retrying (1/2)" in err
    assert len(calls) == 5  # one pass, the failed pass, the chunk's three again
    assert timer.counts == {"dispatch": 5, "device_wait_readback": 1}


def test_torch_render_without_light_rows_matches_jax(tmp_path):
    """A scene carried over through ``bridge.scene_from_arrays`` with a light
    set of zero rows: the mixture is the cosine lobe alone, as in the JAX
    package; the render is finite and matches the JAX render of the same
    arrays to fp noise."""
    path = make_cornell_gltf(str(tmp_path / "c" / "cornell.gltf"))
    w = h = 16
    js = jax_parse(path, 1.0)
    no_lights = dataclasses.replace(
        js.lights, verts=jnp.zeros((0, 3, 3), jnp.float32), normal=jnp.zeros((0, 3), jnp.float32),
        area=jnp.zeros((0,), jnp.float32), count=jnp.asarray(0, jnp.int32), cluster_min=None,
        cluster_max=None, cluster_woop=None, cluster_k=None,
    )
    js = dataclasses.replace(js, camera=js.camera.with_dims(w, h), lights=no_lights)
    arrays, statics = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, {**statics, "width": w, "height": h})
    assert ts.lights.capacity == 0 and not ts.lights.has_clusters
    hdr = pt.render(ts, spp=4, seed=2)
    assert np.isfinite(hdr).all() and hdr.mean() > 0
    want = np.asarray(jax_quantize(jnp.asarray(jax_render(js, spp=4, seed=2)))).astype(int)
    _assert_fp_noise(want, quantize_u8(torch.from_numpy(hdr)).numpy().astype(int))


def test_torch_chunk_padding_made_once(tmp_path, monkeypatch):
    """Chunk tensors of 29 chunks (not a multiple of the 8-chunk group):
    ``closest_hit_chunks`` NaN-pads them at the first call and hands the
    kernels the same padded tensors at the second."""
    path = make_sphere_field_gltf(str(tmp_path / "f" / "field.gltf"), n_spheres=3, subdiv=3)
    scene = parse_gltf_scene(path, 1.0)
    cw, cmin, cmax = scene.chunk_woop[:29], scene.chunk_aabb_min[:29], scene.chunk_aabb_max[:29]
    seen = []  # the tensors themselves, so no address is reused
    real_items, real_act = ci.run_items, ci.tile_chunk_activity
    monkeypatch.setattr(ci, "run_items", lambda *a: seen.append(("woop", a[3])) or real_items(*a))
    monkeypatch.setattr(ci, "tile_chunk_activity", lambda *a, **k: seen.extend(
        [("min", a[1]), ("max", a[2])]) or real_act(*a, **k))
    rs = np.random.default_rng(0)
    o = torch.from_numpy(rs.uniform(-1, 1, (ci.RAY_TILE, 3)).astype(np.float32)) + scene.camera.position
    d = torch.nn.functional.normalize(torch.from_numpy(rs.normal(size=(ci.RAY_TILE, 3)).astype(np.float32)), dim=1)
    ptrs = []
    for _ in range(2):
        seen.clear()
        hit = ci.closest_hit_chunks(o, d, cw, cmin, cmax, scene.woop_rows, 1e-4)
        ptrs.append({(k, t.data_ptr()) for k, t in seen})
        kept = list(seen)
    assert hit.hit.any() and {k for k, _ in ptrs[0]} == {"woop", "min", "max"}
    assert ptrs[0] == ptrs[1]
    assert all(t.shape[0] == 32 for k, t in kept if k == "woop")
