"""The port's embedding API (``Renderer``, the package exports) and its
profiling hooks (``PhaseTimer``, ``device_trace``), on the CPU: the
counterpart of ``tests/test_renderer_api.py``."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_pathtracer.renderer import Renderer as JaxRenderer
from tpu_pathtracer_torch import kernels
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.renderer import Renderer
from tpu_pathtracer_torch.scene import fixtures
from tpu_pathtracer_torch.scene import types as T
from tpu_pathtracer_torch.utils.image import read_ppm
from tpu_pathtracer_torch.utils.profiling import PhaseTimer, device_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

_HOMEBREW = """DIMENSIONS 640 480
BG_COLOR 0 0 0.5
CAMERA_POSITION 0 2 6
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.2
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0 1 0
NEW_PRIMITIVE
ELLIPSOID 0.8 0.8 0.8
POSITION -1.5 2 0
COLOR 1 0 0
"""


@pytest.fixture
def cornell(tmp_path):
    return fixtures.make_cornell_gltf(str(tmp_path / "c" / "c.gltf"))


def test_torch_renderer_round_trip(tmp_path, cornell):
    r = Renderer(cornell, device=CPU)
    hdr = r.render(24, 24, spp=2, seed=0)
    assert hdr.shape == (24, 24, 3) and np.isfinite(hdr).all()
    out = str(tmp_path / "f.ppm")
    r.write(out, hdr)
    assert read_ppm(out).shape == (24, 24, 3)
    r.write(out, r.render_ldr(24, 24, spp=2, seed=0))
    np.testing.assert_array_equal(read_ppm(out), r.render_ldr(24, 24, spp=2, seed=0))


def test_torch_renderer_matches_plain_render(cornell):
    """A frame of the Renderer is ``models.pathtracer.render`` of the same
    scene, sample for sample."""
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    scene = parse_gltf_scene(cornell, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(16, 12))
    np.testing.assert_array_equal(Renderer(cornell, device=CPU).render(16, 12, spp=2, seed=3),
                                  pt.render(scene, spp=2, seed=3))


def test_torch_renderer_look_at_matches_jax(cornell):
    """``look_at`` builds the JAX Renderer's camera, and the view moves."""
    r, j = Renderer(cornell, device=CPU), JaxRenderer(cornell)
    a = r.render_ldr(16, 16, spp=2)
    for view in (dict(eye=(0, 1.0, 0.5), target=(0, 1.0, -1.0), fov_x=1.2),
                 dict(eye=(0.3, 1.2, 3.0), target=(0, 1.0, 0.0), up=(0.1, 1, 0))):
        r.look_at(**view)
        j.look_at(**view)
        for key in ("position", "right", "up", "forward", "fov_x"):
            np.testing.assert_array_equal(getattr(r.camera, key).numpy(),
                                          np.asarray(getattr(j.camera, key)), err_msg=key)
    b = r.render_ldr(16, 16, spp=2)
    assert np.abs(a.astype(int) - b.astype(int)).max() > 0


def test_torch_renderer_homebrew(tmp_path):
    """A homebrew scene renders through the same object; a Monte-Carlo
    scene takes the frame's spp as its sample count."""
    path = tmp_path / "scene-000.txt"
    path.write_text(_HOMEBREW)
    r = Renderer(str(path), device=CPU)
    assert isinstance(r.scene, T.PrimitiveScene)
    img = r.render_ldr(32, 24, spp=1)
    assert img.shape == (24, 32, 3)
    np.testing.assert_array_equal(img[0, 0], [0, 0, 205])
    mc = tmp_path / "mc.txt"
    mc.write_text(_HOMEBREW.replace("BG_COLOR", "SAMPLES 64\nRAY_DEPTH 2\nBG_COLOR"))
    r = Renderer(str(mc), device=CPU)
    a = r.render(8, 6, spp=2)
    scene = dataclasses.replace(r.scene, camera=r.scene.camera.with_dims(8, 6), samples=2)
    from tpu_pathtracer_torch.models.legacy import render_homebrew

    np.testing.assert_array_equal(a, render_homebrew(scene))


def test_torch_renderer_camera_move_keeps_scene(cornell, monkeypatch):
    """The scene's tensors move to the device once, in ``__init__``: camera
    moves between frames upload nothing (no tensor of the scene is copied,
    no ``.to`` runs) and build no kernel library."""
    r = Renderer(cornell, device=CPU)
    ptrs = {f.name: getattr(r.scene, f.name).data_ptr() for f in dataclasses.fields(r.scene)
            if isinstance(getattr(r.scene, f.name), torch.Tensor)}
    moved, builds = [], []
    real_to = T._to
    monkeypatch.setattr(T, "_to", lambda obj, dev: moved.append(type(obj).__name__) or real_to(obj, dev))
    monkeypatch.setattr(kernels, "build", lambda *a, **k: builds.append(1))
    r.look_at(eye=(0, 1.0, 3.8), target=(0, 1.0, 0.0))
    a = r.render(16, 16, spp=1, seed=0)
    for eye in [(0.2, 1.1, 3.5), (-0.3, 0.9, 3.9)]:
        r.look_at(eye=eye, target=(0, 1.0, 0.0), fov_x=1.1)
        b = r.render(16, 16, spp=1, seed=0)
        assert np.isfinite(b).all() and np.abs(a - b).max() > 0
    assert set(moved) <= {"Camera"}, moved
    assert not builds
    for name, ptr in ptrs.items():
        assert getattr(r.scene, name).data_ptr() == ptr, name


def test_torch_package_exports():
    """``tpu_pathtracer_torch`` exports what the JAX package does, lazily: a
    fresh interpreter imports the package without loading the renderer."""
    import tpu_pathtracer
    import tpu_pathtracer_torch as tp
    from tpu_pathtracer_torch import cli, config

    assert tp.__all__ == tpu_pathtracer.__all__
    assert tp.RenderConfig is config.RenderConfig and tp.DEFAULT_CONFIG is config.DEFAULT_CONFIG
    assert tp.Renderer is Renderer and tp.render_scene_file is cli.render_scene_file
    with pytest.raises(AttributeError):
        tp.no_such_name
    code = ("import sys, tpu_pathtracer_torch as tp\n"
            "assert 'tpu_pathtracer_torch.renderer' not in sys.modules\n"
            "assert 'tpu_pathtracer_torch.models.pathtracer' not in sys.modules\n"
            "tp.Renderer\n"
            "assert 'tpu_pathtracer_torch.renderer' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_torch_phase_timer_and_trace(tmp_path, capsys):
    """``PhaseTimer`` sums and counts phases and reports them as JSON;
    ``device_trace`` writes a Chrome trace with the annotated region, and
    does nothing without a directory."""
    timer = PhaseTimer()
    trace_dir = str(tmp_path / "trace")
    with device_trace(trace_dir):
        for _ in range(2):
            with timer.phase("work"), timer.annotate("tpt_region"):
                torch.ones(64).cumsum(0)
    with device_trace(None), timer.phase("io"):
        pass
    assert timer.counts == {"work": 2, "io": 1}
    out = timer.report()
    assert json.loads(capsys.readouterr().err) == {"phases_seconds": out}
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "tpt_region" for e in events) == 2
