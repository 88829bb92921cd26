"""The port's benchmark, ``tpu_pathtracer_torch/bench.py``: its workload
against the repository's ``bench.py`` (the JAX package's), its JSON line,
its refusal to run without a card unless the CPU is asked for, and its gate
on repeats.  The CPU cases render the Cornell box in place of the bench's
scenes (an atrium render takes ~20 s on one CPU core even at 32x32); the
card case (marker ``cuda``) runs the real atrium and field."""

import importlib.util
import json
import os
import statistics

import numpy as np
import pytest
import torch

import tpu_pathtracer.cli
import tpu_pathtracer.models.pathtracer
import tpu_pathtracer.utils.backend
import tpu_pathtracer.utils.testscenes
from tpu_pathtracer_torch import bench
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.scene import fixtures

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("BENCH_SCENE", "BENCH_SIZE", "BENCH_SPP", "BENCH_REPS", "BENCH_SORT", "BENCH_RPB",
       "BENCH_FRAME_POOL", "BENCH_NO_FIELD", "TPU_PATHTRACER_TORCH_DEVICE",
       "TPU_PATHTRACER_PLATFORM")
# bench.py's keys (less ``field_open_scene_vs_r02``, a TPU rate) and the card's.
KEYS = {"metric", "value", "unit", "vs_baseline", "pixel_samples_per_s",
        "mrays_depth8_upper_bound", "measured_rays", "timing", "rep_times_s",
        "field_open_scene_samples_per_s", "card", "reps", "render_s_median", "render_s_spread",
        "iterations", "loop", "device_busy_ms_per_iteration", "device_busy_share",
        "peak_allocated_bytes", "reserved_bytes"}


@pytest.fixture
def env(monkeypatch):
    """A clean bench environment: ``env(**vars)`` sets the variables."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)

    def set_env(**values):
        for name, value in values.items():
            monkeypatch.setenv(name, str(value))
    return set_env


def _cornell_for_bench_scenes(monkeypatch):
    """The bench's scene makers make the Cornell box (36 triangles)."""
    def cornell(path, **_):
        return fixtures.make_cornell_gltf(path)
    monkeypatch.setattr(fixtures, "make_atrium_gltf", cornell)
    monkeypatch.setattr(fixtures, "make_sphere_field_gltf", cornell)


def _run(capsys):
    """(exit code, stdout lines, stderr) of ``bench.main()``."""
    code = bench.main()
    out, err = capsys.readouterr()
    return code, out.strip().splitlines(), err


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("values", [
    {},
    {"BENCH_SORT": "none"},
    {"BENCH_SCENE": "field", "BENCH_RPB": 32768},
    {"BENCH_SIZE": 1000, "BENCH_FRAME_POOL": 1},
    {"BENCH_SIZE": 2000, "BENCH_SPP": 1000, "BENCH_FRAME_POOL": 1},
], ids=["default", "sort_none", "field_rpb", "size1000_pool", "int32_cap"])
def test_torch_bench_workload_equals_root_bench(values, env, monkeypatch, capsys):
    """The workload constants, and the shape, spp and ``RenderConfig`` (with
    its ``spp_per_pass``) that ``bench.py`` hands its warm-up render under
    each setting of the knobs, equal the port's for a card.  ``bench.py``
    runs with its render replaced by a recorder, on the Cornell box (both
    benches resolve ``spp_per_pass`` from the scene's ray depth)."""
    root = _root_bench()
    for name in ("WIDTH", "HEIGHT", "SPP", "BASELINE_SAMPLES_PER_S", "BASELINE_MRAYS"):
        assert getattr(bench, name) == getattr(root, name), name
    env(**values)
    calls = []

    def record(scene, spp, seed=0, config=None, **_):
        calls.append((scene, spp, seed, config))
        raise RuntimeError("recorded")

    monkeypatch.setattr(tpu_pathtracer.cli, "setup_backend", lambda: None)
    monkeypatch.setattr(tpu_pathtracer.utils.backend, "tpu_alive", lambda *a, **k: True)
    for name in ("make_atrium_gltf", "make_sphere_field_gltf"):
        monkeypatch.setattr(tpu_pathtracer.utils.testscenes, name,
                            lambda path, **_: tpu_pathtracer.utils.testscenes.make_cornell_gltf(path))
    monkeypatch.setattr(tpu_pathtracer.models.pathtracer, "render", record)
    assert root.main() == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["value"] == 0.0
    (scene, spp, seed, want), = calls

    w = bench.workload(torch.device("cuda"))
    got = bench.pass_config(w["config"], w["spp"], w["width"], w["height"], scene.ray_depth)
    assert (w["width"], w["height"], w["spp"]) == (scene.camera.width, scene.camera.height, spp)
    assert seed == 0 and w["reps"] == bench.REPS
    assert w["field"] == (values.get("BENCH_SCENE") != "field")
    want_fields = vars(want)
    shared = [f for f in vars(got) if f in want_fields and f != "tuning"]
    assert {"rays_per_batch", "sort_key", "frame_pool", "spp_per_pass"} <= set(shared)
    assert {f: getattr(got, f) for f in shared} == {f: want_fields[f] for f in shared}


def test_torch_bench_cpu_line(env, monkeypatch, capsys):
    """With the CPU asked for: one JSON line, last, with every key; the
    median's numbers; the card's fields null and no field render."""
    _cornell_for_bench_scenes(monkeypatch)
    env(TPU_PATHTRACER_TORCH_DEVICE="cpu", BENCH_SIZE=8, BENCH_SPP=2, BENCH_REPS=3)
    code, lines, err = _run(capsys)
    assert code == 0, err
    line = json.loads(lines[-1])
    for text in lines[:-1]:
        with pytest.raises(json.JSONDecodeError):
            json.loads(text)
    assert set(line) == KEYS
    assert line["timing"] == "median_of_3" and line["reps"] == 3
    times = line["rep_times_s"]
    assert len(times) == 3 and line["render_s_median"] == statistics.median(times)
    assert line["render_s_spread"] == (max(times) - min(times)) / statistics.median(times)
    assert line["measured_rays"] > 8 * 8 * 2
    assert line["value"] == line["measured_rays"] / line["render_s_median"] / 1e6
    assert line["pixel_samples_per_s"] == 8 * 8 * 2 / line["render_s_median"]
    assert line["vs_baseline"] == line["pixel_samples_per_s"] / bench.BASELINE_SAMPLES_PER_S
    assert line["loop"] == "graph" and line["iterations"] % pt.LOOP_ITERATIONS == 0
    assert "8x8@2spp" in line["metric"] and "cpu" in line["metric"]
    for key in ("card", "device_busy_ms_per_iteration", "device_busy_share",
                "peak_allocated_bytes", "reserved_bytes", "field_open_scene_samples_per_s"):
        assert line[key] is None, key


def test_torch_bench_refuses_cpu_unless_asked(env, monkeypatch, capsys):
    """No CUDA and no ``TPU_PATHTRACER_TORCH_DEVICE=cpu``: exit 1 with
    ``cli.select_device``'s message, and no number printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, lines, err = _run(capsys)
    assert code == 1
    assert lines == []
    assert "no CUDA device" in err and "TPU_PATHTRACER_TORCH_DEVICE=cpu" in err


@pytest.mark.parametrize("fault", ["frame", "rays", "nan", "shape", "raises"])
def test_torch_bench_gate_fails_a_bad_repeat(fault, env, monkeypatch, capsys):
    """A second timed render that differs from the first (one pixel's bits,
    its measured rays), one that is not finite or not of the frame's shape,
    or one that raises: the bench prints ``bench.py``'s failure line (value
    0.0) last and exits 1."""
    _cornell_for_bench_scenes(monkeypatch)
    env(TPU_PATHTRACER_TORCH_DEVICE="cpu", BENCH_SIZE=8, BENCH_SPP=1, BENCH_REPS=2)
    real = pt.render
    timed = []

    def render(scene, spp, seed=0, config=None, stats=None, **kw):
        img = real(scene, spp, seed=seed, config=config, stats=stats, **kw)
        if seed == 1:
            timed.append(1)
        if len(timed) == 2:
            if fault == "frame":
                img[3, 4, 1] = np.nextafter(img[3, 4, 1], np.float32(np.inf))
            elif fault == "rays":
                stats["measured_rays"] += 1
            elif fault == "nan":
                img[0, 0, 0] = np.nan
            elif fault == "shape":
                img = img[:, :-1]
            else:
                raise RuntimeError("a failed render")
        return img

    monkeypatch.setattr(pt, "render", render)
    code, lines, err = _run(capsys)
    assert code == 1
    assert len(timed) == 2
    assert json.loads(lines[-1]) == {
        "metric": "enclosed-atrium Mrays/s (RENDER FAILED)", "value": 0.0, "unit": "Mrays/s",
        "vs_baseline": 0.0}
    assert "bench render failed" in err


@pytest.mark.cuda
def test_torch_bench_on_card(env, capsys):
    """The bench on the card at 64x64 @ 2 spp, 2 repeats, atrium and field
    in turns: its gate passes and the line has every key, the graph loop,
    the card's fields and the device's busy time and memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env(BENCH_SIZE=64, BENCH_SPP=2, BENCH_REPS=2)
    code, lines, err = _run(capsys)
    assert code == 0, err
    line = json.loads(lines[-1])
    assert set(line) == KEYS
    assert line["timing"] == "median_of_2_alternating" and line["loop"] == "graph"
    assert "cuda" in line["metric"] and line["card"]
    assert line["field_open_scene_samples_per_s"] > 0
    assert line["device_busy_share"] > 0 and line["device_busy_ms_per_iteration"] > 0
    assert 0 < line["peak_allocated_bytes"] <= line["reserved_bytes"]
    pt.clear_compiled_loops()

