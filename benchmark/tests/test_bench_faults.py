"""A run of the harness on the CPU, at a small size, with the timed path
broken underneath: ``correct`` has to come out false for each fault that
the cells can have.  (Their one card holds no exchange between chips, so
that fault has no place here.)  The sound run beside them comes out true."""

import copy
import time

import pytest
import torch

from benchmark import manifest, run


def _small(cell_name: str) -> dict:
    """The cell at 16x16 on a field of 4 spheres (the envfield
    configuration cut down), so that a run takes seconds on the CPU."""
    cell = copy.deepcopy(manifest.cell(cell_name))
    cell["config"] = copy.deepcopy(manifest.cell("envfield.sweep")["config"])
    cell["config"]["scene"]["args"].update(n_spheres=4, subdiv=1)
    cell["config"]["render"]["spp_per_pass"] = 2
    t = cell["traffic"]
    if t["entry"] == "progressive":
        t.update(width=16, height=16, spp_per_pass=2, check_pixels=64)
    elif t["entry"] == "sweep":
        t.update(width=16, height=16, spp=3, check_renders=2, check_pixels=64)
    else:
        t.update(width=16, height=16, spp=2, check_frames=3, check_pixels=32)
    return cell


def _run(cell: dict, seed: int) -> dict:
    return run.execute(cell, seed, 0.5, False, torch.device("cpu"), time.perf_counter())


@pytest.fixture(params=["atrium.progressive", "envfield.sweep", "atrium.rerender"],
                ids=["progressive", "sweep", "rerender"])
def small(request):
    return _small(request.param)


def _wrap(monkeypatch, fault):
    """Break the engine's output where it is produced: ``fault(rad)`` -> the
    radiance the pass or frame hands on."""
    from tpu_pathtracer_torch.models import pathtracer
    from tpu_pathtracer_torch.parallel import checkpoint

    real = pathtracer.render_chunk_persistent

    def broken(*args, **kwargs):
        rad, rays = real(*args, **kwargs)
        return fault(rad.clone()), rays

    monkeypatch.setattr(checkpoint, "render_chunk_persistent", broken)
    monkeypatch.setattr(pathtracer, "render_chunk_persistent", broken)


def test_bench_sound_run_is_correct(small):
    out = _run(small, 3000000019)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


def test_bench_fault_state_unchanged(small, monkeypatch):
    if small["traffic"]["entry"] == "progressive":
        # Every pass adds nothing to the accumulator.
        _wrap(monkeypatch, torch.zeros_like)
    elif small["traffic"]["entry"] == "sweep":
        # Every render hands back the first render's frame.
        from tpu_pathtracer_torch import cli

        real, first = cli.render_scene_file, []

        def stale(*args, **kwargs):
            if not first:
                first.append(real(*args, **kwargs))
            return first[0]

        monkeypatch.setattr(cli, "render_scene_file", stale)
    else:
        # Every frame hands back the first frame.
        from tpu_pathtracer_torch import renderer

        real, first = renderer.Renderer.render, []

        def stale(self, *args, **kwargs):
            if not first:
                first.append(real(self, *args, **kwargs))
            return first[0]

        monkeypatch.setattr(renderer.Renderer, "render", stale)
    assert _run(small, 3000000019)["correct"] is False


def test_bench_fault_half_the_batch(small, monkeypatch):
    def half(rad):
        # Every other lane left out, the mean over the rest in its place
        # (the rows past a chunk's pixels are padding).
        rad[1::2] = rad[0::2].mean(dim=0)
        return rad

    _wrap(monkeypatch, half)
    assert _run(small, 3000000019)["correct"] is False


def test_bench_fault_answer_altered(small, monkeypatch):
    _wrap(monkeypatch, lambda rad: rad * 1.01)
    assert _run(small, 3000000019)["correct"] is False


def test_bench_sweep_traces_a_tile_of_every_chunk():
    """With ``trace`` the sweep profiles every ``trace_every``-th engine call
    of its first render, one profiler run each: here a 32x32 frame in 2
    chunks of 512 lanes and 2 passes, so the first pass of each chunk."""
    cell = _small("envfield.sweep")
    cell["config"]["render"]["rays_per_batch"] = 512
    cell["traffic"].update(width=32, height=32, trace_tiles=2, trace_every=2)
    res = manifest.entry("sweep")(cell, 3000000019, 0.5, True, torch.device("cpu"),
                                  time.perf_counter())
    tr = res["ctx"]["trace"]
    assert len(tr["prof"]) == 2 and tr["iterations"] > 0 and tr["wall_s"] > 0
    assert res["ctx"]["untraced"]["iterations"] > 0
    cell["traffic"].update(trace_tiles=3)
    with pytest.raises(RuntimeError, match="too few"):
        manifest.entry("sweep")(cell, 3000000019, 0.5, True, torch.device("cpu"),
                                time.perf_counter())
