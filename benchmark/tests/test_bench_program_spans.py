"""The per-layer readers of the program's span log
(``benchmark/program_spans.py``), on synthetic events and spans: graph
replays sliced by correlation id, nothing on a count mismatch, the
device's idle time put down to the innermost span, the replay gap held
against traced busy time of the same work, the untraced readers, and
nothing from a program without the log.  The sweep's tile tracer sees
one "dispatch" phase per engine call of the program's render."""

import collections
import os
from types import SimpleNamespace

import pytest

from benchmark import manifest
from benchmark import program_spans as ps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Ev:
    def __init__(self, name, start, end, corr=0, dev=False):
        self._v = (name, start, end, corr, dev)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: list(evs))))


def _log(rows):
    """Spans from (name, parent's index or None, start, end, counts), ids
    1, 2, ... in order."""
    return [SimpleNamespace(name=n, id=i + 1, parent=0 if p is None else p + 1, start_ns=s,
                            end_ns=e, counts=c)
            for i, (n, p, s, e, c) in enumerate(rows)]


# One traced pass: a chunk pass around an engine call (with a capture and a
# drain) that launches its graph twice; each replay runs five operations,
# given out of order.  Then an untraced part: two passes of the same work
# with a readback and a save each, a pass of other work (a 4-spp tail), and
# a sweep-like load and capture.
_MAP = SimpleNamespace(graph=1, nodes=5, rows=[
    ("loop/sort", 0, 0), ("loop/shading", 1, 1), ("loop/shading/intersector", 2, 2),
    ("loop/shading/intersector/kernels", 3, 3), ("block", 4, 4)])
_SPANS = _log([
    ("pass", None, 500, 10_500, {}),                                          # 0
    ("chunk_pass", 0, 900, 10_100, dict(start=0, samples=16)),                # 1
    ("engine_call", 1, 1_000, 10_000, dict(lanes=4, iterations=8, graph=1, rays=20)),
    ("capture", 2, 1_100, 1_400, dict(iterations=4)),                         # 3
    ("drain", 2, 1_500, 9_500, {}),                                           # 4
    ("pass", None, 11_000, 15_000, {}),                                       # 5
    ("chunk_pass", 5, 11_050, 14_500, dict(start=0, samples=16)),             # 6
    ("engine_call", 6, 11_100, 14_000, dict(lanes=4, iterations=5, graph=1, rays=15)),
    ("readback", 6, 14_000, 14_500, {}),                                      # 8
    ("save", 5, 14_500, 14_900, {}),                                          # 9
    ("pass", None, 15_000, 19_000, {}),                                       # 10
    ("chunk_pass", 10, 15_050, 18_500, dict(start=0, samples=16)),            # 11
    ("engine_call", 11, 15_100, 18_000, dict(lanes=4, iterations=5, graph=1, rays=5)),
    ("readback", 11, 18_000, 18_500, {}),                                     # 13
    ("save", 10, 18_500, 18_900, {}),                                         # 14
    ("pass", None, 19_000, 20_000, {}),                                       # 15
    ("chunk_pass", 15, 19_050, 19_900, dict(start=0, samples=4)),             # 16
    ("engine_call", 16, 19_100, 19_800, dict(lanes=4, iterations=2, graph=1, rays=4)),
    ("readback", 16, 19_800, 19_900, {}),                                     # 18
    ("save", 15, 19_900, 19_950, {}),                                         # 19
    ("load", None, 20_000, 21_000, {}),                                       # 20
    ("capture", None, 21_100, 21_600, dict(iterations=4)),                    # 21
])


def _replay(corr, t0, drop=False):
    ops = [("void at::native::sort_op", 0, 100), ("void at::native::shade_op", 100, 300),
           ("void at::native::glue_op", 300, 350), ("items_kernel(float const*)", 350, 650),
           ("Memcpy DtoD (Device -> Device)", 650, 660)]
    evs = [_Ev(n, t0 + a, t0 + b, corr, dev=True) for n, a, b in ops[:4 if drop else 5]]
    return evs[::-1] + [_Ev("cudaGraphLaunch", t0 - 100, t0 - 50, corr)]


def _ctx(monkeypatch, drop=False, log=True, spans=_SPANS, **extra):
    evs = ([_Ev("aten::first", 600, 700)] + _replay(11, 2_100) + _replay(12, 6_100, drop)
           + [_Ev("aten::last", 10_200, 10_300)])
    monkeypatch.setattr(ps, "program_log", lambda: (spans, {1: _MAP}) if log else None)
    return dict(pixel_samples=1, trace=dict(prof=_prof(evs), iterations=8), **extra)


def _read(name, ctx):
    return manifest.reader(name)(ctx)


def test_bench_stage_readers_slice_replays_by_correlation(monkeypatch):
    ctx = _ctx(monkeypatch)
    ops = ps.replay_ops(ctx)
    assert [n for n, _ in ops["loop/sort"]] == ["void at::native::sort_op"] * 2
    assert ops["block"] == [("Memcpy DtoD (Device -> Device)", 10)] * 2
    # ns over 8 iterations, in ms
    assert _read("shade_ms_per_iteration.samples", ctx) == pytest.approx(2 * 200 / 8 / 1e6)
    assert _read("intersect_glue_ms_per_iteration.samples", ctx) == pytest.approx(
        2 * 50 / 8 / 1e6)
    assert _read("lane_ms_per_iteration.samples", ctx) == pytest.approx(2 * 100 / 8 / 1e6)


def test_bench_stage_class_sorts_every_stage_path():
    """One classification serves the readers and ``trace_report``: the
    intersector's operations by name, then the named stages, the lane
    stages, the rest of ``shading``, and the path itself."""
    def cls(path, name="void at::native::op"):
        return ps.stage_class(path.split("/"), name)

    assert cls("loop/shading/intersector/kernels") == "intersect_glue"
    assert cls("loop/shading/intersector/kernels", "items_kernel(float const*)") == \
        "intersect_kernels"
    assert [cls(p) for p in ("loop/shading/hit_info", "loop/shading/light_pdf", "loop/draws",
                             "loop/sort", "loop/regenerate/spawn", "loop/add_rows",
                             "loop/shading", "loop", "block")] == [
        "hit_info", "light_pdf", "draws", "lane", "lane", "lane", "shade", "loop", "block"]


def test_bench_stage_readers_report_nothing_on_a_count_mismatch(monkeypatch):
    ctx = _ctx(monkeypatch, drop=True)  # the second replay ran 4 operations, its map has 5
    assert ps.replay_ops(ctx) is None
    for name in ("shade_ms_per_iteration.samples", "intersect_glue_ms_per_iteration.samples",
                 "lane_ms_per_iteration.samples"):
        assert _read(name, ctx) is None


def test_bench_idle_is_put_down_to_the_innermost_span(monkeypatch):
    """Idle stretches of the traced part are cut at span boundaries and
    given to the innermost open span."""
    segs = ps.idle_segments(_ctx(monkeypatch))
    total = (10_300 - 600) - 2 * 660  # the window less the two replays' busy time
    assert sum(ns for ns, _, _ in segs) == total
    by_inner = collections.Counter()
    for ns, chain, inner in segs:
        by_inner[inner.name if inner else None] += ns
        assert chain[-1] == inner.name and chain[0] == "pass"
    assert by_inner == {"pass": (900 - 600) + (10_300 - 10_100),
                        "chunk_pass": (1_000 - 900) + (10_100 - 10_000),
                        "engine_call": (1_100 - 1_000) + (1_500 - 1_400) + (10_000 - 9_500),
                        "capture": 300, "drain": (9_500 - 1_500) - 2 * 660}


def test_bench_replay_gap_holds_the_same_work(monkeypatch):
    """The replay gap: the untraced engine calls' wall per iteration less
    the device's busy time per iteration inside the traced calls of the
    same work (first pixel and samples of their chunk pass), captures
    (time and first blocks) left out on both sides; the tail pass's call
    of other work is not read, and with no untraced call of the traced
    work there is nothing to read."""
    ctx = _ctx(monkeypatch)
    wall = (14_000 - 11_100 + 18_000 - 15_100) / (5 + 5)
    busy = 2 * 660 / (8 - 4)
    assert _read("replay_gap_ms_per_iteration.samples", ctx) == pytest.approx((wall - busy) / 1e6)
    other = [s if s.name != "chunk_pass" or s.start_ns < 11_000
             else SimpleNamespace(**dict(vars(s), counts=dict(start=0, samples=4)))
             for s in _SPANS]
    assert _read("replay_gap_ms_per_iteration.samples", _ctx(monkeypatch, spans=other)) is None
    assert _read("replay_gap_ms_per_iteration.samples", dict(ctx, pixel_samples=0)) is None


def test_bench_untraced_readers_read_the_spans_after_the_trace(monkeypatch):
    ctx = _ctx(monkeypatch)
    assert _read("lane_occupancy.samples", ctx) == pytest.approx((15 + 5 + 4) / ((5 + 5 + 2) * 4))
    assert _read("checkpoint_ms_per_pass.samples", ctx) == pytest.approx(
        (400 + 500 + 400 + 500 + 50 + 100) / 3 / 1e6)
    assert _read("capture_ms_per_render.sweep", ctx) == pytest.approx(500 / 1e6)


def test_bench_span_readers_report_nothing_without_the_log(monkeypatch):
    """A program without the span log (an older commit) gives every new
    reader nothing to read, and none raises."""
    ctx = _ctx(monkeypatch, log=False, frames=1)
    for name in ("shade_ms_per_iteration.samples", "intersect_glue_ms_per_iteration.samples",
                 "lane_ms_per_iteration.samples", "replay_gap_ms_per_iteration.samples",
                 "lane_occupancy.samples", "checkpoint_ms_per_pass.samples",
                 "capture_ms_per_render.sweep"):
        assert _read(name, ctx) is None, name
    assert _read("lane_occupancy.samples", {"pixel_samples": 1}) is None  # no trace at all


def test_bench_sweep_tile_trace_sees_every_engine_call(tmp_path):
    """The sweep's ``_TileTrace`` sees one "dispatch" phase per engine call
    of the program's render, so ``trace_every`` counts engine calls."""
    import dataclasses

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
    from tpu_pathtracer_torch.utils.profiling import span, spans

    path = fixtures.make_cornell_gltf(str(tmp_path / "c" / "scene.gltf"))
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(32, 32))
    sweep = manifest._module(os.path.join(ROOT, "benchmark", "entries", "sweep.py"),
                             "test_sweep_entry")
    tiles = sweep._TileTrace(0, 1, lambda: pt.persistent_accum.iterations)
    with span("test") as mark:
        pt.render(scene, spp=3, seed=2, config=RenderConfig(spp_per_pass=1, rays_per_batch=512),
                  timer=tiles)
    calls = [s for s in spans() if s.id > mark.id and s.name == "engine_call"]
    assert tiles.seen == len(calls) == 6 and not tiles.prof
