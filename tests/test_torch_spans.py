"""The port's span log (``tpu_pathtracer_torch/utils/profiling``): spans
nest with ids and parents in a bounded ring on the profiler's clock, with
durations on the monotonic clock; the render entries put their passes,
engine calls, readbacks, saves, loads and writes in it, with the measured
rays of every entry; a stage is a span only while a graph is captured,
where the graph's stage map gives each node one stage; and
``profile_render`` slices graph replays by the map.  The benchmark's
readers of the log are tested in ``benchmark/tests/``.  The ``cuda`` case
(skipped without a card) holds the stage map to the replays the card
runs: ``python -m pytest tests/test_torch_spans.py -m cuda``."""

import collections
import contextlib
import dataclasses
import os
import time
from types import SimpleNamespace

import pytest
import torch

from tpu_pathtracer_torch import cli, profile_render
from tpu_pathtracer_torch.config import DEFAULT_CONFIG, RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.parallel.checkpoint import render_with_checkpoints
from tpu_pathtracer_torch.renderer import Renderer
from tpu_pathtracer_torch.scene import fixtures
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from tpu_pathtracer_torch.utils import profiling
from tpu_pathtracer_torch.utils.profiling import PhaseTimer, span, stage, stage_map

torch.set_num_threads(1)

def _cornell(tmp_path, w=16, h=16):
    path = fixtures.make_cornell_gltf(str(tmp_path / "c" / "scene.gltf"))
    s = parse_gltf_scene(path, w / h)
    return path, dataclasses.replace(s, camera=s.camera.with_dims(w, h))


def _after(mark, name=None):
    """The spans opened after span ``mark`` (named ``name``)."""
    return [s for s in profiling.spans() if s.id > mark.id and (name is None or s.name == name)]


def test_torch_span_nesting_ids_and_parents():
    with span("outer", a=1) as outer:
        with span("inner") as inner:
            inner.add(rays=5)
        with span("second") as st:
            pass
    assert outer.parent == 0 and inner.parent == st.parent == outer.id
    assert outer.id < inner.id < st.id
    assert outer.counts == {"a": 1} and inner.counts == {"rays": 5} and st.counts == {}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= st.start_ns <= st.end_ns \
        <= outer.end_ns
    assert profiling.spans()[-3:] == [outer, inner, st]  # in the order they opened
    assert profiling.last("inner") is inner
    with pytest.raises(ValueError):
        with span("boom") as boom:
            raise ValueError("closed all the same")
    assert boom.end_ns >= boom.start_ns and boom.seconds >= 0
    with span("after") as after:
        pass
    assert after.parent == 0  # nothing left open


def test_torch_span_log_is_bounded(monkeypatch):
    assert profiling.RING == 1 << 20 and profiling._LOG.maxlen == profiling.RING
    monkeypatch.setattr(profiling, "_LOG", collections.deque(maxlen=8))
    made = []
    for i in range(20):
        with span("s", i=i) as s:
            made.append(s)
    assert profiling.spans() == made[-8:]
    assert [s.counts["i"] for s in profiling.spans()] == list(range(12, 20))


def test_torch_span_clock_is_the_profilers():
    """A span's start and end enclose the profiler's host events of the
    torch operations run inside it, each 1 ms sleep inside the span kept
    between them: one clock.  The span adds no event to the profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("spans_clock_probe") as sp:
            time.sleep(0.001)
            x = torch.ones(4096).cumsum(0)
            (x * 2.0).sum()
            time.sleep(0.001)
    evs = list(prof.profiler.kineto_results.events())
    ops = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in evs
           if ev.name() in ("aten::cumsum", "aten::mul", "aten::sum")]
    assert len(ops) >= 3
    assert sp.start_ns + 1_000_000 <= min(s for s, _ in ops)
    assert max(e for _, e in ops) + 1_000_000 <= sp.end_ns
    assert not any(ev.name() == "spans_clock_probe" for ev in evs)


def test_torch_checkpoint_loop_measures_rays(tmp_path):
    """``render_with_checkpoints(stats=)`` counts the rays ``render`` counts
    for the same scene, seed and pass split, reads them once an engine
    call, and puts them on the call's span."""
    _, scene = _cornell(tmp_path)
    cfg = RenderConfig(spp_per_pass=2)
    want = {}
    pt.render(scene, spp=4, seed=3, config=cfg, stats=want)
    got = {}
    with span("test") as mark:
        render_with_checkpoints(scene, spp=4, seed=3, config=cfg, stats=got,
                                checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2,
                                resume=False)
    assert got == want and got["measured_rays"] > 16 * 16 * 4
    calls = _after(mark, "engine_call")
    assert sum(c.counts["rays"] for c in calls) == got["measured_rays"]
    passes, saves = _after(mark, "pass"), _after(mark, "save")
    chunks = _after(mark, "chunk_pass")
    assert len(passes) == 2 and [c.parent for c in chunks] == [p.id for p in passes]
    assert [c.counts for c in chunks] == [{"start": 0, "samples": 2}] * 2
    assert [s.parent for s in saves] == [p.id for p in passes]
    reads = _after(mark, "readback")
    assert [r.parent for r in reads] == [c.parent for c in calls] == [c.id for c in chunks]
    assert len(_after(mark, "fingerprint")) == 1


def test_torch_renderer_passes_stats_through(tmp_path):
    """``Renderer.render(stats=)`` hands ``stats`` to ``render``: the rays
    and loop of the same frame rendered directly; the frame is a span."""
    path, scene = _cornell(tmp_path)
    want = {}
    pt.render(scene, spp=2, seed=7, config=DEFAULT_CONFIG, stats=want)
    viewer = Renderer(path, device="cpu")
    got = {}
    with span("test") as mark:
        viewer.render(16, 16, 2, seed=7, stats=got)
    assert got == want and got["measured_rays"] > 0
    (frame,) = _after(mark, "frame")
    assert all(frame.start_ns <= c.start_ns and c.end_ns <= frame.end_ns
               for c in _after(mark, "engine_call"))


@pytest.mark.parametrize("eager", [False, True])
def test_torch_engine_call_counts_sum_to_iterations(tmp_path, eager):
    """The ``engine_call`` spans' iterations add up to the
    ``persistent_accum.iterations`` delta, their rays to the measured rays;
    each holds a ``call_start`` and a ``drain``, inside a ``chunk_pass``
    with the chunk's first pixel and the pass's samples."""
    _, scene = _cornell(tmp_path, 32, 32)
    cfg = RenderConfig(spp_per_pass=2, rays_per_batch=512)
    it0 = pt.persistent_accum.iterations
    stats = {}
    with span("test") as mark:
        pt.render(scene, spp=3, seed=1, config=cfg, stats=stats, eager=eager)
    calls = _after(mark, "engine_call")
    assert len(calls) == 2 * 2  # two chunks of 512 pixels, two passes each
    assert sum(c.counts["iterations"] for c in calls) == pt.persistent_accum.iterations - it0
    assert sum(c.counts["rays"] for c in calls) == stats["measured_rays"]
    assert all(set(c.counts) == {"lanes", "ray_tile", "chunks", "iterations", "rays", "b2_units",
                                 "b1_tests", "b3_pairs", "b3_live"} and c.counts["lanes"] == 512
               for c in calls)
    passes = {p.id: p for p in _after(mark, "chunk_pass")}
    assert [passes[c.parent].counts for c in calls] == [
        {"start": a, "samples": b} for a, b in ((0, 2), (0, 1), (512, 2), (512, 1))]
    assert not _after(mark, "pass")  # a frame pass of the checkpoint loop only
    for c in calls:
        assert [s.name for s in _after(mark) if s.parent == c.id] == ["call_start", "drain"]


@pytest.mark.parametrize("frame_pool", [True, False])
@pytest.mark.parametrize("entry", ["render", "render_with_checkpoints"])
def test_torch_engine_calls_carry_the_counts_the_engine_returned(tmp_path, monkeypatch, entry,
                                                                  frame_pool):
    """Each ``engine_call`` span of both frame loops carries ``rays``,
    ``b2_units``, ``b1_tests``, ``b3_pairs`` and ``b3_live`` equal to the
    counts its ``persistent_accum`` call returned (through
    ``render_chunk_persistent``), and the measured rays are their sum; the
    atrium's six lights take K1, so B3 counts nothing."""
    path = fixtures.make_atrium_gltf(str(tmp_path / "a" / "atrium.gltf"), detail=0,
                                     textured=False)
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(32, 32))
    cfg = RenderConfig(spp_per_pass=1, rays_per_batch=512, frame_pool=frame_pool)
    real, returned = pt.render_chunk_persistent, []

    def spy(*args, **kwargs):
        rad, counts = real(*args, **kwargs)
        returned.append(counts.tolist())
        return rad, counts

    monkeypatch.setattr(pt, "render_chunk_persistent", spy)
    stats = {}
    with span("test") as mark:
        if entry == "render":
            pt.render(scene, spp=2, seed=5, config=cfg, stats=stats)
        else:
            render_with_checkpoints(scene, spp=2, seed=5, config=cfg, stats=stats)
    calls = _after(mark, "engine_call")
    # Two passes of the frame as one pool, or of two chunks of 512 pixels.
    assert len(calls) == len(returned) == (2 if frame_pool else 4)
    assert [[c.counts[k] for k in pt.CALL_COUNTS] for c in calls] == returned
    assert pt.CALL_COUNTS == ("rays", "b2_units", "b1_tests", "b3_pairs", "b3_live")
    assert all(b2 > 0 and b1 > 0 and b3 == b3_live == 0 for _, b2, b1, b3, b3_live in returned)
    assert stats["measured_rays"] == sum(r for r, *_ in returned)


def test_torch_stage_map_assigns_every_node_once():
    """With a fake node counter: every node of the graph lands in exactly
    one row, the innermost stage open when it was captured ("block"
    outside every stage), in capture order; a failed capture keeps no
    map, and outside a capture a stage reads no counter."""
    nodes = [0]

    def launch(k):
        nodes[0] += k

    with stage_map(lambda: nodes[0]) as smap:
        launch(2)
        with stage("loop"):
            launch(1)
            with stage("sort"):
                launch(3)
            with stage("shading"):
                with stage("intersector"):
                    with stage("kernels"):
                        launch(2)
                    launch(1)
                launch(4)
            with stage("empty"):
                pass
        launch(2)
    assert smap.nodes == 15
    assert smap.rows == [("block", 0, 1), ("loop", 2, 2), ("loop/sort", 3, 5),
                         ("loop/shading/intersector/kernels", 6, 7),
                         ("loop/shading/intersector", 8, 8), ("loop/shading", 9, 12),
                         ("block", 13, 14)]
    assert [i for _, a, b in smap.rows for i in range(a, b + 1)] == list(range(15))
    assert profiling.stage_maps()[-1] is smap
    with pytest.raises(RuntimeError):
        with stage_map(lambda: nodes[0]) as failed:
            raise RuntimeError("capture failed")
    assert failed.graph > smap.graph and profiling.stage_maps()[-1] is smap
    with stage("outside"):  # no map open: the counter is never read
        launch(1)


class _CountingTimer:
    """A ``timer`` that opens no span: counts the phases it is handed."""

    def __init__(self):
        self.counts = collections.Counter()

    def phase(self, name):
        self.counts[name] += 1
        return contextlib.nullcontext()


def test_torch_dispatch_phase_opens_once_per_engine_call(tmp_path):
    """A ``timer``'s "dispatch" phase opens once per engine call, whether the
    timer opens spans or not (a benchmark's tile tracer hooks it); a
    ``PhaseTimer``'s phase is a span around the call."""
    _, scene = _cornell(tmp_path, 32, 32)
    cfg = RenderConfig(spp_per_pass=1, rays_per_batch=512)
    tiles = _CountingTimer()
    with span("test") as mark:
        pt.render(scene, spp=3, seed=2, config=cfg, timer=tiles)
    assert tiles.counts["dispatch"] == len(_after(mark, "engine_call")) == 6
    timer = PhaseTimer()
    with span("test") as mark:
        pt.render(scene, spp=3, seed=2, config=cfg, timer=timer)
    calls, phases = _after(mark, "engine_call"), _after(mark, "dispatch")
    assert timer.counts["dispatch"] == len(calls) == len(phases) == 6
    assert [c.parent for c in calls] == [p.id for p in phases]
    assert timer.counts["device_wait_readback"] == 2


def test_torch_cli_load_and_write_are_spans(tmp_path, monkeypatch):
    """``load_seconds`` is the ``load`` span, on the log's clock; the CLI's
    image write is a ``write`` span."""
    path, _ = _cornell(tmp_path)
    monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
    with span("test") as mark:
        rc = cli.main(["x", path, "8", "8", "1", str(tmp_path / "o.ppm")])
    assert rc == 0
    (load,) = _after(mark, "load")
    (write,) = _after(mark, "write")
    assert write.counts == {} and os.path.getsize(tmp_path / "o.ppm") > 0
    _, metrics = cli.render_scene_file(path, 8, 8, 1, progress=False, device=torch.device("cpu"))
    assert metrics.load_seconds == profiling.last("load").seconds > 0
    assert [s.name for s in _after(mark) if s.parent == mark.id] == ["load_render",
                                                                      "tonemap_write"]
    assert load.parent == _after(mark, "load_render")[0].id


def test_torch_stage_is_a_null_context_outside_a_capture(tmp_path):
    """Outside a capture a stage logs nothing (the eager loop pays a flag
    test, and the ring keeps the coarse spans); inside one it is a span
    of the log, nested as the stages are."""
    assert stage("sort") is stage("shading") is profiling._NO_STAGE
    with span("test") as mark:
        with stage("outside"):
            pass
    assert not _after(mark)
    with stage_map(lambda: 0):
        with stage("loop") as loop:
            with stage("sort") as sort:
                pass
    assert [s.name for s in _after(mark)] == ["loop", "sort"] and sort.parent == loop.id


def test_torch_eager_loop_logs_only_coarse_spans(tmp_path):
    """An eager render (the CPU's loop, and CUDA's under intersector mode
    "bins") logs the coarse spans alone: a few a chunk pass, whatever
    the iterations."""
    _, scene = _cornell(tmp_path, 32, 32)
    cfg = RenderConfig(spp_per_pass=2, rays_per_batch=512)
    it0 = pt.persistent_accum.iterations
    with span("test") as mark:
        pt.render(scene, spp=4, seed=5, config=cfg, eager=True)
    names = collections.Counter(s.name for s in _after(mark))
    assert pt.persistent_accum.iterations - it0 > 4 * 4  # many iterations a call
    assert names == {"chunk_pass": 4, "engine_call": 4, "call_start": 4, "drain": 4,
                     "readback": 2}


def test_torch_span_durations_are_monotonic(monkeypatch):
    """A span starts on the wall clock (the profiler's) and lasts what the
    monotonic clock says, so a step of the wall clock inside it moves its
    end with its start and never its duration."""
    wall = iter([5_000_000_000, 1_000])  # the wall clock steps back inside the span
    mono = iter([100, 350])
    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=lambda: next(wall),
                                                           perf_counter_ns=lambda: next(mono)))
    with span("stepped") as sp:
        pass
    assert (sp.start_ns, sp.end_ns) == (5_000_000_000, 5_000_000_250)
    assert sp.seconds == 250e-9


def test_torch_scan_engine_calls_are_spans(tmp_path):
    """Without compaction the wavefront engine's calls are ``engine_call``
    spans with their lanes, each in its ``chunk_pass``; no rays are read."""
    _, scene = _cornell(tmp_path, 16, 16)
    cfg = RenderConfig(spp_per_pass=1, compaction=False)
    stats = {}
    with span("test") as mark:
        pt.render(scene, spp=2, seed=4, config=cfg, stats=stats)
    calls, chunks = _after(mark, "engine_call"), _after(mark, "chunk_pass")
    assert [c.parent for c in calls] == [c.id for c in chunks]
    assert [c.counts for c in chunks] == [{"start": 0, "samples": 1}] * 2
    assert all(set(c.counts) == {"lanes"} and c.counts["lanes"] >= 256 for c in calls)
    assert "measured_rays" not in stats


class _KEv:
    """A kineto event of a synthetic profile."""

    def __init__(self, name, start, dur, corr, dev):
        self._v = (name, start, dur, corr, dev)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"


@pytest.mark.parametrize("drop", [False, True])
def test_torch_profile_render_splits_replays_by_the_map(monkeypatch, drop):
    """``profile_render`` gives a replay's device operations, by start, to
    the nodes of the stage map of the engine call around its launch, and
    leaves out a replay whose operation count differs from the map's."""
    smap = SimpleNamespace(graph=7, nodes=3, rows=[("loop/sort", 0, 0), ("loop/shading", 1, 2)])
    call = SimpleNamespace(name="engine_call", start_ns=0, end_ns=10_000, counts={"graph": 7})
    monkeypatch.setattr(profiling, "stage_maps", lambda: [smap])
    monkeypatch.setattr(profiling, "spans", lambda: [call])
    evs = []
    for corr, t0 in ((1, 1_000), (2, 5_000)):
        evs.append(_KEv("cudaGraphLaunch", t0 - 100, 50, corr, False))
        ops = [("sort", t0, 100), ("a", t0 + 100, 200), ("b", t0 + 300, 400)]
        if drop and corr == 2:
            ops = ops[:2]
        evs += [_KEv(n, s, d, corr, True) for n, s, d in reversed(ops)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: evs)))
    split, replays = profile_render._stage_split(prof, 4)
    n = 1 if drop else 2
    assert replays == [n, 2]
    assert split == {"loop/sort": [n / 4, n * 100 / 1e6 / 4],
                     "loop/shading": [2 * n / 4, n * 600 / 1e6 / 4]}


@pytest.mark.cuda
def test_torch_stage_map_matches_every_replay_on_card(tmp_path):
    """On the card each replay of the persistent loop's graph runs as many
    device operations as its stage map has nodes, and the map holds the
    loop's stages with the intersector's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = fixtures.make_atrium_gltf(str(tmp_path / "a" / "a.gltf"), detail=1, textured=False)
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(128, 128)).to("cuda")
    pt.clear_compiled_loops()
    pt.render(scene, spp=1, seed=0)  # builds the kernels, captures the graph
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pt.render(scene, spp=2, seed=1)
    evs = list(prof.profiler.kineto_results.events())
    launches = [ev.correlation_id() for ev in evs if ev.name() == "cudaGraphLaunch"]
    per_replay = collections.Counter(ev.correlation_id() for ev in evs
                                     if str(ev.device_type()).endswith("CUDA"))
    smap = profiling.stage_maps()[-1]
    assert launches and all(per_replay[cid] == smap.nodes for cid in launches)
    paths = {p for p, _, _ in smap.rows}
    assert {"loop/sort", "loop/draws", "loop/shading/intersector/kernels", "loop/add_rows",
            "block"} <= paths
    _, replays = profile_render._stage_split(prof, 1)
    assert replays == [len(launches)] * 2
    pt.clear_compiled_loops()
    assert profiling.stage_maps()[-1] is smap  # the map outlives its graph
    assert smap.rows[-1][2] + 1 == smap.nodes
