"""The bodies the scan engine and the homebrew renderers run as CUDA graphs
(``models/pathtracer.scan_accum``, ``models/legacy.render_homebrew``), on
the CPU, where each body runs as it is, the very code a card captures:

- the scan engine's fixed-depth trace (every bounce, as in a graph) equals
  the early-exit trace bit for bit, and a bounce over dead lanes changes
  nothing;
- device-scalar first pixel, seed and sample equal Python ints;
- the Monte-Carlo sample body's device-folded keys equal the host-int keys,
  and the Whitted search's blocks past the empty stacks change nothing;
- after one warm-up, each body copies nothing from the host and reads
  nothing back outside the kernel wrappers (what a capture needs);
- a capture that fails is raised, never retried;
- one cache of compiled bodies, keyed per engine, serves every chunk, seed
  and pass.

The graphs themselves run in ``tests/test_torch_cuda.py`` (cuda marker)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_graph_loop import _HostWatch, _case, _opaque
from test_torch_legacy import SCENES, _write
from tpu_pathtracer_torch.config import IntersectTuning, RenderConfig
from tpu_pathtracer_torch.models import graph
from tpu_pathtracer_torch.models import legacy
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.parallel import mesh as tmesh
from tpu_pathtracer_torch.scene.homebrew import parse_homebrew_scene

torch.set_num_threads(1)

# (base case of test_torch_graph_loop, config change, ray depth, samples):
# depths past 8 at which every lane of the small scenes dies before the last
# bounce, so the early exit really skips bounces.  The sphere field and the
# atrium run 2,048 lanes against more than 1,024 triangles: the sort, and
# its inverse permutation.
SCAN_CASES = {
    "cornell": ("cornell", {}, 16, 2),
    "sobol": ("cornell", {"jitter": "sobol", "lowdisc": "sobol"}, 24, 2),
    "many_lights": ("many_lights", {}, 16, 2),
    "env_field": ("env_field", {}, 16, 2),
    "field_target": ("env_field", {"sort_key": "target"}, 16, 2),
    "atrium": ("atrium_items", {}, 3, 1),
}


def _scan_case(name, tmp):
    base, change, depth, spp = SCAN_CASES[name]
    scene, config, _ = _case(base, tmp)
    n = scene.camera.width * scene.camera.height
    return (dataclasses.replace(scene, ray_depth=depth), dataclasses.replace(config, **change),
            n, spp)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_torch_scan_fixed_depth_equals_early_exit(case, tmp_path):
    """Every ``ray_depth`` bounce (the graphed body) against the early exit
    once every ray is dead, bit for bit: ``trace`` alone and two samples of
    ``scan_accum`` (graph body against eager loop), with Sobol draws, 1,000
    lights (B3's twin), the env map, the "hint" and "target" sort keys and
    the small atrium."""
    scene, config, n, spp = _scan_case(case, tmp_path)
    pids = torch.arange(n, dtype=torch.int32)
    o, d = pt.gen_rays(scene.camera, pids, trng.jitter_uniforms(5, 1, pids, config.jitter))
    early = pt.trace(scene, o, d, 5, pids, config, sample=1)
    full = pt.trace(scene, o, d, 5, pids, config, sample=1, early_exit=False)
    assert _bits_equal(full, early)
    assert float(torch.nan_to_num(early).abs().sum()) > 0
    pt.scan_accum.bounces = 0
    want = pt.scan_accum(scene, 0, 5, 1, n, spp, config, eager=True)
    eager_bounces = pt.scan_accum.bounces
    pt.scan_accum.bounces = 0
    got = pt.scan_accum(scene, 0, 5, 1, n, spp, config)
    assert _bits_equal(got, want)
    assert pt.scan_accum.bounces == spp * scene.ray_depth >= eager_bounces
    if scene.ray_depth > 8:  # the early exit skipped bounces
        assert eager_bounces < spp * scene.ray_depth
    pt.clear_compiled_loops()


@pytest.mark.parametrize("sort_key", ["hint", "dirhint", "cell", "target", "none"])
def test_torch_dead_bounce_changes_nothing(sort_key, tmp_path):
    """A bounce over a wavefront whose lanes are all dead leaves radiance,
    throughput, ``alive``, origin and direction as they were, and every sort
    key is one constant over dead lanes, so the stable sort keeps the lane
    order (and ``slot``): what lets the graphed body run past the bounce at
    which the eager loop stops."""
    scene, config, _ = _case("atrium_items", tmp_path)
    config = dataclasses.replace(config, sort_key=sort_key)
    n = 2048
    pids = torch.arange(n, dtype=torch.int32)
    o, d = pt.gen_rays(scene.camera, pids, trng.jitter_uniforms(2, 0, pids))
    alive = torch.ones(n, dtype=torch.bool)
    draws = pt.bounce_draws(2, 0, 0, pids, config)
    o, d, thr, rad, alive, hint = pt.bounce_step(
        scene, config, o, d, torch.ones_like(o), torch.zeros_like(o), alive, draws)
    assert bool(alive.any()) and float(rad.sum()) >= 0
    dead = torch.zeros_like(alive)
    o = pt.where3(dead, o, torch.full((3,), 1e30))  # parked, as the sorted loop parks them
    perm = torch.argsort(pt._make_sort_key(scene, config, n)(o, d, dead, hint), stable=True)
    assert torch.equal(perm, torch.arange(n))
    draws = pt.bounce_draws(2, 0, 1, pids, config)
    o2, d2, thr2, rad2, alive2, _ = pt.bounce_step(scene, config, o, d, thr, rad, dead, draws)
    for before, after in ((o, o2), (d, d2), (thr, thr2), (rad, rad2)):
        assert _bits_equal(after, before)
    assert not bool(alive2.any())


def test_torch_scan_device_scalars_equal_ints(tmp_path):
    """The first pixel, the seed (past 2^32) and the first sample as 0-d
    tensors give the Python ints' sums bit for bit, through the cached body
    and through the eager loop, on a chunk that starts mid-frame."""
    scene, config, _ = _case("cornell", tmp_path)
    want = pt.scan_accum(scene, 37, 2**32 + 9, 3, 256, 2, config, eager=True)
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = pt.scan_accum(scene, t(37), t(2**32 + 9), t(3), 256, 2, config)
    assert float(want.sum()) > 0
    assert _bits_equal(got, want)
    assert _bits_equal(pt.scan_accum(scene, 37, 9, 3, 256, 2, config), want)
    mixed = pt.render_chunk(scene, t(37), 9, t(3), 256, 2, config, eager=True)
    assert _bits_equal(mixed, want / 2)
    pt.clear_compiled_loops()


def test_torch_scan_body_serves_chunks_seeds_and_passes(tmp_path):
    """One cached scan body serves several chunks of a frame, two seeds,
    two passes and a moved camera, each frame equal to the eager loop's bit
    for bit; the scan engine still leaves ``stats`` untouched."""
    pt.clear_compiled_loops()
    scene, _, _ = _case("cornell", tmp_path)
    big = dataclasses.replace(scene, camera=scene.camera.with_dims(24, 24))  # 3 chunks of 256
    config = RenderConfig(compaction=False, rays_per_batch=256, spp_per_pass=1)
    moved = dataclasses.replace(big, camera=dataclasses.replace(
        big.camera, position=big.camera.position + torch.tensor([0.3, 0.0, 0.0])))
    for s, seed in ((big, 1), (big, 7), (moved, 7)):
        stats = {}
        want = pt.render(s, spp=2, seed=seed, config=config, eager=True)
        got = pt.render(s, spp=2, seed=seed, config=config, stats=stats)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert stats == {}
    (key,) = pt._GRAPHS
    assert "scan" in key
    pt.clear_compiled_loops()


def test_torch_mc_device_keys_equal_host_keys(tmp_path):
    """The Monte-Carlo sample body folds its keys on the device (the sample
    from a counter, one threefry over the jitter and bounce counters): its
    keys equal the host-int key chain, and its frame the eager loop's bit
    for bit, in one chunk and in chunks of 100 lanes (a padded tail), for
    two seeds through one cached body per lane count."""
    pt.clear_compiled_loops()
    scene = parse_homebrew_scene(_write(tmp_path, "mc", SCENES["mc"]))
    for s in (0, 3, 7):
        base = trng.key_words(2**32 + 5)
        k0, k1 = trng.fold_in(*trng.key_words(torch.tensor(2**32 + 5)), torch.tensor(s))
        f0, f1 = trng.fold_in(k0, k1, torch.tensor([trng.JITTER_DEPTH, 0, 1, 2]))
        k = trng.fold_in(*base, s)
        want = [trng.fold_in(*k, c) for c in (trng.JITTER_DEPTH, 0, 1, 2)]
        assert [(int(a), int(b)) for a, b in zip(f0, f1)] == want
    for config in (RenderConfig(), RenderConfig(rays_per_batch=100)):
        for seed in (3, 2**32 + 5):
            want = legacy.render_homebrew(scene, seed=seed, config=config, eager=True)
            got = legacy.render_homebrew(scene, seed=seed, config=config)
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
            assert np.isfinite(got).all() and got.max() > 0.5
    assert len(pt._GRAPHS) == 2 and all("mc" in key for key in pt._GRAPHS)
    pt.clear_compiled_loops()


@pytest.mark.parametrize("name", ["whitted", "flat"])
def test_torch_whitted_blocks_past_the_end_change_nothing(name, tmp_path, monkeypatch):
    """Once every stack is empty, more iterations of the Whitted search
    change no carry (``active`` is all false and every mask follows from
    it), so blocks of K iterations give the per-iteration loop's frame bit
    for bit, whatever K, over several chunks."""
    pt.clear_compiled_loops()
    scene = parse_homebrew_scene(_write(tmp_path, name, SCENES[name]))
    lights = legacy._filled_lights(scene)
    n = scene.camera.width * scene.camera.height
    pids = torch.arange(n, dtype=torch.int32)
    o, d = pt.gen_rays(scene.camera, pids, torch.full((2, n), 0.5))
    search = legacy._WhittedSearch(scene, lights, n, scene.ray_depth, 1e-4)
    c = search.start(o, d)
    steps = 0
    while bool(search.more(c)):
        c = search.iteration(c)
        steps += 1
    assert (steps > 1) == (scene.ray_depth > 1) and float(c["radiance"].sum()) > 0
    for _ in range(5):
        later = search.iteration(c)
        for key, value in c.items():
            assert _bits_equal(later[key], value) if value.is_floating_point() \
                else torch.equal(later[key], value), key
        c = later
    want = legacy.render_homebrew(scene, seed=0, config=RenderConfig(rays_per_batch=100),
                                  eager=True)
    for k in (1, 3, 16):
        monkeypatch.setattr(legacy, "WHITTED_ITERATIONS", k)
        legacy.render_homebrew.iterations = 0
        got = legacy.render_homebrew(scene, seed=0, config=RenderConfig(rays_per_batch=100))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k
        assert legacy.render_homebrew.iterations % k == 0
    pt.clear_compiled_loops()


def _watch_kernels(monkeypatch):
    for name in ("tile_chunk_activity", "run_items", "run_light_pdf", "nearest_box_ids",
                 "run_dense", "run_slots", "ray_group_bools"):
        monkeypatch.setattr(ci, name, _opaque(getattr(ci, name)))
    monkeypatch.setattr(trng, "lane_uniforms_key", _opaque(trng.lane_uniforms_key))


# The scan body's paths no case of SCAN_CASES takes: the other sort keys
# and intersector modes, on the sphere field (2,048 lanes, sorted).
BODY_CHANGES = {
    "field_dirhint": {"sort_key": "dirhint"},
    "field_cell": {"sort_key": "cell"},
    "field_twopass": {"tuning": IntersectTuning(mode="twopass")},
    "field_dense": {"tuning": IntersectTuning(mode="dense")},
}


@pytest.mark.parametrize("case", ["cornell", "sobol", "many_lights", "env_field",
                                  "field_target", *BODY_CHANGES])
def test_torch_scan_body_holds_no_host_traffic(case, tmp_path, monkeypatch):
    """After one warm-up sample, a sample of the scan body copies nothing
    from the host and reads nothing back outside the kernel wrappers, under
    every sort key and the intersector modes a graph holds."""
    _watch_kernels(monkeypatch)
    scene, config, n, _ = _scan_case(case if case in SCAN_CASES else "env_field", tmp_path)
    config = dataclasses.replace(config, **BODY_CHANGES.get(case, {}))
    scalars = pt._traced_scalars(scene.device, 0, 3, 0, 0, 0)
    body = pt._ScanSample(scene, config, n, scene.camera, scalars)
    c = body.step(body.start())
    watch = _HostWatch()
    with watch:
        body.step(c)
    assert watch.seen == []


@pytest.mark.parametrize("name", ["mc", "whitted", "flat"])
def test_torch_homebrew_bodies_hold_no_host_traffic(name, tmp_path, monkeypatch):
    """After one warm-up, a Monte-Carlo sample and a Whitted stack iteration
    copy nothing from the host and read nothing back outside the threefry
    wrapper."""
    _watch_kernels(monkeypatch)
    scene = parse_homebrew_scene(_write(tmp_path, name, SCENES[name]))
    n = scene.camera.width * scene.camera.height
    scalars = pt._traced_scalars(scene.device, 0, 3, 0, 0, 0)
    if name == "mc":
        body = legacy._MCSample(scene, n, 1e-4, scene.camera, scalars)
        step, c = body.step, body.start()
    else:
        body = legacy._WhittedSearch(scene, legacy._filled_lights(scene), n, scene.ray_depth,
                                     1e-4)
        pids = torch.arange(n, dtype=torch.int32)
        step, c = body.iteration, body.start(*pt.gen_rays(scene.camera, pids,
                                                           torch.full((2, n), 0.5)))
    c = step(c)
    watch = _HostWatch()
    with watch:
        step(c)
        if name != "mc":
            body.more(c)
    assert watch.seen == []


def test_torch_captured_block_without_flag_reads_nothing():
    """A ``CapturedBlock`` without ``more`` runs its iterations and reads
    nothing back: ``run`` returns None."""
    carries = {"x": torch.zeros(3), "n": torch.zeros((), dtype=torch.int64)}
    block = graph.CapturedBlock(lambda c: {"x": c["x"] + 1.0, "n": c["n"] + 1}, None, carries, 2)
    watch = _HostWatch()
    with watch:
        assert block.run() is None and block.run() is None
    assert watch.seen == []
    assert torch.equal(carries["x"], torch.full((3,), 4.0)) and int(carries["n"]) == 4


@pytest.mark.parametrize("engine", ["persistent", "scan", "sharded_scan", "mc", "whitted"])
def test_torch_capture_failure_is_not_retried(engine, tmp_path, monkeypatch, capsys):
    """A failed capture (``CaptureError``) propagates at once: neither
    ``render``'s nor ``render_pass_sharded``'s per-chunk retry takes it for
    a failed execution."""
    calls = []

    def fail(self):
        calls.append(1)
        raise graph.CaptureError("CUDA graph capture failed: test")

    monkeypatch.setattr(graph.CapturedBlock, "run", fail)
    config = RenderConfig(compaction=engine == "persistent", failure_retries=2)
    pt.clear_compiled_loops()
    with pytest.raises(graph.CaptureError):
        if engine in ("mc", "whitted"):
            scene = parse_homebrew_scene(_write(tmp_path, engine, SCENES[engine]))
            legacy.render_homebrew(scene, seed=0)
        else:
            scene, _, _ = _case("cornell", tmp_path)
            if engine == "sharded_scan":
                tmesh.render_pass_sharded(scene, 0, 1, 0, 256, 1, config, tmesh.make_mesh())
            else:
                pt.render(scene, spp=1, config=config)
    assert calls == [1]
    assert "retrying" not in capsys.readouterr().err
    pt.clear_compiled_loops()


def test_torch_body_cache_keys_engines_and_stays_bounded(tmp_path):
    """The compiled bodies share one cache keyed by engine name, static
    configuration and the scene's tensors (a ``PrimitiveScene``'s too, and
    their in-place writes): the same scene and lane count under two engines
    are two entries, and the cache keeps at most ``GRAPH_CACHE`` of them,
    dropping the oldest."""
    pt.clear_compiled_loops()
    scene, config, _ = _case("cornell", tmp_path)
    hb = parse_homebrew_scene(_write(tmp_path, "mc", SCENES["mc"]))
    key = lambda engine, s: pt._static_key(s, config, engine, 256)[0]
    assert key("scan", scene) != key("persistent", scene)
    before = key("mc", hb)
    assert key("mc", hb) == before != key("whitted", hb)
    hb.color.mul_(1.0)
    assert key("mc", hb) != before
    pt.scan_accum(scene, 0, 1, 0, 256, 1, config)
    pt.persistent_accum(scene, 0, 1, 0, 256, 256, config)
    legacy.render_homebrew(hb, seed=0)
    engine_of = lambda k: k[4]  # (device, tensors, plain fields, config, engine, ...)
    assert [engine_of(k) for k in pt._GRAPHS] == ["scan", "persistent", "mc"]
    for lanes in range(128, 128 + pt.GRAPH_CACHE):
        pt.scan_accum(scene, 0, 1, 0, lanes, 1, config)
    assert len(pt._GRAPHS) == pt.GRAPH_CACHE
    assert [engine_of(k) for k in pt._GRAPHS] == ["scan"] * pt.GRAPH_CACHE
    pt.clear_compiled_loops()
