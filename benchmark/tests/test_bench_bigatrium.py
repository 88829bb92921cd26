"""The configuration ``bigatrium`` and the intersector's work readers.

The cell resolves; ``benchmark/rooflines.py`` gives the kernel table's B1
and B2 bounds at ``chip_smoke.py``'s timing shapes; the three readers
report nothing from a program that counts nothing, and the hand-computed
value on a synthetic span log; and the program's CPU path, on the atrium
cut to detail 0 with both large-scene switches forced (256-ray tiles past
0 chunks, the coarse gate from 0 blocks, recomputed under t from 1),
agrees with the plain reference within the ``correct`` rule, and fails it
with one chunk's Woop rows zeroed."""

import copy
import dataclasses

import pytest
import torch

from benchmark import manifest, rooflines
from benchmark.tests.test_bench_faults import _run
from benchmark.tests.test_bench_program_spans import _Ev, _log, _prof

NEW = ("b2_tests_per_ray.samples", "b2_roofline_share.samples", "b1_roofline_share.samples")


def test_bench_bigatrium_cell_resolves():
    cell = manifest.cell("bigatrium.progressive")
    assert cell["workload"]["chips"] == 1 and cell["traffic"]["entry"] == "progressive"
    assert cell["config"]["scene"]["args"] == {"detail": 5, "seed": 0, "light_strength": 60.0,
                                               "textured": True}
    atrium = manifest.cell("atrium.progressive")
    assert cell["config"]["render"] == atrium["config"]["render"]
    assert cell["traffic"] == atrium["traffic"] and cell["limits"] == atrium["limits"]
    assert [m["name"] for m in cell["end_to_end"]] == ["pixel_samples_per_s", "setup_s"]
    per_layer = [m["name"] for m in cell["per_layer"]]
    assert set(NEW) <= set(per_layer)
    assert {m["name"] for m in atrium["per_layer"]} <= set(per_layer)
    for name in ("envfield.sweep", "litbanner.progressive", "atrium.progressive"):
        assert set(NEW) <= {m["name"] for m in manifest.cell(name)["per_layer"]}


@pytest.mark.parametrize("kernel, n, ray_tile, bound_ms", [
    # chip_smoke.py's timing shapes (kernel table, PERF.md): B2 on the
    # atrium secondaries' residual worklist, 72,774 set bits; B1's initial
    # gated pass, 78,995,456 (ray, chunk) pairs in tiles of 512.
    ("b2", 72_774, None, 0.9801212121212122),
    ("b1", 78_995_456 // 512, 512, 0.07083930211202938),
])
def test_bench_rooflines_reproduce_the_kernel_table(kernel, n, ray_tile, bound_ms):
    if kernel == "b2":
        got = rooflines.b2_bound_s({"b2_units": n})
        assert rooflines.b2_unit()[1] == 64 * 128 * 55
    else:
        got = rooflines.b1_bound_s({"b1_tests": n, "ray_tile": ray_tile})
        assert rooflines.b1_test(512)[1] == 512 * 30
    assert got * 1e3 == pytest.approx(bound_ms, rel=0.01)


_KERNEL_S = {"(anonymous namespace)::items_kernel(float const*, int)": 2.0e-3,
             "(anonymous namespace)::items_final_kernel(float const*)": 0.1e-3,
             "(anonymous namespace)::activity_kernel(float const*, float const*)": 0.5e-3,
             "void at::native::elementwise_kernel<128, 2>()": 9.0e-3}
_COUNTS = dict(lanes=512, ray_tile=256, chunks=9624, iterations=8)


def _ctx(monkeypatch, counted=True, log=True):
    """A traced window (events from 1,000 to 9,000 ns) holding two engine
    calls, then two untraced calls; the program counted its work or not."""
    work = [dict(rays=300, b2_units=40, b1_tests=600), dict(rays=100, b2_units=60, b1_tests=400),
            dict(rays=50, b2_units=10, b1_tests=100), dict(rays=150, b2_units=20, b1_tests=100)]
    if not counted:
        work = [dict(rays=w["rays"]) for w in work]
    spans = _log([("engine_call", None, 2_000 + 3_000 * k, 4_000 + 3_000 * k,
                   dict(_COUNTS, **work[k])) for k in range(2)]
                 + [("engine_call", None, 20_000 + 3_000 * k, 22_000 + 3_000 * k,
                     dict(_COUNTS, **work[2 + k])) for k in range(2)])
    monkeypatch.setattr("benchmark.program_spans.program_log",
                        lambda: (spans, {}) if log else None)
    evs = [_Ev("aten::first", 1_000, 1_100), _Ev("aten::last", 8_900, 9_000)]
    trace = dict(prof=_prof(evs), iterations=8, summary=dict(by_name=dict(_KERNEL_S)))
    return dict(pixel_samples=1, trace=trace)


def test_bench_work_readers_hand_computed(monkeypatch):
    ctx = _ctx(monkeypatch)
    read = {name: manifest.reader(name)(ctx) for name in NEW}
    assert read["b2_tests_per_ray.samples"] == pytest.approx((10 + 20) * 8192 / (50 + 150))
    b2_least = (40 + 60) * 64 * 128 * 55 / 33.45e12
    assert read["b2_roofline_share.samples"] == pytest.approx(b2_least / 2.1e-3)
    b1_least = (600 + 400) * 256 * 30 / 33.45e12
    assert read["b1_roofline_share.samples"] == pytest.approx(b1_least / 0.5e-3)


@pytest.mark.parametrize("what", ["uncounted", "no_log", "no_trace", "other_kernels"])
def test_bench_work_readers_report_nothing_without_counts(monkeypatch, what):
    """A program that counts nothing (the parent of the counters), no span
    log, no traced part, or a trace without B1 and B2: no value."""
    ctx = _ctx(monkeypatch, counted=what != "uncounted", log=what != "no_log")
    if what == "no_trace":
        del ctx["trace"]
    if what == "other_kernels":
        ctx["trace"]["summary"]["by_name"] = {"void at::native::elementwise_kernel<128, 2>()": 1.0}
    read = {name: manifest.reader(name)(ctx) for name in NEW}
    if what in ("no_trace", "other_kernels"):
        assert read["b2_roofline_share.samples"] is None
        assert read["b1_roofline_share.samples"] is None
    else:
        assert read == dict.fromkeys(NEW)


def _small_cell(monkeypatch):
    """``bigatrium.progressive`` at 16x16 in passes of 2 spp on the atrium at
    detail 0 (2,606 triangles in 24 chunks), both large-scene switches
    forced through the intersector's environment knobs."""
    cell = copy.deepcopy(manifest.cell("bigatrium.progressive"))
    cell["config"]["scene"]["args"]["detail"] = 0
    cell["config"]["render"]["spp_per_pass"] = 2
    cell["traffic"].update(width=16, height=16, spp_per_pass=2, check_pixels=64)
    for env, value in (("TPU_PT_NARROW_TILE_CHUNKS", "0"), ("TPU_PT_SUPER_MIN", "0"),
                       ("TPU_PT_SUPER_TBOUND_MIN", "1")):
        monkeypatch.setenv(env, value)
    return cell


def test_bench_bigatrium_small_run_is_correct(monkeypatch):
    from tpu_pathtracer_torch.utils import profiling

    with profiling.span("test") as mark:
        assert _run(_small_cell(monkeypatch), 3000000019)["correct"] is True
    tiles = {s.counts["ray_tile"] for s in profiling.spans()
             if s.id > mark.id and s.name == "engine_call"}
    assert tiles == {256}  # the narrow tiles ran


def test_bench_bigatrium_fault_one_chunk_zeroed(monkeypatch):
    """A run whose scene has the Woop rows of the chunk most primary rays hit
    zeroed (its triangles never hit) comes out not correct."""
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.ops.intersect import closest_hit
    from tpu_pathtracer_torch.scene import gltf

    real = gltf.parse_gltf_scene

    def broken(path, aspect, config):
        scene = real(path, aspect, config)
        cam = scene.camera.with_dims(16, 16)
        pix = torch.arange(256, dtype=torch.int32)
        o, d = pt.gen_rays(cam, pix, torch.full((2, 256), 0.5))
        hit = closest_hit(o, d, scene.woop, 1e-4)
        chunk = int(torch.mode(hit.tri[hit.hit] // scene.chunk_woop.shape[2]).values)
        woop = scene.chunk_woop.clone()
        woop[chunk] = 0.0
        return dataclasses.replace(scene, chunk_woop=woop)

    monkeypatch.setattr(gltf, "parse_gltf_scene", broken)
    assert _run(_small_cell(monkeypatch), 3000000019)["correct"] is False
