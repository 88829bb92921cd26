"""``BENCHMARK.json`` keeps to the benchmark's contract, and the harness
finds every configuration, traffic mix, entry, limit and per-layer reader
by the name the manifest gives it."""

import json
import os
import re

import pytest

from benchmark import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads", "layer", "moves"}


def test_bench_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_bench_manifest_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_bench_manifest_moves_and_layers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell]), (m["name"], cell)
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_bench_cell_files_found_by_name(cell):
    c = manifest.cell(cell)
    assert c["traffic"]["entry"] and callable(manifest.entry(c["traffic"]["entry"]))
    assert c["workload"]["chips"] == 1
    assert set(c["limits"]) >= {"pixels_off_share"}
    assert c["config"]["scene"]["generator"]
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_bench_metric_reader_found_by_name(metric):
    read = manifest.reader(metric)
    assert read({}) is None  # nothing to read: nothing returned
    assert read({"entry": "progressive", "trace": None}) is None
    assert read({"trace": {"iterations": 0, "summary": {"busy_s": 1.0, "by_name": {}}}}) is None


def test_bench_kernel_names():
    every = manifest.kernel_names()
    inter = manifest.kernel_names("intersect.")
    assert {"items_kernel", "activity_kernel", "slots_kernel", "dense_kernel",
            "ray_group_kernel"} <= set(inter) <= set(every)
    assert {"uniforms_kernel", "light_pdf_flat_kernel", "shade_gather_kernel"} <= set(every)


def test_bench_metric_readers_read_a_trace():
    from benchmark import profiling

    dev = [("(anonymous namespace)::items_kernel(float const*)", 0, 2_000_000),
           ("(anonymous namespace)::items_final_kernel(int)", 2_000_000, 2_500_000),
           ("void at::native::elementwise_kernel<128, 2>", 3_000_000, 4_000_000)]
    busy, merged = profiling.busy_union(dev)
    summary = dict(busy_s=busy, window_s=0.01, by_name=profiling.device_seconds_by_name(dev))
    ctx = dict(entry="sweep", iterations=10, pixel_samples=2e6, load_s=[0.5, 1.5],
               trace=dict(iterations=2, summary=summary), untraced=dict(wall_s=0.02, iterations=4))
    got = {m["name"]: manifest.reader(m["name"])(ctx) for m in BENCH["per_layer"]}
    assert got["intersect_ms_per_iteration.samples"] == pytest.approx(1.25)
    assert got["torch_ops_ms_per_iteration.samples"] == pytest.approx(0.5)
    assert got["device_ms_per_iteration.samples"] == pytest.approx(1.75)
    assert got["iterations_per_msample.samples"] == pytest.approx(5.0)
    assert got["device_idle_share.samples"] == pytest.approx(1 - 1.75 / 5.0)
    assert got["load_s_per_render.sweep"] == pytest.approx(1.0)
    assert got["device_idle_share.frame"] is None and got["iterations_per_frame.frame"] is None
    frames = dict(ctx, entry="rerender", frames=5, pixel_samples=None, load_s=None)
    got = {m["name"]: manifest.reader(m["name"])(frames) for m in BENCH["per_layer"]}
    assert got["iterations_per_frame.frame"] == pytest.approx(2.0)
    assert got["device_idle_share.frame"] == pytest.approx(1 - 1.75 / 5.0)
    assert got["device_idle_share.samples"] is None and got["load_s_per_render.sweep"] is None
    assert merged == [(0, 2_500_000), (3_000_000, 4_000_000)]


def test_bench_percentile_nearest_rank():
    from benchmark import profiling

    vals = list(range(1, 201))
    assert profiling.percentile(vals, 95) == 190 and profiling.percentile(vals, 50) == 100


def test_bench_manifest_json_files_parse():
    for sub in ("configs", "traffic", "limits"):
        d = os.path.join(manifest.HERE, sub)
        for fn in os.listdir(d):
            if fn.endswith(".json"):
                with open(os.path.join(d, fn)) as f:
                    json.load(f)
