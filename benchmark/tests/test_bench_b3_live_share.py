"""The reader ``b3_live_share.samples`` on planted span logs: the share of
B3's tile-level (ray, cluster) pairs whose ray enters the cluster's box,
summed over the untraced engine calls; nothing from a program that counts
no B3 pair (the K1 cells, or a program without the counts), without a span
log or without a traced part."""

import pytest

from benchmark import manifest
from benchmark.tests.test_bench_program_spans import _Ev, _log, _prof

NAME = "b3_live_share.samples"
_COUNTS = dict(lanes=512, ray_tile=512, chunks=1704, iterations=8, rays=300, b2_units=40,
               b1_tests=600)


def _ctx(monkeypatch, work, log=True, traced=True):
    """A traced window (events from 1,000 to 9,000 ns) holding one engine
    call, then one untraced call per entry of ``work``."""
    spans = _log([("engine_call", None, 2_000, 4_000, dict(_COUNTS, b3_pairs=10**9, b3_live=0))]
                 + [("engine_call", None, 20_000 + 3_000 * k, 22_000 + 3_000 * k,
                     dict(_COUNTS, **w)) for k, w in enumerate(work)])
    monkeypatch.setattr("benchmark.program_spans.program_log",
                        lambda: (spans, {}) if log else None)
    evs = [_Ev("aten::first", 1_000, 1_100), _Ev("aten::last", 8_900, 9_000)]
    ctx = dict(pixel_samples=1, trace=dict(prof=_prof(evs), iterations=8,
                                           summary=dict(by_name={})))
    if not traced:
        del ctx["trace"]
    return ctx


def test_bench_b3_live_share_hand_computed(monkeypatch):
    """Σ b3_live / Σ b3_pairs over the untraced calls only (the traced call's
    counts are left out), a call without the counts skipped."""
    work = [dict(b3_pairs=5_120, b3_live=300), dict(b3_pairs=2_560, b3_live=84), {}]
    got = manifest.reader(NAME)(_ctx(monkeypatch, work))
    assert got == pytest.approx((300 + 84) / (5_120 + 2_560))


@pytest.mark.parametrize("what", ["k1_cell", "uncounted", "no_log", "no_trace", "no_samples"])
def test_bench_b3_live_share_reports_nothing(monkeypatch, what):
    """A cell whose light pdf is K1 (every call counts 0 pairs), the parent
    program (no ``b3_*`` counts), no span log, no traced part, or a cell
    that counts no pixel-samples: no value."""
    work = {"k1_cell": [dict(b3_pairs=0, b3_live=0)] * 2, "uncounted": [{}, {}]}.get(
        what, [dict(b3_pairs=100, b3_live=5)])
    ctx = _ctx(monkeypatch, work, log=what != "no_log", traced=what != "no_trace")
    if what == "no_samples":
        ctx["pixel_samples"] = None
    assert manifest.reader(NAME)(ctx) is None


def test_bench_b3_live_share_in_the_lit_banner_cell_only():
    """Listed for ``litbanner.progressive``, the one cell that runs B3, on
    the light pdf's layer, moving the cell's pixel-samples per second."""
    bench = manifest.load()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    pdf = next(m for m in bench["per_layer"] if m["name"] == "light_pdf_ms_per_iteration.samples")
    assert entry["workloads"] == ["litbanner.progressive"]
    assert entry["layer"] == pdf["layer"] and entry["moves"] == "pixel_samples_per_s"
    assert (entry["unit"], entry["better"], entry["source"]) == ("share", "lower",
                                                                 "program_counter")
    assert NAME in {m["name"] for m in manifest.cell("litbanner.progressive")["per_layer"]}
    assert NAME not in {m["name"] for m in manifest.cell("atrium.progressive")["per_layer"]}
