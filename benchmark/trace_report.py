"""One traced run of a cell, read against the program's span log: where the
device's time and its idle time go.

    python3 -m benchmark.trace_report --workload <cell> --seed <n> --seconds <s>

Runs the cell's entry as ``benchmark.run --trace 1`` does and prints one
JSON line: the per-layer metrics; the graph replays
seen and those whose device operation count equals their stage map's node
count; device ms per iteration of the traced part by stage of the map
(``shade``, ``intersect_glue``, ``intersect_kernels``, ``lane``, ``draws``,
``hit_info``, ``light_pdf``, ``loop``, ``block``), the operations outside
every replay, and their sum against the busy time; and the device's idle
time inside the traced part by the program's innermost span, with the
idle under no span at the traced part's edges (the benchmark's own
callbacks) apart from the rest, and the longest idle stretches by span
beside the benchmark's own longest gaps, named by host event.
Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time


def report(cell: dict, ctx: dict) -> dict:
    from benchmark import program_spans as ps
    from benchmark import run

    tr = ctx["trace"]
    t = time.perf_counter()
    out = dict(cell=cell["name"], iterations=tr["iterations"], metrics=run.per_layer(cell, ctx))
    out["readers_s"] = time.perf_counter() - t  # every per-layer reader, the new ones included
    busy_ms = tr["summary"]["busy_s"] * 1e3 / tr["iterations"]
    launches = sum(name == "cudaGraphLaunch" for prof in ps.profiles(ctx)
                   for _, _, _, name in ps.events(prof)[1])
    out["replays"] = launches
    ops = ps.replay_ops(ctx)
    out["replays_matching_their_map"] = launches if ops else 0
    if ops:
        by = collections.Counter()
        for path, rows in ops.items():
            for name, ns in rows:
                by[ps.stage_class(path.split("/"), name)] += ns / 1e6 / tr["iterations"]
        all_ms = sum(tr["summary"]["by_name"].values()) * 1e3 / tr["iterations"]
        by["outside_replays"] = all_ms - sum(by.values())
        out["stage_ms_per_iteration"] = dict(sorted(by.items(), key=lambda kv: -kv[1]))
        out["stages_sum_over_busy"] = sum(by.values()) / busy_ms
    out["busy_ms_per_iteration"] = busy_ms
    segs = ps.idle_segments(ctx) or []
    idle = sum(ns for ns, _, _ in segs)
    by_span = collections.Counter()
    for ns, chain, _ in segs:
        by_span["/".join(chain) or "(no span)"] += ns
    # The traced part's edges outside every span: the benchmark's callbacks
    # that start and stop the profiler.
    spans, edges = ps.program_log()[0], 0
    for lo, hi in (ps.window(p) for p in ps.profiles(ctx)):
        inside = [s for s in spans if s.end_ns and s.end_ns > lo and s.start_ns < hi]
        if inside:
            edges += max(0, min(s.start_ns for s in inside) - lo)
            edges += max(0, hi - max(s.end_ns for s in inside))
    out["idle_ms"] = idle / 1e6
    out["idle_ms_by_span"] = {k: v / 1e6 for k, v in by_span.most_common()}
    callbacks = min(by_span["(no span)"], edges)
    out["idle_ms_at_edges_no_span"] = callbacks / 1e6
    out["idle_share_under_a_span_outside_edges"] = (
        (idle - by_span["(no span)"]) / (idle - callbacks) if idle > callbacks else None)
    longest = sorted(segs, key=lambda s: -s[0])[:10]
    out["longest_idle"] = [[inner.name if inner else "(no span)", ns / 1e6]
                           for ns, _, inner in longest]
    out["benchmark_idle_gaps"] = tr["summary"]["breakdown"]["idle_gaps"]
    # The untraced part's host time by span (names from the outermost, three
    # deep), and outside every outermost span.
    end = max(w[1] for w in map(ps.window, ps.profiles(ctx)))
    by_id = {s.id: s for s in spans}
    later = [s for s in spans if s.end_ns and s.start_ns > end]
    host = collections.Counter()
    for s in later:
        chain, p = [s.name], by_id.get(s.parent)
        while p is not None:
            chain.append(p.name)
            p = by_id.get(p.parent)
        if len(chain) <= 3:
            host["/".join(reversed(chain))] += s.end_ns - s.start_ns
    tops = [s for s in later if by_id.get(s.parent) is None or by_id[s.parent].start_ns <= end]
    if tops:
        wall = max(s.end_ns for s in later) - min(s.start_ns for s in later)
        out["untraced_wall_ms"] = wall / 1e6
        out["untraced_ms_outside_spans"] = (wall - sum(s.end_ns - s.start_ns for s in tops)) / 1e6
        out["untraced_ms_by_span"] = {k: v / 1e6 for k, v in host.most_common(24)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.trace_report")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch

    from benchmark import correctness, manifest, profiling

    if not torch.cuda.is_available():
        print("benchmark.trace_report: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    device = torch.device("cuda", 0)
    res = manifest.entry(cell["traffic"]["entry"])(cell, args.seed, args.seconds, True, device, t0)
    ctx = res["ctx"]
    ctx["trace"]["summary"] = profiling.summary(ctx["trace"]["prof"], ctx["trace"]["wall_s"])
    out = report(cell, ctx)
    out["correct"], out["checks"] = correctness.judge(res["numbers"], cell["limits"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
