"""The program's own span log joined to a traced window: the arithmetic of
the per-layer metrics that read it.

The log (``tpu_pathtracer_torch.utils.profiling``: ``spans()``, each with
a name, an id, its parent's id, start and end in ns of the Unix epoch, the
clock of the profiler's events, and counts; ``stage_maps()``, the stage of
every node of each captured CUDA graph) lives in the run's own process.  A
program without it gives None here, and the readers report nothing.

The traced part of a run is its profiles (``ctx["trace"]["prof"]``, one or
a list); its untraced part, the program's spans that start after the
traced part's last event (the reference check after the window runs no
code of the program, so the log ends with the window).
"""

from __future__ import annotations

import bisect
import functools
from typing import Dict, List, Optional, Tuple

from benchmark import manifest, profiling

# Stages of an iteration (``utils.profiling.stage`` names on a node's path).
LANE = ("sort", "spawn", "add_rows", "regenerate")


def stage_class(parts, name: str) -> str:
    """The class of a replayed device operation ``name`` of the stage path
    ``parts``: "intersect_kernels" (a hand-written kernel of the
    ``intersector`` stage) or "intersect_glue" (its other operations);
    "hit_info", "light_pdf", "draws"; "lane" (``LANE``); "shade" (the rest
    of ``shading``); else the path itself ("loop", the iteration's own
    glue, or "block", the nodes outside every stage)."""
    if "intersector" in parts:
        return "intersect_kernels" if hand_written(name) else "intersect_glue"
    for key in ("hit_info", "light_pdf", "draws"):
        if key in parts:
            return key
    if any(p in parts for p in LANE):
        return "lane"
    if "shading" in parts:
        return "shade"
    return "/".join(parts)


def program_log() -> Optional[tuple]:
    """(spans, {graph id: stage map}) of the program's log, or None."""
    try:
        from tpu_pathtracer_torch.utils import profiling as program

        return program.spans(), {m.graph: m for m in program.stage_maps()}
    except (ImportError, AttributeError):
        return None


def profiles(ctx: dict) -> list:
    tr = ctx.get("trace")
    if not tr or "prof" not in tr:
        return []
    return tr["prof"] if isinstance(tr["prof"], list) else [tr["prof"]]


_EVENTS: Dict[int, tuple] = {}


def _read(prof) -> tuple:
    """(device operations, host events, (first start, last end) or None) of
    a stopped profile, each event (start ns, end ns, correlation id, name),
    by start; read once a profile."""
    hit = _EVENTS.get(id(prof))
    if hit is None or hit[0] is not prof:
        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns()
            row = (s, s + ev.duration_ns(), ev.correlation_id(), ev.name())
            (dev if str(ev.device_type()).endswith("CUDA") else host).append(row)
        dev.sort()
        host.sort()
        rows = dev + host
        span = (min(r[0] for r in rows), max(r[1] for r in rows)) if rows else None
        hit = _EVENTS[id(prof)] = (prof, dev, host, span)
    return hit[1:]


def events(prof) -> Tuple[list, list]:
    """(device operations, host events) of a stopped profile."""
    return _read(prof)[:2]


def window(prof) -> Optional[Tuple[int, int]]:
    """(first start, last end) of a profile's events."""
    return _read(prof)[2]


def untraced_spans(ctx: dict, name: str) -> Optional[list]:
    """The closed spans named ``name`` of the untraced part, or None (no log
    or no traced part)."""
    log, profs = program_log(), profiles(ctx)
    ends = [w[1] for w in map(window, profs) if w]
    if log is None or not ends:
        return None
    return [s for s in log[0] if s.name == name and s.end_ns and s.start_ns > max(ends)]


_REPLAYS: Dict[tuple, tuple] = {}  # each traced part's replay_ops, worked out once


def replay_ops(ctx: dict) -> Optional[Dict[str, list]]:
    """{stage path: [(operation name, device ns), ...]} over every graph
    replay of the traced part: a replay's device operations are those of
    its ``cudaGraphLaunch``'s correlation id, by start, and the i-th is node
    i of the stage map of the engine call around the launch.  None where
    there is no log or no replay, or where a replay's operation count
    differs from its map's node count (nothing is guessed)."""
    log, profs = program_log(), profiles(ctx)
    if log is None or not profs:
        return None
    key = tuple(map(id, profs))
    hit = _REPLAYS.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], profs)):
        hit = _REPLAYS[key] = (list(profs), _split_replays(profs, *log))
    return hit[1]


def _split_replays(profs: list, spans: list, maps: dict) -> Optional[Dict[str, list]]:
    calls = sorted((s.start_ns, s.end_ns, s.counts["graph"]) for s in spans
                   if s.name == "engine_call" and s.end_ns and "graph" in s.counts)
    starts = [c[0] for c in calls]
    out: Dict[str, list] = {}
    replays = 0
    for prof in profs:
        dev, host = events(prof)
        by_corr: Dict[int, list] = {}
        for s, e, cid, name in dev:
            by_corr.setdefault(cid, []).append((name, e - s))
        for s, _, cid, name in host:
            if name != "cudaGraphLaunch":
                continue
            k = bisect.bisect_right(starts, s) - 1
            smap = maps.get(calls[k][2]) if k >= 0 and calls[k][1] >= s else None
            ops = by_corr.get(cid, [])
            if smap is None or len(ops) != smap.nodes:
                return None
            replays += 1
            for path, first, last in smap.rows:
                out.setdefault(path, []).extend(ops[first:last + 1])
    return out if replays else None


def stage_ms(ctx: dict, cls: str) -> Optional[float]:
    """Device ms per iteration of the traced part (``persistent_accum``'s
    count, as ``device_ms_per_iteration.samples``) of the replayed
    operations of ``stage_class`` ``cls``; None where ``replay_ops`` is or
    where there is none."""
    tr, ops = ctx.get("trace"), replay_ops(ctx)
    if not ops or not tr or not tr.get("iterations"):
        return None
    ns = sum(d for path, rows in ops.items() for name, d in rows
             if stage_class(path.split("/"), name) == cls)
    return ns / 1e6 / tr["iterations"] if ns > 0 else None


@functools.lru_cache(maxsize=None)
def hand_written(name: str) -> bool:
    """Whether a device operation is a hand-written kernel (a name in
    ``benchmark/kernel_names/``)."""
    return profiling.seconds_of({name: 1.0}, manifest.kernel_names()) > 0


def idle_segments(ctx: dict) -> Optional[List[tuple]]:
    """Every idle stretch of the device inside the traced part, cut where
    the program's innermost open span changes: [(ns, the chain of span
    names open over it from the outermost, or () for none, the innermost
    span)].  None without a log or a traced part."""
    log, profs = program_log(), profiles(ctx)
    if log is None or not profs:
        return None
    spans = [s for s in log[0] if s.end_ns]
    out = []
    for prof in profs:
        w = window(prof)
        if w is None:
            continue
        lo, hi = w
        _, merged = profiling.busy_union([(n, s, e) for s, e, _, n in events(prof)[0]])
        idle, cur = [], lo
        for s, e in merged:
            if s > cur:
                idle.append((cur, min(s, hi)))
            cur = max(cur, e)
        if hi > cur:
            idle.append((cur, hi))
        # Boundaries of the spans that touch the window: the innermost open
        # span is constant between two of them.
        inside = sorted((s for s in spans if s.end_ns > lo and s.start_ns < hi),
                        key=lambda s: (s.start_ns, -s.end_ns))
        marks = sorted({lo, hi} | {t for s in inside for t in (s.start_ns, s.end_ns)
                                   if lo < t < hi})
        owner = []  # (segment start, chain, innermost span)
        k, stack = 0, []
        for a in marks[:-1]:
            stack = [s for s in stack if s.end_ns > a]
            while k < len(inside) and inside[k].start_ns <= a:
                if inside[k].end_ns > a:
                    stack.append(inside[k])
                k += 1
            owner.append((a, tuple(s.name for s in stack), stack[-1] if stack else None))
        starts = [o[0] for o in owner]
        for a, b in idle:
            j = bisect.bisect_right(starts, a) - 1
            while a < b and j < len(owner):
                end = owner[j + 1][0] if j + 1 < len(owner) else hi
                cut = min(b, end)
                if cut > a:
                    out.append((cut - a, owner[j][1], owner[j][2]))
                a, j = cut, j + 1
    return out


def _busy_in(merged: List[Tuple[int, int]], starts: List[int], a: int, b: int) -> int:
    """ns of the merged busy intervals (``starts`` their starts) inside [a, b]."""
    k, ns = max(bisect.bisect_right(starts, a) - 1, 0), 0
    while k < len(merged) and merged[k][0] < b:
        ns += max(0, min(b, merged[k][1]) - max(a, merged[k][0]))
        k += 1
    return ns


def _outside_captures(call, caps) -> Tuple[list, int]:
    """(the captures inside engine call ``call``, its iterations less
    theirs)."""
    inner = [c for c in caps if call.start_ns <= c.start_ns and c.end_ns <= call.end_ns]
    return inner, call.counts["iterations"] - sum(c.counts.get("iterations", 0) for c in inner)


def _work(spans: list) -> Dict[int, tuple]:
    """{engine call's id: (``start``, ``samples``) of the ``chunk_pass``
    around it}: the pixels and the sample count of the call's work."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        if s.name != "engine_call":
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != "chunk_pass":
            p = by_id.get(p.parent)
        if p is not None and "start" in p.counts and "samples" in p.counts:
            out[s.id] = (p.counts["start"], p.counts["samples"])
    return out


def replay_gap_ms(ctx: dict) -> Optional[float]:
    """Device-idle ms per iteration inside the engine calls, outside their
    captures (the host read a block, the launches between replays, the
    call's start): the calls' wall per iteration in the untraced part less
    the device's busy time per iteration inside the traced part's calls of
    the same work, the same pixels at the same sample count (the
    ``chunk_pass`` around the call); each work's difference weighted by its
    traced iterations.  The profiler stretches the host's side of a traced
    call several times over (its buffer requests, a graph launch it
    instruments), so the wall is read where it does not run, as
    ``device_idle_share`` reads it.  None where no untraced call does the
    work of a traced one."""
    log, profs = program_log(), profiles(ctx)
    windows = [w for w in map(window, profs) if w]
    if log is None or not windows:
        return None
    spans = [s for s in log[0] if s.end_ns]
    calls = [s for s in spans if s.name == "engine_call" and "iterations" in s.counts]
    caps = [s for s in spans if s.name == "capture"]
    work = _work(spans)
    traced: Dict[tuple, list] = {}  # work -> [busy ns, iterations]
    for prof, (lo, hi) in zip(profs, windows):
        _, merged = profiling.busy_union([(n, s, e) for s, e, _, n in events(prof)[0]])
        starts = [m[0] for m in merged]
        for c in calls:
            if c.start_ns < hi and c.end_ns > lo and c.id in work:
                inner, iterations = _outside_captures(c, caps)
                t = traced.setdefault(work[c.id], [0, 0])
                t[0] += _busy_in(merged, starts, c.start_ns, c.end_ns) - sum(
                    _busy_in(merged, starts, x.start_ns, x.end_ns) for x in inner)
                t[1] += iterations
    untraced: Dict[tuple, list] = {}  # work -> [wall ns, iterations]
    end = max(w[1] for w in windows)
    for c in calls:
        if c.start_ns > end and work.get(c.id) in traced:
            inner, iterations = _outside_captures(c, caps)
            u = untraced.setdefault(work[c.id], [0, 0])
            u[0] += c.end_ns - c.start_ns - sum(x.end_ns - x.start_ns for x in inner)
            u[1] += iterations
    gap = weight = 0.0
    for key, (busy, iterations) in traced.items():
        wall, later = untraced.get(key, (0, 0))
        if busy > 0 and iterations > 0 and later > 0:
            gap += (wall / later - busy / iterations) * iterations
            weight += iterations
    return gap / weight / 1e6 if weight else None
