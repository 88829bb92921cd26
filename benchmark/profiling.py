"""The benchmark's own arithmetic over a device trace and over frame times:
the union of the device's busy intervals, device time by operation name,
the idle gaps and what the host was doing in them, and percentiles over
every sample.  (A frozen copy of what the program's bench and profiler
scripts compute, with the busy share taken as the union of the intervals
over the traced window itself rather than a sum over another render.)
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Tuple


def percentile(values: Iterable[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of every value."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def events(prof) -> Tuple[list, list]:
    """(device events, host events) of a stopped ``torch.profiler`` run, each
    a list of (name, start ns, end ns): the device's kernels, copies and
    fills, and the host's operations and runtime calls, read from the raw
    results (no per-event Python objects of the profiler's own)."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        row = (ev.name(), start, start + ev.duration_ns())
        (dev if str(ev.device_type()).endswith("CUDA") else host).append(row)
    return dev, host


def busy_union(dev: List[tuple]) -> Tuple[float, List[Tuple[int, int]]]:
    """(seconds in which some device operation ran, the merged busy
    intervals in ns)."""
    spans = sorted((s, e) for _, s, e in dev if e > s)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e9, [(s, e) for s, e in merged]


def device_seconds_by_name(dev: List[tuple]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in dev:
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def _word(name: str) -> re.Pattern:
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(name) + r"(?![A-Za-z0-9_])")


def seconds_of(by_name: Dict[str, float], kernels: Iterable[str]) -> float:
    """Device seconds of the operations whose name holds one of ``kernels``
    as a whole identifier (``items_kernel`` is not ``items_final_kernel``)."""
    pats = [_word(k) for k in kernels]
    return sum(s for name, s in by_name.items() if any(p.search(name) for p in pats))


def idle_gaps(merged: List[Tuple[int, int]], host: List[tuple], window: Tuple[int, int],
              top: int = 10) -> List[list]:
    """The ``top`` longest idle gaps of the device inside ``window`` (ns), each
    named by the innermost host event that spans its midpoint: [[name,
    seconds], ...]."""
    lo, hi = window
    gaps, cur = [], lo
    for s, e in merged:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        inner: Optional[tuple] = None
        for name, hs, he in host:
            if hs <= mid <= he and (inner is None or hs >= inner[1]):
                inner = (name, hs)
        out.append([inner[0] if inner else "no host event", (e - s) / 1e9])
    return out


def summary(prof, wall_s: float, top: int = 10) -> dict:
    """Busy seconds, the traced wall ``wall_s``, device seconds by operation
    name and the breakdown of one traced window, or of several (``prof`` a
    list of stopped profiler runs, one after another: their busy time and
    device time add up, and their idle gaps are each one's own)."""
    dev, gaps = [], []
    for p in prof if isinstance(prof, list) else [prof]:
        d, host = events(p)
        _, merged = busy_union(d)
        starts = [s for _, s, _ in d + host]
        ends = [e for _, _, e in d + host]
        if starts:
            gaps += idle_gaps(merged, host, (min(starts), max(ends)), top)
        dev += d
    busy_s, _ = busy_union(dev)
    by_name = device_seconds_by_name(dev)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    return dict(
        busy_s=busy_s,
        window_s=wall_s,
        by_name=by_name,
        n_device_events=len(dev),
        breakdown=dict(device_ops=[[n[:160], s] for n, s in ops],
                       idle_gaps=[[n[:160], s] for n, s in gaps]),
    )
