"""Profiling hooks (port of ``tpu_pathtracer/utils/profiling.py``): the
program's span log, a wall-clock phase timer, and a ``torch.profiler``
trace of a render.

The span log.  ``with span(name, **counts) as s:`` around a piece of host
work records its name, an id, the id of the span open around it (its
parent, 0 for none), its start and end, and the counts the code attaches
(``s.add(rays=...)``).  Start and end are nanoseconds of the Unix epoch
(``time.time_ns``): the clock on which ``torch.profiler`` (kineto) stamps
the host's and the device's events, so a reader can lay the spans and a
profile's device operations on one axis and put each idle gap of the
device down to what the host was doing.  The end is the start plus the
span's duration on the monotonic clock (``time.perf_counter_ns``), so a
step of the wall clock does not reach a duration.  The log is a ring of
``RING`` records in memory, read with ``spans()``; nothing writes it out.

``stage(name)`` marks one stage of an iteration of the render loop.  It
does something only while a CUDA graph is captured (``stage_map``): it is
then a span of the log, and its boundaries read how many nodes the graph
holds, which gives the graph's stage map: the stage of each node, in
capture order.  A replay runs its nodes in that order on one stream, so
its i-th device operation is node i.  ``stage_maps()`` reads the maps,
which outlive the graphs.  Outside a capture (an eager loop, a replay) a
stage costs a flag test.

    with device_trace("/tmp/rt-trace"):  render(...)

writes ``/tmp/rt-trace/trace.json`` (a Chrome trace: open it in Perfetto or
``chrome://tracing``) with the host's operations and, on CUDA, the card's
kernels and copies.  Spans emit no ``torch.profiler`` range: a range shows
up on the device side as an event spanning its kernels, which a reader of
device busy time would count as work.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

RING = 1 << 20  # spans the log keeps; the oldest go first
_LOG: collections.deque = collections.deque(maxlen=RING)
_MAPS: collections.deque = collections.deque(maxlen=4096)
_OPEN: list = []  # the spans open now, innermost last
_LAST: Dict[str, "Span"] = {}  # the newest span of each name
_IDS = itertools.count(1)
_GRAPH_IDS = itertools.count(1)
_MAPPING: list = [None]  # the stage map being recorded, while a graph is captured


class Span:
    """One record of the log, and the context that opens and closes it."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counts", "_t0")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.id = self.parent = 0
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        self.id = next(_IDS)
        self.parent = _OPEN[-1].id if _OPEN else 0
        _OPEN.append(self)
        _LOG.append(self)
        _LAST[self.name] = self
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = self.start_ns + time.perf_counter_ns() - self._t0
        if _OPEN and _OPEN[-1] is self:
            _OPEN.pop()
        elif self in _OPEN:
            _OPEN.remove(self)
        return False

    def add(self, **counts) -> None:
        """Attach counts (numbers) to the span."""
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, **counts) -> Span:
    """A span of the log named ``name`` around the enclosed code."""
    return Span(name, counts)


def spans() -> List[Span]:
    """The log, oldest first (a span still open has ``end_ns`` None)."""
    return list(_LOG)


def last(name: str) -> Optional[Span]:
    """The newest span named ``name`` (None before the first), to attach a
    count its caller reads later (``last("engine_call").add(rays=n)``)."""
    return _LAST.get(name)


class _Stage(Span):
    __slots__ = ()

    def __enter__(self) -> Span:
        _MAPPING[0].enter(self.name)
        return Span.__enter__(self)

    def __exit__(self, *exc) -> bool:
        if _MAPPING[0] is not None:  # a failed capture may have ended it
            _MAPPING[0].exit()
        return Span.__exit__(self, *exc)


_NO_STAGE = contextlib.nullcontext()


def stage(name: str):
    """While a graph is captured, a span around one stage of the render
    loop and a boundary of the stage map; else a null context."""
    return _NO_STAGE if _MAPPING[0] is None else _Stage(name, {})


class StageMap:
    """The stage of every node of one captured CUDA graph: ``rows``, each
    (stage path, first node, last node) in capture order, the path the
    names of the stages open around the node from the outermost, joined by
    "/" ("loop/shading/intersector"), and "block" for the nodes outside
    every stage; ``nodes`` the graph's node count, ``graph`` its id."""

    def __init__(self, count_nodes: Callable[[], int]):
        self.graph = next(_GRAPH_IDS)
        self.rows: list = []
        self._count, self._path = count_nodes, []
        self.nodes = self._count()

    def _cut(self) -> None:
        n = self._count()
        if n > self.nodes:
            path = "/".join(self._path) or "block"
            if self.rows and self.rows[-1][0] == path:
                self.rows[-1] = (path, self.rows[-1][1], n - 1)
            else:
                self.rows.append((path, self.nodes, n - 1))
            self.nodes = n

    def enter(self, name: str) -> None:
        self._cut()
        self._path.append(name)

    def exit(self) -> None:
        self._cut()
        if self._path:
            self._path.pop()


@contextlib.contextmanager
def stage_map(count_nodes: Callable[[], int]) -> Iterator[StageMap]:
    """Record the stage map of the graph captured in the enclosed code;
    ``count_nodes()`` reads how many nodes it holds so far.  The map goes
    into the log's maps when the code returns."""
    m = StageMap(count_nodes)
    _MAPPING[0] = m
    try:
        yield m
        m._cut()
        m._count = None
        _MAPS.append(m)
    finally:
        _MAPPING[0] = None


def stage_maps() -> List[StageMap]:
    """Every stage map recorded, oldest first."""
    return list(_MAPS)


def card_line(fields=("name", "power.limit")) -> str:
    """The first card's ``fields``, as ``nvidia-smi --query-gpu=<fields>
    --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed code into ``log_dir/trace.json``; no log dir, no
    trace."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Wall-clock per-phase accumulator; each phase is a span of the log.
    The render loop waits at its host reads inside the phase that makes
    them; the device's own time per kernel comes from ``device_trace``."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        s = span(name)
        try:
            with s:
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + s.seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, stream=None) -> Dict[str, float]:
        """Print ``{"phases_seconds": {phase: seconds}}`` on ``stream``
        (default: the current ``sys.stderr``)."""
        out = {k: round(v, 4) for k, v in sorted(self.totals.items())}
        print(json.dumps({"phases_seconds": out}), file=stream or sys.stderr)
        return out
