"""Profiling hooks (port of ``tpu_pathtracer/utils/profiling.py``): a
wall-clock phase timer, and a ``torch.profiler`` trace of a render.

    with device_trace("/tmp/rt-trace"):  render(...)

writes ``/tmp/rt-trace/trace.json`` (a Chrome trace: open it in Perfetto or
``chrome://tracing``) with the host's operations and, on CUDA, the card's
kernels and copies.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, Iterator, Optional

import torch

_NULL = contextlib.nullcontext()
_LABELS = [False]


@contextlib.contextmanager
def label_stages() -> Iterator[None]:
    """Turn on ``stage``'s ranges for the enclosed code (a profile that splits
    the render loop's device work by stage)."""
    _LABELS[0] = True
    try:
        yield
    finally:
        _LABELS[0] = False


def stage(name: str):
    """A ``torch.profiler`` range named ``name`` around one stage of the
    render loop while ``label_stages`` is on, else a context that does
    nothing (a flag test: the loop pays no profiler call)."""
    return torch.profiler.record_function(name) if _LABELS[0] else _NULL


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
    """Wall-clock per-phase accumulator.  The render loop is eager, so a
    phase that launches device work also waits at its host reads; the
    device's own time per kernel comes from ``device_trace``."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def annotate(self, name: str):
        """Named region visible in the trace."""
        return torch.profiler.record_function(name)

    def report(self, stream=None) -> Dict[str, float]:
        """Print ``{"phases_seconds": {phase: seconds}}`` on ``stream``
        (default: the current ``sys.stderr``)."""
        out = {k: round(v, 4) for k, v in sorted(self.totals.items())}
        print(json.dumps({"phases_seconds": out}), file=stream or sys.stderr)
        return out
