"""The least time the intersector's kernels B1 and B2 could take for the
work the program counts, and their share of it inside a traced window.

The program counts, on the device, every ``engine_call`` of the persistent
loop: ``b2_units``, B2's units (one set sub-tile bit of a worklist item:
64 rays against one chunk's 128 triangles), and ``b1_tests``, B1's (tile,
chunk) slab tests that its coarse gate lets through (``ray_tile`` rays
against one box), each from the worklists and gates the tensor code
builds.  A unit's or a test's bound is the larger of its bytes over the
H100's 3.35 TB/s and its lane operations over the float32 peak, 33.45 T
a second (132 SMs x 128 lanes x 1.98 GHz; the kernels are built with
--fmad=false, so each add, multiply, compare, select and NaN-propagating
min/max is one operation).  Only what a test has to do is counted: each
Woop row and ray read once, the Woop or slab arithmetic; so the bound is a
lower bound, and a share of it cannot pass 1.  The operation counts are
the kernel table's (``chip_smoke.py``: ``WOOP_OPS``, ``SLAB_OPS``), and
these functions give its bounds at that script's timing shapes.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from benchmark import profiling
from benchmark import program_spans as ps
from benchmark.metrics_common import traced

HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.45e12
WOOP_OPS = 55  # a (ray, triangle) Woop test and its running minimum
SLAB_OPS = 30  # a (ray, box) slab test, its tests and the entry minimum
UNIT_RAYS = 64
CHUNK_TRIS = 128
B2_UNIT_PAIRS = UNIT_RAYS * CHUNK_TRIS  # Woop tests of a B2 unit
RAY_BYTES = 32  # a packed ray (o, 1, d, 0)

# Device operations of each kernel by name (``benchmark/kernel_names/``).
B2_KERNELS = ("items_kernel", "items_final_kernel")
B1_KERNELS = ("activity_kernel",)


def b2_unit() -> tuple:
    """(bytes, lane operations) of one B2 unit: the chunk's 12 Woop rows of
    128 triangles and the unit's 64 rays read, 8,192 Woop tests."""
    return 12 * CHUNK_TRIS * 4 + UNIT_RAYS * RAY_BYTES, B2_UNIT_PAIRS * WOOP_OPS


def b1_test(ray_tile: int) -> tuple:
    """(bytes, lane operations) of one B1 test: the box read, the tile's
    activity bits and entry written, ``ray_tile`` slab tests."""
    return 6 * 4 + 8, ray_tile * SLAB_OPS


def bound_s(n: float, work: tuple) -> float:
    """Seconds ``n`` pieces of ``work`` (bytes, lane operations) take at the
    least."""
    n_bytes, ops = work
    return n * max(n_bytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S)


def b2_bound_s(counts: dict) -> float:
    """B2's least seconds for an engine call's counts."""
    return bound_s(counts["b2_units"], b2_unit())


def b1_bound_s(counts: dict) -> float:
    """B1's least seconds for an engine call's counts: every test at the
    call's ``ray_tile`` (the geometry's; B1 over light clusters runs at 512
    rays, never fewer than that, so the bound stays a lower bound)."""
    return bound_s(counts["b1_tests"], b1_test(counts["ray_tile"]))


def traced_calls(ctx: dict) -> Optional[list]:
    """The program's closed ``engine_call`` spans that overlap a profile of
    the traced part (each profile holds whole calls), or None without a log
    or a traced part."""
    log, profs = ps.program_log(), ps.profiles(ctx)
    windows = [w for w in map(ps.window, profs) if w]
    if log is None or not windows:
        return None
    return [s for s in log[0] if s.name == "engine_call" and s.end_ns
            and any(s.start_ns < hi and s.end_ns > lo for lo, hi in windows)]


def share(ctx: dict, kernels: Iterable[str], bound: Callable[[dict], float],
          keys: tuple) -> Optional[float]:
    """The kernels' least seconds for the work the traced calls counted,
    over their device seconds by name in the traced part; None where a
    traced call lacks a count in ``keys`` (a program that counts nothing)
    or the kernels did not run."""
    tr, calls = traced(ctx), traced_calls(ctx)
    if not tr or not calls or not all(set(keys) <= set(c.counts) for c in calls):
        return None
    device_s = profiling.seconds_of(tr["summary"]["by_name"], kernels)
    least = sum(bound(c.counts) for c in calls)
    return least / device_s if device_s > 0 and least > 0 else None
