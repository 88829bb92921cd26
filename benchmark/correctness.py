"""How a run decides ``correct``: the pixels the program produced in the
window, sampled from the seed, against the plain reference's sums of the
same samples of the same pixels.

A pixel is off when some channel of its sum over its N samples differs from
the reference's by more than ``REL`` of (|reference| + ``FLOOR`` * N): a
sample here is the program's sample draw for draw, so rounding moves a sum
by about 1e-7 of itself, and a path that rounding sends another way moves
it by about one sample's radiance (1/N of the sum).  The number compared is
the share of sampled pixels that are off, held to the cell's limit
(``benchmark/limits/<cell>.json``).
"""

from __future__ import annotations

import sys

import numpy as np

REL = 1e-3
FLOOR = 1e-2


def off_share(program: np.ndarray, reference: np.ndarray, samples: int) -> float:
    """Share of pixels ([P, 3] sums over ``samples`` samples) that are off."""
    diff = np.abs(np.asarray(program, np.float64) - np.asarray(reference, np.float64))
    tol = REL * (np.abs(reference) + FLOOR * samples)
    off = ~(diff <= tol).all(axis=1)  # NaN counts as off
    return float(off.mean())


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each compared number beside its limit; a number
    above its limit, or missing, fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        passed = value is not None and np.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def report(checks: dict) -> None:
    """The compared numbers beside their limits, as the last lines of the
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
