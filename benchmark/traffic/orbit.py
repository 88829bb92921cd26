"""The viewer's camera path: a closed orbit of ``poses`` camera poses on an
ellipse, each looking across the hall.  Every seed walks the same poses,
from a start and in a direction drawn from the seed, so every seed renders
the same views in another order."""

from __future__ import annotations

import math

import numpy as np


def walk(params: dict, seed: int):
    """``pose(i)`` -> (eye, target, fov_x) of the seed's ``i``-th frame (any
    integer ``i``; warm-up frames take negative ones)."""
    n = int(params["poses"])
    rng = np.random.default_rng(seed)
    start = int(rng.integers(n))
    step = 1 if rng.random() < 0.5 else -1
    cx, cy, cz = (float(v) for v in params["center"])
    rx, rz = (float(v) for v in params["radius"])
    tx, tz = (float(v) for v in params["target_radius"])
    bob, ty, fov = float(params["bob"]), float(params["target_y"]), float(params["fov_x"])

    def pose(i: int):
        a = 2.0 * math.pi * ((start + step * i) % n) / n
        eye = (cx + rx * math.cos(a), cy + bob * math.sin(3.0 * a), cz + rz * math.sin(a))
        target = (cx - tx * math.cos(a), ty, cz - tz * math.sin(a))
        return eye, target, fov

    return pose
