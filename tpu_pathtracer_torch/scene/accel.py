"""Acceleration-structure build of the port: spatially ordered triangle runs
(its own copy of the functions of ``tpu_pathtracer/scene/accel.py`` that the
loader uses).

The build is a permutation of the triangle array whose consecutive runs form
the leaves (``LEAF_SIZE`` triangles) and the intersector's chunks (128).
Two orders: ``sah_chunk_order`` (default), chunk-aligned sweep-SAH
treelets emitted in DFS order, and ``morton_order``, the Morton curve of the
centroids.  Each function takes the native packer (``scene/native.py``)
first, unless ``TPU_PATHTRACER_NO_NATIVE`` is set, and otherwise its numpy
path; both give the same arrays, except that the native SAH order breaks
sort ties differently (a build of equal quality).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from . import native

LEAF_SIZE = 16


def _use_native() -> bool:
    return not os.environ.get("TPU_PATHTRACER_NO_NATIVE")


def morton_order(verts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Permutation sorting valid triangles along a 3D Morton curve of their
    centroids (invalid rows last).  verts: [N, 3, 3]."""
    if _use_native():
        perm = native.morton_argsort(verts, valid)
        if perm is not None:
            return perm
    n = verts.shape[0]
    centroid = verts.mean(axis=1)
    c = centroid[valid]
    if c.shape[0] == 0:
        return np.arange(n)
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    ext = np.maximum(hi - lo, 1e-30)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order_valid = np.argsort(code, kind="stable")
    idx_valid = np.nonzero(valid)[0][order_valid]
    idx_invalid = np.nonzero(~valid)[0]
    return np.concatenate([idx_valid, idx_invalid])


def sah_chunk_order(verts: np.ndarray, valid: np.ndarray, chunk: int = 128) -> np.ndarray:
    """Permutation whose consecutive ``chunk``-triangle runs are sweep-SAH
    treelet leaves (invalid rows last): at each node the triangles are
    sorted along the longest centroid axis and cut at the ``chunk``-aligned
    position of least SA_left*n_left + SA_right*n_right over the triangle
    AABBs, left child first.  Every chunk but the last is full, and
    consecutive chunks are spatial neighbours (the super-block gate and the
    front-to-back worklists rely on it)."""
    if _use_native():
        perm = native.sah_chunk_order(verts, valid, chunk)
        if perm is not None:
            return perm
    n = verts.shape[0]
    idx_valid = np.nonzero(valid)[0]
    m = idx_valid.shape[0]
    if m == 0:
        return np.arange(n)
    v = verts[idx_valid].astype(np.float32)
    # Per-triangle AABBs packed as [m, 6] = (min, -max), so one running
    # minimum gives both prefix bounds.
    tbox = np.concatenate([v.min(axis=1), -v.max(axis=1)], axis=1)
    cent = v.mean(axis=1)
    out = np.empty(m, dtype=np.int64)
    pos = 0
    stack = [np.arange(m)]  # explicit DFS stack, left child on top
    while stack:
        ids = stack.pop()
        k = ids.shape[0]
        if k <= chunk:
            out[pos:pos + k] = ids
            pos += k
            continue
        c_ids = cent[ids]
        lo = c_ids.min(axis=0)
        hi = c_ids.max(axis=0)
        axis = int(np.argmax(hi - lo))
        order = ids[np.argsort(c_ids[:, axis])]
        n_cuts = (k - 1) // chunk
        cuts = (np.arange(1, n_cuts + 1)) * chunk
        if n_cuts == 1:
            best = cuts[0]
        else:
            boxes = tbox[order]
            pre = np.minimum.accumulate(boxes, axis=0)
            suf = np.minimum.accumulate(boxes[::-1], axis=0)[::-1]

            def area(b):
                d = np.maximum(-b[:, 3:] - b[:, :3], 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(pre[cuts - 1]) * cuts + area(suf[cuts]) * (k - cuts)
            best = int(cuts[np.argmin(cost)])
        stack.append(order[best:])
        stack.append(order[:best])
    if pos != m:
        raise RuntimeError(f"sah_chunk_order emitted {pos} of {m} triangles")
    return np.concatenate([idx_valid[out], np.nonzero(~valid)[0]])


def build_leaves(
    verts: np.ndarray, valid: np.ndarray, leaf_size: int = LEAF_SIZE
) -> Tuple[np.ndarray, np.ndarray]:
    """Leaf AABBs over consecutive runs of ``leaf_size`` triangles of the
    ordered arrays (len % leaf_size == 0).  Returns (aabb_min [L, 3],
    aabb_max [L, 3]); leaves of padding only get inverted boxes."""
    if _use_native():
        out = native.build_leaf_aabbs(verts, valid, leaf_size)
        if out is not None:
            return out
    n = verts.shape[0]
    if n % leaf_size:
        raise ValueError(f"{n} triangles are not a multiple of the leaf size {leaf_size}")
    l = n // leaf_size
    v = verts.reshape(l, leaf_size, 3, 3)
    ok = valid.reshape(l, leaf_size)
    big = np.float64(np.inf)
    vmin = np.where(ok[:, :, None, None], v, big).min(axis=(1, 2))
    vmax = np.where(ok[:, :, None, None], v, -big).max(axis=(1, 2))
    empty = ~ok.any(axis=1)
    vmin[empty] = big
    vmax[empty] = -big
    return vmin.astype(np.float32), vmax.astype(np.float32)


def chunk_aabbs(
    aabb_min: np.ndarray, aabb_max: np.ndarray, leaves_per_chunk: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk AABBs over runs of ``leaves_per_chunk`` consecutive leaves.
    Chunks of padding only get NaN boxes, which fail every slab test (an
    inverted +inf/-inf box would pass it with the smallest entry and put
    padding at the front of every worklist)."""
    l = aabb_min.shape[0]
    pad = (-l) % leaves_per_chunk
    if pad:
        aabb_min = np.concatenate([aabb_min, np.full((pad, 3), np.inf, aabb_min.dtype)])
        aabb_max = np.concatenate([aabb_max, np.full((pad, 3), -np.inf, aabb_max.dtype)])
    c = aabb_min.shape[0] // leaves_per_chunk
    cmin = aabb_min.reshape(c, leaves_per_chunk, 3).min(axis=1)
    cmax = aabb_max.reshape(c, leaves_per_chunk, 3).max(axis=1)
    empty = cmin[:, 0] > cmax[:, 0]
    cmin[empty] = np.nan
    cmax[empty] = np.nan
    return cmin, cmax
