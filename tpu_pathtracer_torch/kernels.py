"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
into ``build/tpu_pathtracer_torch/lib<name>.so`` at the repository root on
first use, and rebuilt when the hash of its source, the shared headers
(``csrc/*.cuh``) and the flags changes;
the libraries are loaded with ``ctypes`` and every launch goes to PyTorch's
current stream.  Nothing here runs at import time, so the module imports on
machines without CUDA.

The functions below check device, dtype, shape and contiguity, allocate the
outputs, launch, raise when the launch reports a CUDA error, and count the
launch in ``launches`` under the kernel's name in the kernel table (b1-b7,
rng, k1-k5).  The dispatching wrappers with their plain twins live in
``ops/chunk_intersect.py`` (B1-B7, K5), ``ops/rng.py`` (the threefry
draws), ``ops/intersect.py`` (K1, the flat light-cluster pdf) and
``models/pathtracer.py`` (K2, ``hit_info``'s row gather and texture fetch;
K3 and K4, the bounce's sampling / BSDF chain before and after the light
pdf); a twin counts nothing.  No launch makes a runtime call that a CUDA
graph capture refuses: B2's and B6's persistent grids (and B6's
shared-memory attribute) are set at their first launch and kept.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref

import numpy as np
import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "tpu_pathtracer_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# Launches of each kernel by its name in the kernel table, since the last
# ``launches.clear()``; a replayed CUDA graph adds the launches its capture
# recorded (``models.graph.CapturedBlock``).
launches: collections.Counter = collections.Counter()

# Library name -> its C entry points (ctypes argument types).
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
LIBRARIES = {
    "chunk_kernels": {
        "tpt_activity": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
        "tpt_items": [_P] * 8 + [_I] * 7 + [_F] + [_P] * 4,
        "tpt_worklist": [_P] * 4 + [_I] * 8 + [_P] * 10,
    },
    "light_sort_kernels": {
        "tpt_light_pdf": [_P] * 7 + [_I] * 5 + [_F] + [_P] * 4,
        "tpt_nearest": [_P, _P, _P, _I, _I, _F, _P, _P, _P],
    },
    "mode_kernels": {
        "tpt_dense": [_P] * 5 + [_I] * 5 + [_F] + [_P] * 4,
        "tpt_slots": [_P] * 7 + [_I] * 7 + [_F] + [_P] * 4,  # woop_t, idx, masks, offsets
        "tpt_ray_groups": [_P, _P, _P, _I, _I, _I, _F, _P, _P],
    },
    "rng_kernels": {
        # key words, then sample, depth, pixel: (array, device scalar, constant) each
        "tpt_uniforms": [_P, _P, _U, _U] + [_P, _P, _U] * 3 + [_I, _I, _P, _P],
    },
    "shade_kernels": {
        "tpt_light_pdf_flat": [_P] * 4 + [_I] * 3 + [_F, _F] + [_P, _P],
        "tpt_shade_gather": [_P] * 10 + [_I, _I] + [_P] * 3,
        "tpt_shade_sample": [_P] * 10 + [_I] + [_P] * 6 + [_I, _F, _F, _I] + [_P] * 5,
        "tpt_shade_finish": [_P] * 9 + [_F] * 4 + [_I, _I] + [_P] * 6,
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> dict:
    """Compile every kernel library that has no up-to-date build, one
    ``nvcc`` per source, all running at once.  Returns {name: {"path",
    "built", "seconds"}}; each compiler's output (register and shared-memory
    use per kernel) is kept in ``nvcc_<name>.log`` beside the library."""
    out, procs = {}, {}
    headers = b""
    for header in sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh")):
        with open(os.path.join(_CSRC, header), "rb") as f:
            headers += f.read()
    for name in LIBRARIES:
        src = os.path.join(_CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        stamp = so + ".sha256"
        if os.path.exists(so) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    out[name] = {"path": so, "built": False, "seconds": 0.0}
                    continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        procs[name] = (proc, time.perf_counter(), so, tmp, stamp, digest)
    failed = []
    for name, (proc, t0, so, tmp, stamp, digest) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"nvcc_{name}.log"), "w") as f:
            f.write(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{stderr[-4000:]}")
            continue
        os.replace(tmp, so)
        with open(stamp, "w") as f:
            f.write(digest)
        out[name] = {"path": so, "built": True, "seconds": seconds}
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def _libraries() -> dict:
    libs = {}
    for name, info in build().items():
        lib = ctypes.CDLL(info["path"])
        for fn, argtypes in LIBRARIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        libs[name] = lib
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (every library is built first if
    needed)."""
    return _libraries()[name]


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
        )


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launched(rc: int, name: str, kernel: str) -> None:
    """Raise when launch ``name`` reported a CUDA error, else count it in
    ``launches`` under ``kernel``, its name in the kernel table."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1


def made_once(cache: dict, key, x: torch.Tensor, make):
    """``make()``, a tensor derived from ``x``, computed once per source
    tensor: ``cache[key]`` holds (weak reference to ``x``, ``x``'s version,
    result); the entry goes when ``x`` does and is remade after an in-place
    write to ``x``."""
    hit = cache.get(key)
    if hit is not None and hit[0]() is x and hit[1] == x._version:
        return hit[2]
    out = make()
    cache[key] = (weakref.ref(x, lambda _, key=key: cache.pop(key, None)), x._version, out)
    return out


# Woop blocks [C, 12, cw] -> their triangle-major copies [C, cw, 12], keyed
# on the identity of the source tensor.
_TRIANGLE_MAJOR: dict = {}


def triangle_major(woop: torch.Tensor) -> torch.Tensor:
    """The triangle-major copy [C, cw, 12] of Woop blocks [C, 12, cw] (three
    float4 per triangle) that B2, B3 and B6 stage from, made once per tensor
    (``made_once``): a scene's ``chunk_woop`` / ``cluster_woop`` is copied at
    its first launch and found again at every later one."""
    return made_once(_TRIANGLE_MAJOR, id(woop), woop, lambda: woop.transpose(1, 2).contiguous())


def activity(rays, cmin, cmax, tbest, coarse_bits, min_dst, ray_tile, n_sub, want_sub):
    """Launch B1 (contract: ``ops.chunk_intersect.tile_chunk_activity_plain``).
    The kernel orders entry distances by their bits, so ``min_dst`` must not
    be negative."""
    dev = rays.device
    r, c = rays.shape[0], cmin.shape[0]
    if r % ray_tile or ray_tile % n_sub or not 1 <= n_sub <= 8 or c == 0 or not min_dst >= 0:
        raise ValueError(
            f"activity: R={r} ray_tile={ray_tile} n_sub={n_sub} C={c} min_dst={min_dst}"
        )
    t_tiles = r // ray_tile
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(cmin, "cmin", torch.float32, (c, 3), dev)
    _check(cmax, "cmax", torch.float32, (c, 3), dev)
    if tbest is not None:
        _check(tbest, "tbest", torch.float32, (r,), dev)
    nwords = 0
    if coarse_bits is not None:
        nwords = coarse_bits.shape[1]
        if nwords * 32 * 512 < c:
            raise ValueError(f"coarse_bits: {nwords} words cannot gate {c} columns")
        _check(coarse_bits, "coarse_bits", torch.int32, (t_tiles, nwords), dev)
    m8 = torch.empty((t_tiles, c), dtype=torch.int32, device=dev)
    ent = torch.empty((t_tiles, c), dtype=torch.float32, device=dev)
    sub = torch.empty((t_tiles, n_sub, c), dtype=torch.float32, device=dev) if want_sub else None
    with torch.cuda.device(dev):
        rc = library("chunk_kernels").tpt_activity(
            _ptr(rays), _ptr(cmin), _ptr(cmax), _ptr(tbest), _ptr(coarse_bits),
            nwords, r, c, ray_tile, n_sub, float(min_dst), _ptr(m8), _ptr(ent),
            _ptr(sub), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "activity", "b1")
    return m8, ent, sub


def items(rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub, offsets):
    """Launch B2 (contract: ``ops.chunk_intersect.run_items_plain``).  The
    kernel reads the triangle-major copy of ``chunk_woop`` ([Cpad, cw, 12],
    ``triangle_major``) and ``offsets``, the unit prefix sum of
    ``ops.chunk_intersect.item_unit_offsets``."""
    dev = rays.device
    r = rays.shape[0]
    t_tiles, cap = idx.shape
    n_words = masks.shape[2]
    cpad, _, cw = chunk_woop.shape
    ray_tile = r // t_tiles if t_tiles else 0
    if (t_tiles == 0 or r % t_tiles or ray_tile % n_sub or not 1 <= n_sub <= 8
            or cpad % group or n_words * 4 < group or cw % 4 or t_tiles * cap * group >= 2**31):
        raise ValueError(
            f"items: R={r} T={t_tiles} n_sub={n_sub} chunks={cpad} group={group} W={n_words} cw={cw}"
        )
    _check_key_bound(min_dst, cpad * cw, "items")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(tmin0, "tmin0", torch.float32, (r,), dev)
    _check(tidx0, "tidx0", torch.int32, (r,), dev)
    _check(chunk_woop, "chunk_woop", torch.float32, (cpad, 12, cw), dev)
    _check(idx, "idx", torch.int32, (t_tiles, cap), dev)
    _check(counts, "counts", torch.int32, (t_tiles,), dev)
    _check(masks, "masks", torch.int32, (t_tiles, cap, n_words), dev)
    woop_t = triangle_major(chunk_woop)
    _check(offsets, "offsets", torch.int32, (t_tiles * cap * group,), dev)
    keys = torch.empty((r,), dtype=torch.int64, device=dev)
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    tri_out = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library("chunk_kernels").tpt_items(
            _ptr(rays), _ptr(tmin0), _ptr(tidx0), _ptr(woop_t), _ptr(idx), _ptr(counts),
            _ptr(masks), _ptr(offsets), r, t_tiles, cap, n_words, group, n_sub, cw,
            float(min_dst), _ptr(keys), _ptr(t_out), _ptr(tri_out),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "items", "b2")
    return t_out, tri_out


# K5 sorts a tile's active groups in shared memory while a row of this many
# 64-bit keys (the group count rounded up to a power of two) fits; a longer
# row goes through global scratch.
WORKLIST_SMEM_KEYS = 2048


def worklist(m8, ent, tested, cap, group, n_sub, cbits, want_gate):
    """Launch K5 (contract: ``ops.chunk_intersect.worklist_pass_plain``):
    (ga, ge, idx, counts, masks, offsets, gate words or None), with this
    pass's groups set in ``tested`` in place.  ``m8`` holds ``n_sub`` bits
    a chunk and ``ent`` is finite wherever ``m8`` is set (B1's outputs)."""
    dev = m8.device
    t_tiles, c = m8.shape
    cg = c // group if 1 <= group <= 32 else 0
    n_gate = -(-c // (32 * 512))  # one bit per 512-chunk block
    if (t_tiles == 0 or cg == 0 or c % group or not 1 <= cap <= cg or not 1 <= n_sub <= 8
            or n_gate > 1024 or t_tiles * cap * group * n_sub >= 2**31):
        raise ValueError(f"worklist: T={t_tiles} chunks={c} group={group} cap={cap} n_sub={n_sub}")
    _check(m8, "m8", torch.int32, (t_tiles, c), dev)
    _check(ent, "ent", torch.float32, (t_tiles, c), dev)
    _check(tested, "tested", torch.bool, (t_tiles, cg), dev)
    if cbits is not None:
        _check(cbits, "cbits", torch.int32, (t_tiles, n_gate), dev)
    n_words = -(-group // 4)
    n_pad = 1 << (cg - 1).bit_length()
    scratch = None
    if n_pad > WORKLIST_SMEM_KEYS:
        scratch = torch.empty((t_tiles, n_pad), dtype=torch.int64, device=dev)
    status = torch.empty((t_tiles + 1,), dtype=torch.int64, device=dev)
    ga = torch.empty((t_tiles, cg), dtype=torch.bool, device=dev)
    ge = torch.empty((t_tiles, cg), dtype=torch.float32, device=dev)
    idx = torch.empty((t_tiles, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((t_tiles,), dtype=torch.int32, device=dev)
    masks = torch.empty((t_tiles, cap, n_words), dtype=torch.int32, device=dev)
    offsets = torch.empty((t_tiles * cap * group,), dtype=torch.int32, device=dev)
    gate = torch.empty((t_tiles, n_gate), dtype=torch.int32, device=dev) if want_gate else None
    with torch.cuda.device(dev):
        rc = library("chunk_kernels").tpt_worklist(
            _ptr(m8), _ptr(ent), _ptr(tested), _ptr(cbits), t_tiles, cg, group, cap, n_words,
            n_sub, n_gate, n_pad, _ptr(scratch), _ptr(status), _ptr(ga), _ptr(ge), _ptr(idx),
            _ptr(counts), _ptr(masks), _ptr(offsets), _ptr(gate),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "worklist", "k5")
    return ga, ge, idx, counts, masks, offsets, gate


# Clusters per B3 block: a tile's worklist is cut into segments this long
# (at most 32: one bit each of a ray's mask in the kernel).
PDF_SEGMENT = 4


def light_pdf(rays, cluster_woop, cluster_k, box_min, box_max, idx, counts, min_dst, work=None):
    """Launch B3 (contract: ``ops.chunk_intersect.run_light_pdf_plain``; the
    boxes: ``ops.chunk_intersect.light_pdf_entered_pairs_plain``).  The
    kernel reads the triangle-major copy of ``cluster_woop`` ([C, cw, 12],
    ``triangle_major``), tests only the (ray, cluster) pairs whose ray
    enters the cluster's box ``box_min`` / ``box_max`` ([C, 3], grown by
    ``BOX_SLACK``), and writes per-segment partial sums to scratch [n_seg,
    R].  ``work``: None, or a [2] int64 tensor on the device to which the
    launch adds its tile-level (ray, cluster) pairs and those whose ray
    enters the box."""
    dev = rays.device
    r = rays.shape[0]
    t_tiles, cap = idx.shape
    c, _, cw = cluster_woop.shape
    ray_tile = r // t_tiles if t_tiles else 0
    if t_tiles == 0 or r % t_tiles or ray_tile % 128 or c == 0 or cap == 0 or cw % 4:
        raise ValueError(f"light_pdf: R={r} T={t_tiles} clusters={c} cap={cap} cw={cw}")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(cluster_woop, "cluster_woop", torch.float32, (c, 12, cw), dev)
    _check(cluster_k, "cluster_k", torch.float32, (c, cw), dev)
    _check(box_min, "box_min", torch.float32, (c, 3), dev)
    _check(box_max, "box_max", torch.float32, (c, 3), dev)
    _check(idx, "idx", torch.int32, (t_tiles, cap), dev)
    _check(counts, "counts", torch.int32, (t_tiles,), dev)
    if work is not None:
        _check(work, "work", torch.int64, (2,), dev)
    woop_t = triangle_major(cluster_woop)
    partial = torch.empty((-(-cap // PDF_SEGMENT), r), dtype=torch.float32, device=dev)
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library("light_sort_kernels").tpt_light_pdf(
            _ptr(rays), _ptr(woop_t), _ptr(cluster_k), _ptr(box_min), _ptr(box_max), _ptr(idx),
            _ptr(counts), r, cap, cw, ray_tile, PDF_SEGMENT, float(min_dst), _ptr(partial),
            _ptr(out), _ptr(work), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "light_pdf", "b3")
    return out


def nearest(rays, box_min, box_max, min_dst):
    """Launch B4 (contract: ``ops.chunk_intersect.nearest_box_ids_plain``)."""
    dev = rays.device
    r, g = rays.shape[0], box_min.shape[0]
    if r == 0 or g == 0:
        raise ValueError(f"nearest: R={r} boxes={g}")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(box_min, "box_min", torch.float32, (g, 3), dev)
    _check(box_max, "box_max", torch.float32, (g, 3), dev)
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    id_out = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library("light_sort_kernels").tpt_nearest(
            _ptr(rays), _ptr(box_min), _ptr(box_max), r, g, float(min_dst),
            _ptr(t_out), _ptr(id_out), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "nearest", "b4")
    return t_out, id_out


def _check_key_bound(min_dst, n_keys, name):
    """B2, B5 and B6 order candidates by 64-bit keys whose high word is the bits
    of t: that orders like the floats only for t > 0 (t >= min_dst), and
    the low word must hold every triangle id."""
    if not min_dst > 0 or n_keys >= 2**31:
        raise ValueError(f"{name}: needs min_dst > 0 and < 2^31 keys (min_dst={min_dst}, keys={n_keys})")


def dense(rays, tmin0, tidx0, chunk_woop, bits, min_dst):
    """Launch B5 (contract: ``ops.chunk_intersect.run_dense_plain``)."""
    dev = rays.device
    r = rays.shape[0]
    t_tiles, nwords = bits.shape
    c, _, cw = chunk_woop.shape
    ray_tile = r // t_tiles if t_tiles else 0
    if t_tiles == 0 or r % t_tiles or ray_tile > 1024 or c == 0 or nwords * 32 < c:
        raise ValueError(f"dense: R={r} T={t_tiles} chunks={c} words={nwords}")
    _check_key_bound(min_dst, c * cw, "dense")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(tmin0, "tmin0", torch.float32, (r,), dev)
    _check(tidx0, "tidx0", torch.int32, (r,), dev)
    _check(chunk_woop, "chunk_woop", torch.float32, (c, 12, cw), dev)
    _check(bits, "bits", torch.int32, (t_tiles, nwords), dev)
    keys = torch.empty((r,), dtype=torch.int64, device=dev)
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    tri_out = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library("mode_kernels").tpt_dense(
            _ptr(rays), _ptr(tmin0), _ptr(tidx0), _ptr(chunk_woop), _ptr(bits), r, t_tiles,
            c, nwords, cw, float(min_dst), _ptr(keys), _ptr(t_out), _ptr(tri_out),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "dense", "b5")
    return t_out, tri_out


# B6 stages two groups of ``group`` chunks at once: what a block may hold.
_SLOTS_SMEM_BYTES = 227 * 1024 - 128


def slots(rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub):
    """Launch B6 (contract: ``ops.chunk_intersect.run_slots_plain``).  The
    kernel reads the triangle-major copy of ``chunk_woop`` ([Cpad, cw, 12],
    ``triangle_major``) and the unit prefix sum of ``slot_unit_offsets``."""
    from .ops.chunk_intersect import slot_unit_offsets

    dev = rays.device
    r = rays.shape[0]
    t_tiles, cap = idx.shape
    n_words = masks.shape[2]
    cpad, _, cw = chunk_woop.shape
    ray_tile = r // t_tiles if t_tiles else 0
    if (t_tiles == 0 or r % t_tiles or ray_tile % n_sub or not 1 <= n_sub <= 8
            or cpad % group or n_words * 4 < group or group > 32 or cw % 4
            or 2 * group * cw * 48 > _SLOTS_SMEM_BYTES or t_tiles * cap * 8 * group >= 2**31):
        raise ValueError(
            f"slots: R={r} T={t_tiles} n_sub={n_sub} chunks={cpad} group={group} W={n_words} cw={cw}"
        )
    _check_key_bound(min_dst, cpad * cw, "slots")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(tmin0, "tmin0", torch.float32, (r,), dev)
    _check(tidx0, "tidx0", torch.int32, (r,), dev)
    _check(chunk_woop, "chunk_woop", torch.float32, (cpad, 12, cw), dev)
    _check(idx, "idx", torch.int32, (t_tiles, cap), dev)
    _check(counts, "counts", torch.int32, (t_tiles,), dev)
    _check(masks, "masks", torch.int32, (t_tiles, cap, n_words), dev)
    woop_t = triangle_major(chunk_woop)
    offsets = slot_unit_offsets(counts, masks, group, n_sub)
    keys = torch.empty((r,), dtype=torch.int64, device=dev)
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    tri_out = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library("mode_kernels").tpt_slots(
            _ptr(rays), _ptr(tmin0), _ptr(tidx0), _ptr(woop_t), _ptr(idx), _ptr(masks),
            _ptr(offsets), r, t_tiles, cap, n_words, group, n_sub, cw, float(min_dst),
            _ptr(keys), _ptr(t_out), _ptr(tri_out), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "slots", "b6")
    return t_out, tri_out


def ray_groups(rays, cmin, cmax, min_dst, group):
    """Launch B7 (contract: ``ops.chunk_intersect.ray_group_bools_plain``)."""
    dev = rays.device
    r, c = rays.shape[0], cmin.shape[0]
    if r == 0 or c == 0 or c % 512 or not 1 <= group <= 32 or 512 % group:
        raise ValueError(f"ray_groups: R={r} chunks={c} group={group}")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(cmin, "cmin", torch.float32, (c, 3), dev)
    _check(cmax, "cmax", torch.float32, (c, 3), dev)
    out = torch.empty((c // group, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library("mode_kernels").tpt_ray_groups(
            _ptr(rays), _ptr(cmin), _ptr(cmax), r, c // group, group, float(min_dst),
            _ptr(out), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "ray_groups", "b7")
    return out


def _stream_word(x, name: str, device, lanes, base=0):
    """One input of the threefry stream, ``x + base``, as the kernel takes it:
    (int32 [R] array or None, int64 device scalar or None, u32 constant).  A
    Python int is a constant; a 0-d tensor is read on the device at run
    time, so a captured launch follows its value; an [R] tensor is a
    per-lane array (only ``x`` may be one).  Nothing is computed on the
    device unless two 0-d tensors must be summed or a tensor cast."""
    array, scalar, constant = None, None, 0
    for v, per_lane in ((x, lanes is not None), (base, False)):
        if not isinstance(v, torch.Tensor):
            constant += int(v)
            continue
        if v.device != device:
            raise ValueError(f"{name}: on {v.device}, want {device}")
        if v.dim() == 0:
            v = v if v.dtype == torch.int64 else v.to(torch.int64)
            scalar = v if scalar is None else scalar + v
        elif per_lane and tuple(v.shape) == (lanes,) and v.dtype in (torch.int32, torch.int64):
            array = (v if v.dtype == torch.int32 else v.to(torch.int32)).contiguous()
        else:
            raise ValueError(f"{name}: want an int, a 0-d tensor" + (f" or int [{lanes}]" if
                             per_lane else "") + f", got {v.dtype} {tuple(v.shape)}")
    return array, scalar, constant & 0xFFFFFFFF


def uniforms(k0, k1, sample, depth, pixel, n_draws: int, sample_base=0, pixel_base=0):
    """Launch the threefry draws (contract: ``ops.rng.lane_uniforms_key_plain``):
    [n_draws, R] float32 for the key words (k0, k1) and per-lane (sample +
    sample_base, depth, pixel + pixel_base).  Each input is a Python int, a
    0-d integer tensor on the card (read by the kernel) or, for sample,
    depth and pixel, an [R] integer tensor (its low 32 bits); a base is an
    int or a 0-d tensor."""
    dev = pixel.device
    if pixel.dim() != 1:
        raise ValueError(f"pixel: want [R], got {tuple(pixel.shape)}")
    r = pixel.shape[0]
    words = [_stream_word(k0, "k0", dev, None), _stream_word(k1, "k1", dev, None),
             _stream_word(sample, "sample", dev, r, sample_base),
             _stream_word(depth, "depth", dev, r),
             _stream_word(pixel, "pixel", dev, r, pixel_base)]
    out = torch.empty((n_draws, r), dtype=torch.float32, device=dev)
    (_, k0_s, k0_c), (_, k1_s, k1_c) = words[:2]
    lanes = []
    for array, scalar, constant in words[2:]:
        lanes += [_ptr(array), _ptr(scalar), constant]
    with torch.cuda.device(dev):
        rc = library("rng_kernels").tpt_uniforms(
            _ptr(k0_s), _ptr(k1_s), k0_c, k1_c, *lanes, r, n_draws, _ptr(out),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "uniforms", "rng")
    return out


# K1 stages every light of its clusters in shared memory: at most this many,
# in at most FLAT_CLUSTERS clusters.
FLAT_LIGHTS, FLAT_CLUSTERS = 512, 4


def light_pdf_flat(origin, direction, cluster_woop, cluster_k, light_count: int, min_dst):
    """Launch K1 (contract: ``ops.intersect.light_pdf_sum_flat``): the [R]
    all-hits light pdf over at most 4 clusters, already divided by the
    light count (as the twin does on the card: a product with the count's
    float32 reciprocal)."""
    dev = origin.device
    r = origin.shape[0]
    c, _, cw = cluster_woop.shape
    if not 0 < c <= FLAT_CLUSTERS or cw % 32 or c * cw > FLAT_LIGHTS:
        raise ValueError(f"light_pdf_flat: clusters={c} cw={cw} (want 1-{FLAT_CLUSTERS} "
                         f"clusters, cw % 32 == 0, at most {FLAT_LIGHTS} lights)")
    _check(origin, "origin", torch.float32, (r, 3), dev)
    _check(direction, "direction", torch.float32, (r, 3), dev)
    _check(cluster_woop, "cluster_woop", torch.float32, (c, 12, cw), dev)
    _check(cluster_k, "cluster_k", torch.float32, (c, cw), dev)
    inv_count = float(np.float32(1.0) / np.float32(max(int(light_count), 1)))
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library("shade_kernels").tpt_light_pdf_flat(
            _ptr(origin), _ptr(direction), _ptr(cluster_woop), _ptr(cluster_k), r, c, cw,
            float(min_dst), inv_count, _ptr(out), torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "light_pdf_flat", "k1")
    return out


def _check_atlas(atlas, dev) -> None:
    k = atlas.offset.shape[0]
    _check(atlas.texels, "texels", torch.float32, (atlas.texels.shape[0], 4), dev)
    if atlas.quad is not None:
        _check(atlas.quad, "quad", torch.float32, (atlas.texels.shape[0], 16), dev)
    for name in ("offset", "width", "height"):
        _check(getattr(atlas, name), name, torch.int32, (k,), dev)


def shade_gather(shade_attrs, tri, beta, gamma, direction, atlas, slots: int):
    """Launch K2 (contract: ``models.pathtracer.hit_info_plain``): the hit
    record [R, 16] (normal 3, shading normal 3, color 4, emission 3,
    metallic, roughness, ior) and inside [R] bool.  ``slots``: bit k set
    when texture slot k (color, emissive, metallic-roughness, normal) is
    fetched; ``atlas`` a ``scene.types.TextureAtlas`` (its quad pool used
    when it has one)."""
    dev = direction.device
    r = direction.shape[0]
    n = shade_attrs.shape[0]
    if not 0 <= slots < 16 or n == 0:
        raise ValueError(f"shade_gather: slots={slots} rows={n}")
    _check(shade_attrs, "shade_attrs", torch.float32, (n, 48), dev)
    _check(tri, "tri", torch.int32, (r,), dev)
    _check(beta, "beta", torch.float32, (r,), dev)
    _check(gamma, "gamma", torch.float32, (r,), dev)
    _check(direction, "direction", torch.float32, (r, 3), dev)
    _check_atlas(atlas, dev)
    record = torch.empty((r, 16), dtype=torch.float32, device=dev)
    inside = torch.empty((r,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = library("shade_kernels").tpt_shade_gather(
            _ptr(shade_attrs), _ptr(tri), _ptr(beta), _ptr(gamma), _ptr(direction),
            _ptr(atlas.texels), _ptr(atlas.quad), _ptr(atlas.offset), _ptr(atlas.width),
            _ptr(atlas.height), r, slots, _ptr(record), _ptr(inside),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "shade_gather", "k2")
    return record, inside


def shade_sample(origin, direction, throughput, radiance, alive, draws, t, hit, record,
                 light_verts, light_count: int, bg_color, atlas, env_tex: int,
                 vndf_factor: float, min_roughness: float):
    """Launch K3 (contract: ``models.pathtracer.shade_sample_plain``): (pos,
    new_dir, radiance) [R, 3] each and flags [R, 2] bool (shade,
    passthrough).  ``light_verts`` [L, 9] or None (a light set with no
    rows); ``env_tex`` the environment map's atlas id, or -1 for
    ``bg_color``."""
    dev = direction.device
    r = direction.shape[0]
    n_draws = draws.shape[0]
    for name, x in (("origin", origin), ("direction", direction), ("throughput", throughput),
                    ("radiance", radiance)):
        _check(x, name, torch.float32, (r, 3), dev)
    _check(alive, "alive", torch.bool, (r,), dev)
    _check(draws, "draws", torch.float32, (n_draws, r), dev)
    if n_draws != 10:
        raise ValueError(f"shade_sample: want 10 draws a ray, got {n_draws}")
    _check(t, "t", torch.float32, (r,), dev)
    _check(hit, "hit", torch.bool, (r,), dev)
    _check(record, "record", torch.float32, (r, 16), dev)
    if light_verts is not None:
        _check(light_verts, "light_verts", torch.float32, (light_verts.shape[0], 9), dev)
        if not 0 <= light_count <= light_verts.shape[0]:
            raise ValueError(f"shade_sample: {light_count} lights in {light_verts.shape[0]} rows")
    _check(bg_color, "bg_color", torch.float32, (3,), dev)
    _check_atlas(atlas, dev)
    if not -1 <= env_tex < atlas.offset.shape[0]:
        raise ValueError(f"shade_sample: env_tex={env_tex}")
    pos = torch.empty((r, 3), dtype=torch.float32, device=dev)
    new_dir = torch.empty((r, 3), dtype=torch.float32, device=dev)
    rad = torch.empty((r, 3), dtype=torch.float32, device=dev)
    flags = torch.empty((r, 2), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = library("shade_kernels").tpt_shade_sample(
            _ptr(origin), _ptr(direction), _ptr(throughput), _ptr(radiance), _ptr(alive),
            _ptr(draws), _ptr(t), _ptr(hit), _ptr(record), _ptr(light_verts), int(light_count),
            _ptr(bg_color), _ptr(atlas.texels), _ptr(atlas.quad), _ptr(atlas.offset),
            _ptr(atlas.width), _ptr(atlas.height), int(env_tex), float(vndf_factor),
            float(min_roughness), r, _ptr(pos), _ptr(new_dir), _ptr(rad), _ptr(flags),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "shade_sample", "k3")
    return pos, new_dir, rad, flags


def shade_finish(origin, direction, throughput, tri, record, pos, new_dir, flags, p_light,
                 vndf_factor: float, eps: float, min_roughness: float, chunk_tris: int):
    """Launch K4 (contract: ``models.pathtracer.shade_finish_plain``): (o, d,
    throughput) [R, 3] each, moved [R] bool and the sort hint [R] int32.
    ``p_light`` [R], or None where the mixture is the cosine lobe alone (no
    light rows, or no light).  The blend's second weight is ``1 -
    vndf_factor`` in double, then rounded, as the twin's Python scalar."""
    dev = direction.device
    r = direction.shape[0]
    for name, x in (("origin", origin), ("direction", direction), ("throughput", throughput),
                    ("pos", pos), ("new_dir", new_dir)):
        _check(x, name, torch.float32, (r, 3), dev)
    _check(tri, "tri", torch.int32, (r,), dev)
    _check(record, "record", torch.float32, (r, 16), dev)
    _check(flags, "flags", torch.bool, (r, 2), dev)
    if p_light is not None:
        _check(p_light, "p_light", torch.float32, (r,), dev)
    if chunk_tris <= 0:
        raise ValueError(f"shade_finish: chunk_tris={chunk_tris}")
    o = torch.empty((r, 3), dtype=torch.float32, device=dev)
    d = torch.empty((r, 3), dtype=torch.float32, device=dev)
    thr = torch.empty((r, 3), dtype=torch.float32, device=dev)
    moved = torch.empty((r,), dtype=torch.bool, device=dev)
    hint = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library("shade_kernels").tpt_shade_finish(
            _ptr(origin), _ptr(direction), _ptr(throughput), _ptr(tri), _ptr(record), _ptr(pos),
            _ptr(new_dir), _ptr(flags), _ptr(p_light), float(vndf_factor),
            1.0 - float(vndf_factor), float(eps), float(min_roughness), int(chunk_tris), r,
            _ptr(o), _ptr(d), _ptr(thr), _ptr(moved), _ptr(hint),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched(rc, "shade_finish", "k4")
    return o, d, thr, moved, hint
