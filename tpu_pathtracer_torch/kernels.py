"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
into ``build/tpu_pathtracer_torch/lib<name>.so`` at the repository root on
first use, and rebuilt when the hash of its source, the shared headers
(``csrc/*.cuh``) and the flags changes;
the libraries are loaded with ``ctypes`` and every launch goes to PyTorch's
current stream.  Nothing here runs at import time, so the module imports on
machines without CUDA.

The functions below check device, dtype, shape and contiguity, allocate the
outputs, launch, and raise when the launch reports a CUDA error.  The
dispatching wrappers with their plain twins and launch counters live in
``ops/chunk_intersect.py``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "tpu_pathtracer_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# Library name -> its C entry points (ctypes argument types).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARIES = {
    "chunk_kernels": {
        "tpt_activity": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
        "tpt_items": [_P] * 8 + [_I] * 7 + [_F] + [_P] * 4,
    },
    "light_sort_kernels": {
        "tpt_light_pdf": [_P] * 5 + [_I] * 5 + [_F] + [_P] * 3,
        "tpt_nearest": [_P, _P, _P, _I, _I, _F, _P, _P, _P],
    },
    "mode_kernels": {
        "tpt_dense": [_P] * 5 + [_I] * 5 + [_F] + [_P] * 4,
        "tpt_slots": [_P] * 7 + [_I] * 7 + [_F] + [_P] * 4,  # woop_t, idx, masks, offsets
        "tpt_ray_groups": [_P, _P, _P, _I, _I, _I, _F, _P, _P],
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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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
    _raise_on(rc, "activity")
    return m8, ent, sub


def items(rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub):
    """Launch B2 (contract: ``ops.chunk_intersect.run_items_plain``).  The
    kernel reads the triangle-major copy of ``chunk_woop`` ([Cpad, cw, 12],
    ``triangle_major``) and the unit prefix sum of ``item_unit_offsets``."""
    from .ops.chunk_intersect import item_unit_offsets

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
    _check_key_bound(min_dst, cap * group * cw, "items")
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(tmin0, "tmin0", torch.float32, (r,), dev)
    _check(tidx0, "tidx0", torch.int32, (r,), dev)
    _check(chunk_woop, "chunk_woop", torch.float32, (cpad, 12, cw), dev)
    _check(idx, "idx", torch.int32, (t_tiles, cap), dev)
    _check(counts, "counts", torch.int32, (t_tiles,), dev)
    _check(masks, "masks", torch.int32, (t_tiles, cap, n_words), dev)
    woop_t = triangle_major(chunk_woop)
    offsets = item_unit_offsets(counts, masks, group, n_sub)
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
    _raise_on(rc, "items")
    return t_out, tri_out


# Clusters per B3 block: a tile's worklist is cut into segments this long.
PDF_SEGMENT = 4


def light_pdf(rays, cluster_woop, cluster_k, idx, counts, min_dst):
    """Launch B3 (contract: ``ops.chunk_intersect.run_light_pdf_plain``).
    The kernel reads the triangle-major copy of ``cluster_woop`` ([C, cw, 12],
    ``triangle_major``) and writes per-segment partial sums to scratch
    [n_seg, R]."""
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
    _check(idx, "idx", torch.int32, (t_tiles, cap), dev)
    _check(counts, "counts", torch.int32, (t_tiles,), dev)
    woop_t = triangle_major(cluster_woop)
    partial = torch.empty((-(-cap // PDF_SEGMENT), r), dtype=torch.float32, device=dev)
    out = torch.empty((r,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library("light_sort_kernels").tpt_light_pdf(
            _ptr(rays), _ptr(woop_t), _ptr(cluster_k), _ptr(idx), _ptr(counts),
            r, cap, cw, ray_tile, PDF_SEGMENT, float(min_dst), _ptr(partial), _ptr(out),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "light_pdf")
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
    _raise_on(rc, "nearest")
    return t_out, id_out


def _check_key_bound(min_dst, n_keys, name):
    """B2, B5 and B6 order candidates by 64-bit keys whose high word is the bits
    of t: that orders like the floats only for t > 0 (t >= min_dst), and
    the low word must hold every triangle id or test-order index."""
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
    _raise_on(rc, "dense")
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
    _check_key_bound(min_dst, cap * group * cw, "slots")
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
    _raise_on(rc, "slots")
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
    _raise_on(rc, "ray_groups")
    return out
