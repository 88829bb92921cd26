"""Build and bind the hand-written CUDA kernels (``csrc/chunk_kernels.cu``).

The source is compiled by ``nvcc`` into ``build/tpu_pathtracer_torch/
libchunk_kernels.so`` at the repository root on first use, and rebuilt when
the hash of the source and flags changes; it is loaded with ``ctypes`` and
every launch goes to PyTorch's current stream.  Nothing here runs at import
time, so the module imports on machines without CUDA.

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

import torch

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "chunk_kernels.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "tpu_pathtracer_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> dict:
    """Compile the kernel library unless an up-to-date build exists.
    Returns {"path", "built", "seconds"}; the compiler's output (register and
    shared-memory use per kernel) is kept in ``nvcc.log`` beside it."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(BUILD_DIR, "libchunk_kernels.so")
    stamp = so + ".sha256"
    if os.path.exists(so) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return {"path": so, "built": False, "seconds": 0.0}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    with open(stamp, "w") as f:
        f.write(digest)
    return {"path": so, "built": True, "seconds": seconds}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_activity.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p, p, p, p]
    lib.tpt_activity.restype = i
    lib.tpt_items.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p, p, p]
    lib.tpt_items.restype = i
    return lib


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


def activity(rays, cmin, cmax, tbest, coarse_bits, min_dst, ray_tile, n_sub, want_sub):
    """Launch B1 (contract: ``ops.chunk_intersect.tile_chunk_activity_plain``)."""
    dev = rays.device
    r, c = rays.shape[0], cmin.shape[0]
    if r % ray_tile or ray_tile % n_sub or not 1 <= n_sub <= 8 or c == 0:
        raise ValueError(f"activity: R={r} ray_tile={ray_tile} n_sub={n_sub} C={c}")
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
        rc = library().tpt_activity(
            _ptr(rays), _ptr(cmin), _ptr(cmax), _ptr(tbest), _ptr(coarse_bits),
            nwords, r, c, ray_tile, n_sub, float(min_dst), _ptr(m8), _ptr(ent),
            _ptr(sub), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "activity")
    return m8, ent, sub


def items(rays, tmin0, tidx0, chunk_woop, idx, counts, masks, min_dst, group, n_sub):
    """Launch B2 (contract: ``ops.chunk_intersect.run_items_plain``)."""
    dev = rays.device
    r = rays.shape[0]
    t_tiles, cap = idx.shape
    n_words = masks.shape[2]
    cpad, _, cw = chunk_woop.shape
    ray_tile = r // t_tiles if t_tiles else 0
    if (t_tiles == 0 or r % t_tiles or ray_tile > 1024 or ray_tile % n_sub
            or cpad % group or n_words * 4 < group):
        raise ValueError(
            f"items: R={r} T={t_tiles} n_sub={n_sub} chunks={cpad} group={group} W={n_words}"
        )
    _check(rays, "rays", torch.float32, (r, 8), dev)
    _check(tmin0, "tmin0", torch.float32, (r,), dev)
    _check(tidx0, "tidx0", torch.int32, (r,), dev)
    _check(chunk_woop, "chunk_woop", torch.float32, (cpad, 12, cw), dev)
    _check(idx, "idx", torch.int32, (t_tiles, cap), dev)
    _check(counts, "counts", torch.int32, (t_tiles,), dev)
    _check(masks, "masks", torch.int32, (t_tiles, cap, n_words), dev)
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    tri_out = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = library().tpt_items(
            _ptr(rays), _ptr(tmin0), _ptr(tidx0), _ptr(chunk_woop), _ptr(idx),
            _ptr(counts), _ptr(masks), r, t_tiles, cap, n_words, group, n_sub, cw,
            float(min_dst), _ptr(t_out), _ptr(tri_out),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "items")
    return t_out, tri_out
