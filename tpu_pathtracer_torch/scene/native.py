"""ctypes binding of the port's native (C++) accel packer,
``tpu_pathtracer_torch/csrc/accel_pack.cpp``.

The library is built with ``g++`` at first use into
``build/tpu_pathtracer_torch/libaccel_pack.so`` at the repository root (the
directory the CUDA kernels build into, git-ignored), and rebuilt when the
hash of its source and flags changes.  Each function returns None when the
library cannot be built or loaded; the callers in ``scene/accel.py`` and
``scene/gltf.py`` then take their numpy paths, which give the same arrays
(``tests/test_torch_host.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "tpu_pathtracer_torch", "csrc", "accel_pack.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "tpu_pathtracer_torch")
LIBRARY = os.path.join(BUILD_DIR, "libaccel_pack.so")
GXX_FLAGS = ["-O3", "-std=c++20", "-shared", "-fPIC"]


def build() -> bool:
    """Compile the packer unless an up-to-date build exists; False when g++
    fails or is missing.  The library is written under a temporary name and
    moved into place, so concurrent builders never load a partial file."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    stamp = LIBRARY + ".sha256"
    if os.path.exists(LIBRARY) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, LIBRARY)
    with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
        f.write(digest)
    os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
    return True


@functools.lru_cache(maxsize=None)
def load_library() -> Optional[ctypes.CDLL]:
    """The loaded packer (built first if needed), or None."""
    if not build():
        return None
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError:
        return None
    i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    for suffix, vp in (("", f64p), ("_f32", f32p)):
        getattr(lib, "morton_argsort" + suffix).argtypes = [vp, u8p, i64, i64p]
        getattr(lib, "build_woop" + suffix).argtypes = [vp, u8p, i64, f32p]
        getattr(lib, "build_leaf_aabbs" + suffix).argtypes = [vp, u8p, i64, i64, f32p, f32p]
        getattr(lib, "sah_chunk_order" + suffix).argtypes = [vp, u8p, i64, i64, i64p]
    return lib


def _verts_arg(lib, verts: np.ndarray, fn_name: str):
    """The f32 or f64 entry point for ``verts``'s dtype (no f32 -> f64
    conversion of large vertex arrays)."""
    if verts.dtype == np.float32:
        return getattr(lib, fn_name + "_f32"), np.ascontiguousarray(verts, dtype=np.float32)
    return getattr(lib, fn_name), np.ascontiguousarray(verts, dtype=np.float64)


def morton_argsort(verts: np.ndarray, valid: np.ndarray) -> Optional[np.ndarray]:
    lib = load_library()
    if lib is None:
        return None
    n = verts.shape[0]
    fn, v = _verts_arg(lib, verts, "morton_argsort")
    perm = np.empty(n, dtype=np.int64)
    fn(v, np.ascontiguousarray(valid, dtype=np.uint8), n, perm)
    return perm


def sah_chunk_order(verts: np.ndarray, valid: np.ndarray, chunk: int) -> Optional[np.ndarray]:
    """Native chunk-aligned sweep-SAH order (see ``accel.sah_chunk_order``).
    Tie order inside a sort differs from numpy's, so the permutation is not
    bit-equal to the numpy build; both are valid builds of equal quality."""
    lib = load_library()
    if lib is None:
        return None
    n = verts.shape[0]
    fn, v = _verts_arg(lib, verts, "sah_chunk_order")
    perm = np.empty(n, dtype=np.int64)
    fn(v, np.ascontiguousarray(valid, dtype=np.uint8), n, chunk, perm)
    return perm


def build_woop(verts: np.ndarray, valid: np.ndarray) -> Optional[np.ndarray]:
    lib = load_library()
    if lib is None:
        return None
    n = verts.shape[0]
    fn, v = _verts_arg(lib, verts, "build_woop")
    out = np.empty((4, 3 * n), dtype=np.float32)
    fn(v, np.ascontiguousarray(valid, dtype=np.uint8), n, out)
    return out


def build_leaf_aabbs(verts: np.ndarray, valid: np.ndarray, leaf_size: int):
    lib = load_library()
    if lib is None:
        return None
    n = verts.shape[0]
    fn, v = _verts_arg(lib, verts, "build_leaf_aabbs")
    out_min = np.empty((n // leaf_size, 3), dtype=np.float32)
    out_max = np.empty((n // leaf_size, 3), dtype=np.float32)
    fn(v, np.ascontiguousarray(valid, dtype=np.uint8), n, leaf_size, out_min, out_max)
    return out_min, out_max
