"""Radiance HDR (.hdr / RGBE) codec of the port (its own copy of
``tpu_pathtracer/utils/hdr.py``).

The reference decodes environment maps through stb_image, whose 8-bit load
path converts RGBE to linear with ``f = ldexp(1, E - 136)`` (no half-texel
bias), then to u8 with gamma 1/2.2 (``u8 = clamp(int(pow(x, 1/2.2) * 255 +
0.5), 0, 255)``), alpha 255, and the renderer divides by 255.
``load_hdr_rgba_ldr`` reproduces that bottleneck so renders match the
reference's goldens; ``read_hdr`` gives the linear radiance; ``write_hdr``
writes flat (non-RLE) files for the fixtures.
"""

from __future__ import annotations

import re

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Decode a Radiance HDR file -> linear float32 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    # Header: lines until a blank line; then the resolution line.
    pos = data.index(b"\n") + 1
    fmt = None
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT="):
            fmt = line.split(b"=", 1)[1].strip()
    if fmt not in (None, b"32-bit_rle_rgbe"):
        raise ValueError(f"unsupported HDR format {fmt!r}")
    end = data.index(b"\n", pos)
    m = re.match(rb"-Y (\d+) \+X (\d+)", data[pos:end])
    if not m:
        raise ValueError(f"unsupported HDR orientation {data[pos:end]!r} (need '-Y H +X W')")
    h, w = int(m.group(1)), int(m.group(2))
    pos = end + 1

    rgbe = np.empty((h, w, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    for y in range(h):
        pos = _read_scanline(buf, pos, rgbe[y])
    return _rgbe_to_linear(rgbe)


def _read_scanline(buf: np.ndarray, pos: int, out: np.ndarray) -> int:
    """Decode one scanline (new-style RLE, old-style RLE, or flat) into
    ``out`` [W, 4]; returns the new buffer position."""
    w = out.shape[0]
    if (
        8 <= w <= 0x7FFF
        and buf[pos] == 2
        and buf[pos + 1] == 2
        and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == w
    ):
        # New-style: 4 per-component RLE streams.
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                n = int(buf[pos])
                if n > 128:  # run
                    out[x:x + n - 128, c] = buf[pos + 1]
                    x += n - 128
                    pos += 2
                else:  # literal
                    out[x:x + n, c] = buf[pos + 1:pos + 1 + n]
                    x += n
                    pos += 1 + n
        return pos
    # Flat scanline, possibly with old-style runs (1, 1, 1, count):
    # consecutive run records scale by 256 each.
    x = 0
    shift = 0
    while x < w:
        px = buf[pos:pos + 4]
        if px[0] == 1 and px[1] == 1 and px[2] == 1:
            count = int(px[3]) << shift
            out[x:x + count] = out[x - 1]
            x += count
            shift += 8
        else:
            out[x] = px
            x += 1
            shift = 0
        pos += 4
    return pos


def _rgbe_to_linear(rgbe: np.ndarray) -> np.ndarray:
    """stb_image's conversion: f = ldexp(1, E-136); rgb = bytes * f."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2((e - 136).astype(np.float32)), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def load_hdr_rgba_ldr(path: str) -> np.ndarray:
    """Decode .hdr the way the reference observes it: linear -> stb_image's
    default 8-bit LDR (gamma 1/2.2) -> /255, alpha = 1.  [H, W, 4] float32."""
    rgb = read_hdr(path)
    z = np.power(np.maximum(rgb, 0.0), 1.0 / 2.2) * 255.0 + 0.5
    u8 = np.clip(z, 0.0, 255.0).astype(np.uint8)
    out = np.empty(rgb.shape[:2] + (4,), dtype=np.float32)
    out[..., :3] = u8.astype(np.float32) / 255.0
    out[..., 3] = 1.0
    return out


def write_hdr(path: str, rgb: np.ndarray) -> str:
    """Encode linear float [H, W, 3] as flat (non-RLE) Radiance HDR."""
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w, _ = rgb.shape
    maxc = np.max(rgb, axis=-1)
    m, e = np.frexp(maxc)  # maxc = m * 2^e with m in [0.5, 1)
    scale = np.where(maxc > 1e-32, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    vals = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    nz = maxc > 1e-32
    rgbe[..., :3] = np.where(nz[..., None], vals, 0)
    rgbe[..., 3] = np.where(nz, (e + 128).astype(np.uint8), 0)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path
