"""Tone mapping and PPM (P6) I/O (port of ``tpu_pathtracer/utils/image.py``).

ACES + gamma 2.2 + round-half-up quantization as in ``Image::convert_color``
(src/image.h:51-82), applied once to the HDR frame.
"""

from __future__ import annotations

import io
from typing import Tuple, Union

import numpy as np
import torch

from .profiling import span

GAMMA = 2.2  # src/image.h:49


def aces_tonemap(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic fit, componentwise (src/image.h:51-59)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def tone_map(x: torch.Tensor) -> torch.Tensor:
    """ACES followed by gamma 1/2.2 (src/image.h:61-64)."""
    return torch.pow(aces_tonemap(x), 1.0 / GAMMA)


def quantize_u8(hdr: torch.Tensor) -> torch.Tensor:
    """Tone map an HDR [..., 3] image and quantize to uint8 with
    floor(x + 0.5), std::round's behaviour on these values."""
    x = torch.clamp(tone_map(hdr) * 255.0, 0.0, 255.0)
    return torch.floor(x + 0.5).to(torch.uint8)


def write_ppm(dst: Union[str, io.BufferedIOBase], pixels_u8: np.ndarray) -> None:
    """Binary P6 PPM: header then raw RGB bytes (src/image.h:34-38).  A
    ``write`` span of the log."""
    pixels_u8 = np.asarray(pixels_u8, dtype=np.uint8)
    h, w, c = pixels_u8.shape
    if c != 3:
        raise ValueError("PPM requires RGB")
    header = f"P6\n{w} {h}\n255\n".encode("ascii")
    with span("write"):
        if isinstance(dst, str):
            with open(dst, "wb") as f:
                f.write(header)
                f.write(pixels_u8.tobytes())
        else:
            dst.write(header)
            dst.write(pixels_u8.tobytes())


def read_ppm(src: Union[str, io.BufferedIOBase]) -> np.ndarray:
    """Read a binary P6 PPM into an (H, W, 3) uint8 array."""
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = src.read()
    fields: list = []
    pos = 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # comment line
            while pos < len(data) and data[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"not an 8-bit P6 PPM: {magic!r} maxval {maxval}")
    return np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos).reshape(h, w, 3)


def image_shape_or_raise(width: int, height: int) -> Tuple[int, int]:
    """Validate dimensions like the Image ctor (src/image.h:25-29)."""
    if width <= 0 or height <= 0:
        raise ValueError(f"Illegal image size{width}x{height}")
    return width, height
