"""Batched 3-vector math over ``[..., 3]`` tensors (port of
``tpu_pathtracer/ops/vecmath.py:18-72``), same operand order per component."""

from __future__ import annotations

import torch

_CONSTANTS: dict = {}


def constant(values, like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A small constant tensor on ``like``'s device (of ``like``'s dtype unless
    ``dtype`` is given), made once per (values, dtype, device): a copy from
    the host at every call would stop a loop from being captured in a CUDA
    graph."""
    dtype = dtype or like.dtype
    key = (tuple(values), dtype, like.device)
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=like.device)
    return out


def dot(a, b, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    """crs (src/geometry.h:18-24)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length2(a, keepdim: bool = False):
    return torch.sum(a * a, dim=-1, keepdim=keepdim)


def length(a, keepdim: bool = False):
    return torch.sqrt(length2(a, keepdim=keepdim))


def normalize(a):
    """norm (src/geometry.h:31-34): exact length, no epsilon."""
    return a / length(a, keepdim=True)


def reflect(normal, in_dir):
    """reflect (src/geometry.h:36-40): in - 2 n <in, n>."""
    return in_dir - 2.0 * normal * dot(in_dir, normal, keepdim=True)


def frame_apply(local_coords, x, y, z):
    """transform3 (src/geometry.h:355-359): basis recombination."""
    return (
        local_coords[..., 0:1] * x
        + local_coords[..., 1:2] * y
        + local_coords[..., 2:3] * z
    )


def where3(mask, a, b):
    """Select over [..., 3] vectors with a [...]-shaped bool mask."""
    return torch.where(mask[..., None], a, b)
