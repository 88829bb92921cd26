"""Counter-based threefry-2x32 uniforms (port of ``tpu_pathtracer/ops/rng.py``).

The draw for (seed, pixel, sample, depth, draw index) is a pure function of
those five integers, bit-equal to the JAX package's stream: every uniform is
``tf2x32(stage_key, (pixel, block))`` where the stage key folds (sample,
depth) into the seed's key words.  There is no global RNG state.

torch has thin uint32 support, so the u32 arithmetic runs in int64 with an
explicit ``& 0xFFFFFFFF`` after every add and shift; the final
``bits >> 9 | 0x3F800000`` mantissa trick reinterprets int32 bits as f32.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

# Reserved depth id for the pixel-jitter draws of a sample (same constant as
# the JAX package: a sample's camera jitter is "before bounce 0").
JITTER_DEPTH = 0x7FFFFFFF

_Int = Union[int, torch.Tensor]


def _u32(x: _Int, device=None) -> torch.Tensor:
    """Any int or integer tensor -> int64 tensor holding its u32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def tf2x32(
    k0: _Int, k1: _Int, c0: _Int, c1: _Int, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds (Random123 KAT-validated).  Inputs broadcast;
    returns two int64 tensors holding u32 words."""
    k0, k1, x0, x1 = (_u32(v, device) for v in (k0, k1, c0, c1))
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for i in range(5):
        for j in range(4):
            r = _ROT[(i % 2) * 4 + j]
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 (in int64) -> f32 in [0, 1): top 23 bits into a [1,2) mantissa."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def key_words(seed: int) -> Tuple[int, int]:
    """The two key words of ``jax.random.key(seed)`` (threefry, 32-bit mode):
    ``[0, seed mod 2^32]``."""
    return 0, int(seed) & _M32


def lane_uniforms(
    seed: int,
    sample: _Int,  # scalar or [R] global sample index
    depth: _Int,  # scalar or [R] bounce index (or JITTER_DEPTH)
    pixel: torch.Tensor,  # [R] linear pixel ids
    n_draws: int,
) -> torch.Tensor:  # [n_draws, R] f32 in [0, 1)
    """U[0,1) draws keyed per (pixel, sample, depth) lane.  Scalar or per-lane
    (sample, depth) give the same stream, as in the JAX package."""
    dev = pixel.device
    k0, k1 = key_words(seed)
    a0, a1 = tf2x32(k0, k1, sample, depth, device=dev)
    # All ceil(n/2) counter blocks in one broadcast: [B, 1] block ids x [R].
    blocks = torch.arange((n_draws + 1) // 2, dtype=torch.int64, device=dev)
    x0, x1 = tf2x32(a0, a1, pixel[None, :], blocks[:, None], device=dev)
    draws = torch.stack([_bits_to_unit(x0), _bits_to_unit(x1)], dim=1)
    return draws.reshape(-1, pixel.shape[0])[:n_draws]


def jitter_uniforms(
    seed: int, sample: _Int, pixel: torch.Tensor, kind: str = "uniform"
) -> torch.Tensor:  # [2, R]
    """Camera-jitter draws: the JITTER_DEPTH lane stream.  Only the uniform
    kind is ported; Sobol jitter is a later slice."""
    if kind != "uniform":
        raise NotImplementedError(
            f"jitter {kind!r}: only 'uniform' is ported (ROADMAP: next slices, "
            "engine and config parity)"
        )
    return lane_uniforms(seed, sample, JITTER_DEPTH, pixel, 2)
