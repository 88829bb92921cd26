"""Counter-based threefry-2x32 uniforms and Owen-scrambled Sobol points (port
of ``tpu_pathtracer/ops/rng.py``).

The draw for (seed, pixel, sample, depth, draw index) is a pure function of
those five integers, bit-equal to the JAX package's stream: every uniform is
``tf2x32(stage_key, (pixel, block))`` where the stage key folds (sample,
depth) into the seed's key words.  There is no global RNG state.

torch has thin uint32 support, so the u32 arithmetic runs in int64 with an
explicit ``& 0xFFFFFFFF`` after every add and shift; the final
``bits >> 9 | 0x3F800000`` mantissa trick reinterprets int32 bits as f32.

``lane_uniforms_key`` (and through it ``lane_uniforms``, the uniform
camera jitter and ``per_pixel_uniforms``) runs the hand-written kernel of
``csrc/rng_kernels.cu`` on CUDA tensors and its plain twin
``lane_uniforms_key_plain`` on CPU tensors; the two are equal bit for bit.
A seed, a key word or the base of a sample or pixel index may be a 0-d
tensor: the kernel reads it on the device, so a captured render loop
follows its value.
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


def _u32(x: _Int) -> _Int:
    """An int or integer tensor -> its u32 value (an int, or an int64
    tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _rotl(x: _Int, r: int) -> _Int:
    return ((x << r) | (x >> (32 - r))) & _M32


def tf2x32(k0: _Int, k1: _Int, c0: _Int, c1: _Int) -> Tuple[_Int, _Int]:
    """Threefry-2x32, 20 rounds (Random123 KAT-validated).  Inputs broadcast;
    returns two u32 words: ints when every input is an int (host work, no
    device copy), else int64 tensors."""
    k0, k1, x0, x1 = (_u32(v) for v in (k0, k1, c0, c1))
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


def key_words(seed: _Int) -> Tuple[int, _Int]:
    """The two key words of ``jax.random.key(seed)`` (threefry, 32-bit mode):
    ``[0, seed mod 2^32]`` (the second a 0-d int64 tensor for a tensor
    seed)."""
    return 0, _u32(seed)


def fold_in(k0: int, k1: int, n: int) -> Tuple[int, int]:
    """The key words of ``jax.random.fold_in(key, n)`` for a key of words
    (k0, k1): one threefry block of the counter (0, n)."""
    return tf2x32(k0, k1, 0, n)


def _plus(x: _Int, base: _Int) -> _Int:
    """``x + base`` as the stream reads it (mod 2^32 after ``tf2x32``'s mask);
    ``x`` itself when ``base`` is the int 0."""
    if isinstance(base, int) and base == 0:
        return x
    return _u32(x) + _u32(base)


def lane_uniforms_key_plain(
    k0: _Int,
    k1: _Int,
    sample: _Int,  # scalar or [R] global sample index
    depth: _Int,  # scalar or [R] bounce index (or JITTER_DEPTH)
    pixel: torch.Tensor,  # [R] linear pixel ids
    n_draws: int,
    sample_base: _Int = 0,
    pixel_base: _Int = 0,
) -> torch.Tensor:  # [n_draws, R] f32 in [0, 1)
    """Plain twin of the threefry kernel (``lane_uniforms_key``'s contract)."""
    dev = pixel.device
    a0, a1 = tf2x32(k0, k1, _plus(sample, sample_base), depth)
    # All ceil(n/2) counter blocks in one broadcast: [B, 1] block ids x [R].
    blocks = torch.arange((n_draws + 1) // 2, dtype=torch.int64, device=dev)
    x0, x1 = tf2x32(a0, a1, _plus(pixel, pixel_base)[None, :], blocks[:, None])
    draws = torch.stack([_bits_to_unit(x0), _bits_to_unit(x1)], dim=1)
    return draws.reshape(-1, pixel.shape[0])[:n_draws]


def lane_uniforms_key(
    k0: _Int,
    k1: _Int,
    sample: _Int,  # scalar or [R] global sample index
    depth: _Int,  # scalar or [R] bounce index (or JITTER_DEPTH)
    pixel: torch.Tensor,  # [R] linear pixel ids
    n_draws: int,
    sample_base: _Int = 0,
    pixel_base: _Int = 0,
) -> torch.Tensor:  # [n_draws, R] f32 in [0, 1)
    """``lane_uniforms`` under the key words (k0, k1) instead of a seed: the
    JAX package's ``lane_uniforms(key, ...)`` for any key, folded ones
    included.  A key word is read for its low 32 bits.  The sample index of
    a lane is ``sample + sample_base`` and its pixel ``pixel + pixel_base``
    (each base an int or a 0-d tensor, mod 2^32): a render passes its
    carries and its traced first sample and pixel apart, and the kernel adds
    them.  The threefry kernel for a CUDA ``pixel``, the plain twin for a
    CPU one."""
    if pixel.is_cuda:
        from .. import kernels

        return kernels.uniforms(k0, k1, sample, depth, pixel, n_draws, sample_base, pixel_base)
    if pixel.device.type == "cpu":
        return lane_uniforms_key_plain(k0, k1, sample, depth, pixel, n_draws, sample_base,
                                       pixel_base)
    raise RuntimeError(f"lane_uniforms_key: no kernel for device {pixel.device}")


def lane_uniforms(
    seed: _Int,
    sample: _Int,  # scalar or [R] global sample index
    depth: _Int,  # scalar or [R] bounce index (or JITTER_DEPTH)
    pixel: torch.Tensor,  # [R] linear pixel ids
    n_draws: int,
    sample_base: _Int = 0,
    pixel_base: _Int = 0,
) -> torch.Tensor:  # [n_draws, R] f32 in [0, 1)
    """U[0,1) draws keyed per (pixel, sample, depth) lane.  Scalar or per-lane
    (sample, depth) give the same stream, as in the JAX package.  The key
    words are ``key_words(seed)``; the seed goes in unmasked, since the
    stream reads a key word's low 32 bits (a tensor seed costs no mask)."""
    return lane_uniforms_key(0, seed, sample, depth, pixel, n_draws, sample_base, pixel_base)


def per_pixel_uniforms(k0: int, k1: int, pixel_ids: torch.Tensor, n_draws: int) -> torch.Tensor:
    """[n_draws, R] draws keyed per pixel under the key words (k0, k1): the
    JAX package's ``models.pathtracer.per_pixel_uniforms``, the stream of
    the homebrew renderers' folded keys."""
    return lane_uniforms_key(k0, k1, 0, 0, pixel_ids, n_draws)


# ---------------------------------------------------------------------------
# Owen-scrambled 2D Sobol (jitter="sobol", lowdisc="sobol"): the same counter
# discipline, so a point is a pure function of (seed, pixel, sample[, depth,
# tag]).  Every u32 product is formed from 16-bit halves so no int64 product
# overflows.
# ---------------------------------------------------------------------------

# Direction numbers of dimension 2, MSB-aligned: v[i] = v[i-1] ^ (v[i-1] >> 1)
# from v[0] = 2^31 (dimension 1 is the identity: value = reverse_bits(index)).
_SOBOL_V2 = [0x80000000]
for _ in range(31):
    _SOBOL_V2.append(_SOBOL_V2[-1] ^ (_SOBOL_V2[-1] >> 1))

# Domain tags of the two bounce pairs lowdisc="sobol" replaces.
SOBOL_TAG_VNDF = 0x564E4446  # 'VNDF'
SOBOL_TAG_LIGHT = 0x4C495445  # 'LITE'
_SOBL = 0x534F424C  # 'SOBL'


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for u32 values held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Burley's (JCGT 2020) Laine-Karras hash: a nested uniform scramble in
    the reversed-bit domain."""
    x = (x + seed) & _M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def _owen_scramble(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _reverse_bits32(_laine_karras(_reverse_bits32(v), seed))


def _sobol_point(idx: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """[2, R] Owen-scrambled Sobol point ``idx`` (u32 in int64, [R]) under
    the per-lane scramble seeds (s1, s2)."""
    d1 = _reverse_bits32(_laine_karras(idx, s1))
    d2 = torch.zeros_like(idx)
    for k, v in enumerate(_SOBOL_V2):
        d2 = d2 ^ torch.where(((idx >> k) & 1) > 0, v, 0)
    d2 = _owen_scramble(d2, s2)
    return torch.stack([_bits_to_unit(d1), _bits_to_unit(d2)], dim=0)


def sobol_owen_2d(seed: _Int, sample: _Int, pixel: torch.Tensor) -> torch.Tensor:
    """[2, R] Owen-scrambled 2D Sobol point ``sample`` (scalar or [R]) of
    each pixel's sequence; the per-pixel scramble seeds are one threefry
    block of (pixel, 0) under the 'SOBL' tag."""
    k0, k1 = key_words(seed)
    p = _u32(pixel)
    s1, s2 = tf2x32(k0 ^ _SOBL, k1, p, 0)
    return _sobol_point(_u32(sample) + p * 0, s1, s2)


def sobol_owen_pair(seed: _Int, sample: _Int, depth: _Int, pixel: torch.Tensor,
                    tag: int) -> torch.Tensor:
    """[2, R] point ``sample`` of the per-(pixel, depth, tag) Owen-scrambled
    (0,2)-sequence: the bounce-draw form of ``sobol_owen_2d``."""
    k0, k1 = key_words(seed)
    p = _u32(pixel)
    s1, s2 = tf2x32(k0 ^ tag, k1, p, _u32(depth) ^ _SOBL)
    return _sobol_point(_u32(sample) + p * 0, s1, s2)


def jitter_uniforms(
    seed: _Int, sample: _Int, pixel: torch.Tensor, kind: str = "uniform",
    sample_base: _Int = 0, pixel_base: _Int = 0,
) -> torch.Tensor:  # [2, R]
    """Camera-jitter draws of lane (``sample + sample_base``, ``pixel +
    pixel_base``): the JITTER_DEPTH lane stream ("uniform") or the
    Owen-scrambled Sobol point ("sobol")."""
    if kind == "sobol":
        return sobol_owen_2d(seed, _plus(sample, sample_base), _plus(pixel, pixel_base))
    if kind != "uniform":
        raise ValueError(f"unknown jitter kind {kind!r}: expected uniform | sobol")
    return lane_uniforms(seed, sample, JITTER_DEPTH, pixel, 2, sample_base, pixel_base)
