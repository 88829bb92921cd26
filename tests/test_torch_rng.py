"""The port's counter-based threefry stream and Sobol camera jitter vs the JAX
package's, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer_torch.ops import rng as trng

torch.set_num_threads(1)

SEEDS = [0, 7, 2**33 + 5]


def test_torch_threefry_known_answers():
    """Random123 KAT vectors for threefry-2x32, 20 rounds."""
    cases = [
        ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for (k0, k1, c0, c1), (e0, e1) in cases:
        x0, x1 = trng.tf2x32(k0, k1, c0, c1)
        assert (int(x0), int(x1)) == (e0, e1)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_key_words_match_jax(seed):
    k0, k1 = jrng.key_words(jax.random.key(seed))
    assert trng.key_words(seed) == (int(k0), int(k1))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_lane_uniforms_bit_equal(seed):
    """Per-lane (sample, depth) vectors and 10 draws, as the persistent
    engine asks for them: identical f32 bits."""
    rs = np.random.default_rng(seed % 1000)
    pix = rs.integers(0, 2**31 - 1, size=300).astype(np.int32)
    sample = rs.integers(0, 5000, size=300).astype(np.int32)
    depth = rs.integers(0, 9, size=300).astype(np.int32)
    want = np.asarray(jrng.lane_uniforms(
        jax.random.key(seed), jnp.asarray(sample), jnp.asarray(depth), jnp.asarray(pix), 10
    ))
    got = trng.lane_uniforms(
        seed, torch.from_numpy(sample), torch.from_numpy(depth), torch.from_numpy(pix), 10
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (10, 300)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_jitter_uniforms_bit_equal(seed):
    pix = np.arange(1000, 1512, dtype=np.int32)
    want = np.asarray(jrng.jitter_uniforms(jax.random.key(seed), 9, jnp.asarray(pix)))
    got = trng.jitter_uniforms(seed, 9, torch.from_numpy(pix)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_torch_lane_uniforms_scalar_vector_agree():
    """Scalar (sample, depth) and per-lane vectors give the same draws."""
    pix = torch.arange(100, 164, dtype=torch.int32)
    a = trng.lane_uniforms(7, 3, 5, pix, 10)
    b = trng.lane_uniforms(
        7, torch.full((64,), 3, dtype=torch.int32), torch.full((64,), 5, dtype=torch.int32),
        pix, 10,
    )
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_torch_sobol_jitter_not_ported():
    """jitter_uniforms("sobol") equals the JAX package's Owen-scrambled
    Sobol jitter bit for bit (scalar and per-lane samples, seeds past
    2^31); an unknown kind raises ValueError, as in JAX."""
    pix = np.arange(0, 4096, 13, dtype=np.int32)
    lanes = np.random.default_rng(4).integers(0, 70_000, size=pix.shape).astype(np.int32)
    for seed in (0, 7, 2**31 + 5):
        for sample in (0, 37, lanes):
            want = np.asarray(jrng.jitter_uniforms(jax.random.key(seed), jnp.asarray(sample),
                                                   jnp.asarray(pix), "sobol"))
            got = trng.jitter_uniforms(seed, torch.as_tensor(sample), torch.from_numpy(pix),
                                       "sobol").numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="unknown jitter"):
        trng.jitter_uniforms(0, 0, torch.from_numpy(pix), "sobl")
