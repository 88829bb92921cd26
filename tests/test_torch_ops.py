"""Elementwise estimator math, texture fetch, dense intersection, light pdf
and tone mapping: the port vs the JAX package on the same numpy inputs.

Tolerances: both sides compute in float32 in the same operation order, so
arithmetic ops round identically; the transcendental and power functions
(sin, cos, tan, pow) of XLA's CPU backend and of PyTorch differ by an ulp or
two, and normalize/divide chains can carry that to a few ulps.  Hence
rtol 1e-5 / atol 1e-6 (~100 ulps at 1.0) unless a check says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import bsdf as jbsdf
from tpu_pathtracer.ops import intersect as jisect
from tpu_pathtracer.ops import sampling as jsamp
from tpu_pathtracer.ops import texture as jtex
from tpu_pathtracer.ops import vecmath as jvec
from tpu_pathtracer.scene import types as jtypes
from tpu_pathtracer.utils import image as jimage
from tpu_pathtracer_torch.ops import bsdf as tbsdf
from tpu_pathtracer_torch.ops import intersect as tisect
from tpu_pathtracer_torch.ops import sampling as tsamp
from tpu_pathtracer_torch.ops import texture as ttex
from tpu_pathtracer_torch.ops import vecmath as tvec
from tpu_pathtracer_torch.scene import gltf as tgltf
from tpu_pathtracer_torch.scene import types as ttypes
from tpu_pathtracer_torch.utils import image as timage

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
R = 512


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _both(fn_j, fn_t, *arrays):
    """Run the JAX and torch functions on the same numpy arrays."""
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    got = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays))
    return np.asarray(want), got.numpy()


def _inputs(seed=0):
    rs = np.random.default_rng(seed)
    n = _unit(rs, R)
    d = _unit(rs, R)
    # Incoming directions mostly against the normal, a few grazing.
    d = np.where((np.sum(d * n, axis=1) > 0)[:, None], -d, d).astype(np.float32)
    d[:8] = _unit(rs, 8) - 0.999 * n[:8] * np.sum(_unit(rs, 8) * n[:8], axis=1, keepdims=True)
    d[:8] /= np.linalg.norm(d[:8], axis=1, keepdims=True)
    u = rs.random((6, R)).astype(np.float32)
    rough = rs.uniform(0.04, 1.0, size=R).astype(np.float32)
    return rs, n, d, u, rough


def _case_vecmath():
    rs, n, d, *_ = _inputs(1)
    for fj, ft in ((jvec.cross, tvec.cross), (jvec.reflect, tvec.reflect)):
        yield _both(fj, ft, n, d)
    yield _both(jvec.normalize, tvec.normalize, n * 3.0 + d)


def _case_vndf_sample():
    _, n, d, u, rough = _inputs(2)
    yield _both(lambda a, b, c, x, y: jsamp.vndf_sample(a, b, c, x, y),
                tsamp.vndf_sample, rough ** 2, d, n, u[0], u[1])


def _case_vndf_pdf():
    """Includes directions at grazing angles to the normal (v.z -> 0: the
    eps clamp of the reference's grazing quirk)."""
    _, n, d, u, rough = _inputs(3)
    out = np.asarray(jsamp.vndf_sample(jnp.asarray(rough ** 2), jnp.asarray(d), jnp.asarray(n),
                                       jnp.asarray(u[0]), jnp.asarray(u[1])))
    yield _both(lambda *a: jsamp.vndf_pdf(*a, 1e-4), lambda *a: tsamp.vndf_pdf(*a, 1e-4),
                rough ** 2, d, n, out)
    # The reference's unnormalised grazing case (tests/test_sampling.py):
    # alpha 1, in_dir z = -0.77, directions over the whole sphere.
    in_dir = np.array([np.sqrt(1 - 0.77**2), 0.0, -0.77], np.float32)
    dirs = _unit(np.random.default_rng(30), R)
    yield _both(lambda *a: jsamp.vndf_pdf(*a, 1e-4), lambda *a: tsamp.vndf_pdf(*a, 1e-4),
                np.ones(R, np.float32), np.tile(in_dir, (R, 1)),
                np.tile(np.array([0, 0, 1], np.float32), (R, 1)), dirs)


def _case_cosine():
    _, n, d, u, _ = _inputs(4)
    yield _both(jsamp.cosine_sample, tsamp.cosine_sample, n, u[0], u[1])
    yield _both(jsamp.cosine_pdf, tsamp.cosine_pdf, n, d)


def _case_light_triangle():
    rs, n, d, u, _ = _inputs(5)
    tri = rs.uniform(-2, 2, size=(3, R, 3)).astype(np.float32)
    x = rs.uniform(-1, 1, size=(R, 3)).astype(np.float32)
    yield _both(jsamp.light_triangle_sample, tsamp.light_triangle_sample,
                x, tri[0], tri[1], tri[2], u[0], u[1])


def _case_pick_uniform():
    _, _, _, u, _ = _inputs(6)
    for count in (1, 2, 6, 1000):
        want = np.asarray(jsamp.pick_uniform(jnp.asarray(u[0]), jnp.asarray(count)))
        yield want, tsamp.pick_uniform(torch.from_numpy(u[0]), count).numpy()


def _case_pbr_brdf():
    rs, n, d, u, rough = _inputs(7)
    out = _unit(rs, R)
    color = rs.random((R, 3)).astype(np.float32)
    metallic = rs.choice([0.0, 0.3, 1.0], size=R).astype(np.float32)
    ior = rs.uniform(1.0, 2.0, size=R).astype(np.float32)
    yield _both(lambda *a: jbsdf.pbr_brdf(*a, 0.04), lambda *a: tbsdf.pbr_brdf(*a, 0.04),
                d, out, n, color, metallic, rough, ior)


def _atlas_pair(quad: bool):
    rs = np.random.default_rng(8)
    images = [
        np.array([[[1, 1, 1, 1]]], np.float32),
        np.array([[[0.5, 0.5, 1, 0]]], np.float32),
        rs.random((5, 7, 4)).astype(np.float32),
        rs.random((8, 3, 4)).astype(np.float32),
    ]
    offs = np.cumsum([0] + [im.shape[0] * im.shape[1] for im in images[:-1]]).astype(np.int32)
    texels = np.concatenate([im.reshape(-1, 4) for im in images])
    wh = [(im.shape[1], im.shape[0]) for im in images]
    width = np.array([w for w, _ in wh], np.int32)
    height = np.array([h for _, h in wh], np.int32)
    q = tgltf.quad_pool(images, 1 << 20) if quad else None
    jat = jtypes.TextureAtlas(
        texels=jnp.asarray(texels), offset=jnp.asarray(offs), width=jnp.asarray(width),
        height=jnp.asarray(height), quad=None if q is None else jnp.asarray(q),
    )
    tat = ttypes.TextureAtlas(
        texels=torch.from_numpy(texels), offset=torch.from_numpy(offs),
        width=torch.from_numpy(width), height=torch.from_numpy(height),
        quad=None if q is None else torch.from_numpy(q),
    )
    return jat, tat


def _case_sample_many(quad):
    jat, tat = _atlas_pair(quad)
    rs = np.random.default_rng(9)
    ids = rs.integers(0, 4, size=(R, 3)).astype(np.int32)
    uv = rs.uniform(-3, 3, size=(R, 2)).astype(np.float32)
    gammas = (2.2, 1.0, 2.2)
    want = np.asarray(jtex.sample_many(jat, jnp.asarray(ids), jnp.asarray(uv), gammas, flat=True))
    yield want, ttex.sample_many(tat, torch.from_numpy(ids), torch.from_numpy(uv), gammas).numpy()
    want = np.asarray(jtex.sample(jat, jnp.asarray(ids[:, 0]), jnp.asarray(uv), 2.2))
    yield want, ttex.sample(tat, torch.from_numpy(ids[:, 0]), torch.from_numpy(uv), 2.2).numpy()


def _soup(n, seed):
    rs = np.random.default_rng(seed)
    verts = (rs.uniform(-3, 3, size=(n, 1, 3)) + rs.uniform(-1, 1, size=(n, 3, 3)))
    cap = tgltf.tri_capacity(n)
    out = np.full((cap, 3, 3), 1e30)
    out[:n] = verts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return out.astype(np.float32), valid


def _case_light_pdf():
    """Both all-hits pdf forms on the same six-light cluster set: the flat
    cluster form and the dense Cramer form."""
    lverts, valid = _soup(6, 10)
    lverts = lverts[:8]
    cl = tgltf.light_clusters(lverts, 6)
    rs = np.random.default_rng(11)
    o = rs.uniform(-4, 4, size=(R, 3)).astype(np.float32)
    d = _unit(rs, R)
    want = jisect.light_pdf_sum_flat(jnp.asarray(o), jnp.asarray(d), jnp.asarray(cl[2]),
                                     jnp.asarray(cl[3]), jnp.asarray(6), 1e-4)
    got = tisect.light_pdf_sum_flat(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(cl[2]), torch.from_numpy(cl[3]), 6, 1e-4)
    assert (np.asarray(want) > 0).sum() > 5  # some rays pierce a light
    yield np.asarray(want), got.numpy()
    e1, e2 = lverts[:, 1] - lverts[:, 0], lverts[:, 2] - lverts[:, 0]
    cr = np.cross(e1, e2)
    area = (0.5 * np.linalg.norm(cr, axis=1)).astype(np.float32)
    with np.errstate(invalid="ignore"):  # the two 1e30 padding rows
        nrm = np.nan_to_num(cr / np.linalg.norm(cr, axis=1, keepdims=True)).astype(np.float32)
    want = jisect.light_pdf_sum(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lverts),
                                jnp.asarray(nrm), jnp.asarray(area), jnp.asarray(6), 1e-4)
    got = tisect.light_pdf_sum(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lverts),
                               torch.from_numpy(nrm), torch.from_numpy(area), 6, 1e-4)
    yield np.asarray(want), got.numpy()


def _case_tonemap():
    rs = np.random.default_rng(12)
    hdr = (rs.random((16, 16, 3)) * 4.0).astype(np.float32)
    yield _both(jimage.aces_tonemap, timage.aces_tonemap, hdr)
    # u8 after rounding: an ulp of pow can move a value across .5 -> 1 step.
    yield _both(jimage.quantize_u8, timage.quantize_u8, hdr)


CASES = {
    "vecmath": _case_vecmath,
    "vndf_sample": _case_vndf_sample,
    "vndf_pdf": _case_vndf_pdf,
    "cosine": _case_cosine,
    "light_triangle_sample": _case_light_triangle,
    "pick_uniform": _case_pick_uniform,
    "pbr_brdf": _case_pbr_brdf,
    "sample_many_flat": lambda: _case_sample_many(False),
    "sample_many_quad": lambda: _case_sample_many(True),
    "light_pdf": _case_light_pdf,
    "tonemap": _case_tonemap,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_op_matches_jax(name):
    for want, got in CASES[name]():
        assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
        if got.dtype == np.uint8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        elif got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_torch_closest_hit_matches_jax():
    """The dense sweep, single block and scanned blocks: same hits and
    triangles; t/beta to the module tolerance (the product is summed in
    another order by the two matrix-product backends)."""
    for n in (300, 2500):
        verts, valid = _soup(n, 13)
        woop = tgltf.build_woop(verts, valid)
        rs = np.random.default_rng(14)
        o = rs.uniform(-5, 5, size=(R, 3)).astype(np.float32)
        d = _unit(rs, R)
        jh = jisect.closest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(woop), 1e-4)
        th = tisect.closest_hit(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(woop), 1e-4)
        hit = np.asarray(jh.hit)
        assert hit.sum() > 50
        np.testing.assert_array_equal(th.hit.numpy(), hit)
        np.testing.assert_array_equal(th.tri.numpy()[hit], np.asarray(jh.tri)[hit])
        for field in ("t", "beta", "gamma"):
            np.testing.assert_allclose(getattr(th, field).numpy()[hit],
                                       np.asarray(getattr(jh, field))[hit], rtol=RTOL, atol=1e-5)
