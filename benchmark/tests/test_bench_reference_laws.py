"""The reference's sampling, BSDF, texture and random-number maths held to
statements that do not come from the program: the published Threefry
known answers, the laws a direction sampler and its pdf obey together
(the pdf integrates to one over the sphere and gives the frequencies the
sampler draws), BRDF reciprocity and energy, uniform points on a light
triangle, and repeat-wrapped bilinear texture taps.  A fault that the
reference's frozen copies share with the program's kernels (VNDF algebra,
texture wrap, sRGB decode) breaks one of these."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import twins as tw


def _fibonacci_sphere(n: int) -> torch.Tensor:
    """``n`` directions spread evenly over the unit sphere (each stands for a
    solid angle of 4 pi / n)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(1.0 - z * z)
    phi = math.pi * (1.0 + 5.0 ** 0.5) * i
    return torch.from_numpy(np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)).float()


def _rows(v, n):
    return torch.tensor(v, dtype=torch.float32).expand(n, 3).contiguous()


@pytest.mark.parametrize("key,counter,want", [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_bench_threefry_known_answers(key, counter, want):
    """Random123's known-answer vectors of Threefry-2x32 with 20 rounds."""
    assert tw.tf2x32(*key, *counter) == want
    got = tw.tf2x32(torch.tensor([key[0]]), key[1], torch.tensor([counter[0]]), counter[1])
    assert (int(got[0][0]), int(got[1][0])) == want


def test_bench_uniform_draws_are_uniform():
    u = tw.lane_uniforms(2400000007, 3, 1, torch.arange(40000), 10)
    assert u.min() >= 0.0 and u.max() < 1.0
    counts = torch.histc(u.flatten(), bins=10, min=0.0, max=1.0)
    assert (counts - 40000).abs().max() < 5 * math.sqrt(40000)


def test_bench_cosine_sampler_and_pdf():
    """Lambert: the pdf integrates to one, and P(cos theta > c) = 1 - c^2."""
    n = 200000
    normal = _rows(tw.normalize(torch.tensor([[0.3, -0.5, 0.8]]))[0].tolist(), n)
    dirs = _fibonacci_sphere(n)
    assert float(tw.cosine_pdf(normal, dirs).sum() * 4 * math.pi / n) == pytest.approx(1.0, abs=2e-3)
    g = torch.Generator().manual_seed(5)
    w = tw.cosine_sample(normal, torch.rand(n, generator=g), torch.rand(n, generator=g))
    cos = tw.dot(normal, w)
    for c in (0.2, 0.5, 0.8):
        assert float((cos > c).float().mean()) == pytest.approx(1 - c * c, abs=5e-3)


@pytest.mark.parametrize("alpha,theta", [(0.25, 0.5), (0.5, 1.1), (0.09, 0.2)])
def test_bench_vndf_sampler_and_pdf(alpha, theta):
    """GGX visible-normal sampling: over the directions whose half vector
    lies above the surface (the only ones the sampler reaches; the pdf, as
    the reference renderer writes it, also counts some below at grazing
    incidence) the reflected direction's pdf integrates to one, and the
    sampler draws directions at the frequencies the pdf gives, in bins of
    the angle to the mirror direction and of the azimuth about it."""
    n = 400000
    normal = _rows([0.0, 0.0, 1.0], n)
    in_dir = _rows([math.sin(theta), 0.0, -math.cos(theta)], n)
    r = torch.full((n,), alpha)
    dirs = _fibonacci_sphere(n)
    pdf = tw.vndf_pdf(r, in_dir, normal, dirs, 1e-4)
    pdf = pdf * (tw.halfway(in_dir, dirs)[:, 2] > 0)
    assert float(pdf.sum() * 4 * math.pi / n) == pytest.approx(1.0, abs=0.01)

    g = torch.Generator().manual_seed(11)
    drawn = tw.vndf_sample(r, in_dir, normal, torch.rand(n, generator=g), torch.rand(n, generator=g))
    mirror = tw.reflect(normal[:1], in_dir[:1])[0]

    def bins(w):
        c = torch.clamp(w @ mirror, -1.0, 1.0)
        return torch.bucketize(c, torch.tensor([0.0, 0.5, 0.8, 0.9, 0.95, 0.98, 0.99, 0.995])) * 2 \
            + (w[:, 1] > 0).long()

    want = torch.bincount(bins(dirs), weights=pdf.double() * 4 * math.pi / n, minlength=18)
    got = torch.bincount(bins(drawn), minlength=18).double() / n
    assert torch.allclose(got, want, atol=0.005, rtol=0.05), (got, want)


@pytest.mark.parametrize("metallic,roughness", [(0.0, 0.5), (1.0, 0.3), (0.5, 0.8)])
def test_bench_brdf_reciprocal_and_energy(metallic, roughness):
    """f(in -> out) = f(-out -> -in); and a white metal reflects at most what
    it receives (the integral of f cos over the hemisphere is <= 1), nearly
    all of it near normal incidence.  (The dielectric's Fresnel-weighted
    mix of the diffuse and specular lobes, as the reference renderer writes
    it, is not bound so at grazing incidence.)"""
    n = 200000
    normal = _rows([0.0, 0.0, 1.0], n)
    g = torch.Generator().manual_seed(3)
    a = tw.normalize(torch.randn(n, 3, generator=g))
    b = tw.normalize(torch.randn(n, 3, generator=g))
    a = torch.where(a[:, 2:] > 0, -a, a)  # incoming: toward the surface
    b = torch.where(b[:, 2:] < 0, -b, b)  # outgoing: away from it
    white = torch.ones(n, 3)
    m, rgh, ior = torch.full((n,), metallic), torch.full((n,), roughness), torch.full((n,), 1.5)
    f_ab = tw.pbr_brdf(a, b, normal, white, m, rgh, ior, 0.04)
    f_ba = tw.pbr_brdf(-b, -a, normal, white, m, rgh, ior, 0.04)
    assert torch.allclose(f_ab, f_ba, rtol=1e-4, atol=1e-6)

    dirs = _fibonacci_sphere(n)
    up = dirs[:, 2] > 0
    for theta in (0.2, 0.9, 1.3):
        inc = _rows([math.sin(theta), 0.0, -math.cos(theta)], n)
        f = tw.pbr_brdf(inc, dirs, normal, white, m, rgh, ior, 0.04)[:, 0]
        albedo = float((f * dirs[:, 2] * up).sum() * 4 * math.pi / n)
        assert albedo > 0.0
        if metallic == 1.0:
            assert albedo <= 1.0 + 0.005 and (theta > 0.5 or albedo > 0.97), albedo


def test_bench_light_triangle_points_are_uniform():
    """The sampled point is uniform on the triangle: inside it, with the
    triangle's centroid as its mean and a quarter of the points in the
    middle triangle of its four halves."""
    n = 200000
    tri = torch.tensor([[-1.0, -0.5, 1.0], [2.0, 0.0, 1.0], [0.0, 1.5, 1.0]])
    g = torch.Generator().manual_seed(7)
    d = tw.light_triangle_sample(torch.zeros(n, 3), tri[0].expand(n, 3), tri[1].expand(n, 3),
                                 tri[2].expand(n, 3), torch.rand(n, generator=g),
                                 torch.rand(n, generator=g))
    p = (d / d[:, 2:]).double()[:, :2]  # on the plane z = 1
    m = torch.stack([tri[1, :2] - tri[0, :2], tri[2, :2] - tri[0, :2]], dim=1).double()
    bc = torch.linalg.solve(m, (p - tri[0, :2].double()).T).T  # (b, c) barycentrics
    assert float(bc.min()) > -1e-5 and float(bc.sum(dim=1).max()) < 1 + 1e-5
    assert torch.allclose(bc.mean(dim=0), torch.tensor([1 / 3, 1 / 3], dtype=torch.float64),
                          atol=3e-3)
    middle = (bc[:, 0] < 0.5) & (bc[:, 1] < 0.5) & (bc.sum(dim=1) > 0.5)
    assert float(middle.double().mean()) == pytest.approx(0.25, abs=4e-3)


def _atlas():
    """One 3x2 texture (row-major, RGBA) and one 1x1 texture."""
    texels = torch.tensor([[0.1, 0.2, 0.3, 1.0], [0.4, 0.5, 0.6, 1.0], [0.7, 0.8, 0.9, 0.5],
                           [0.9, 0.1, 0.5, 1.0], [0.3, 0.3, 0.3, 0.0], [0.6, 0.0, 1.0, 1.0],
                           [0.25, 0.5, 0.75, 1.0]])
    return tw.TextureAtlas(texels=texels, offset=torch.tensor([0, 6], dtype=torch.int32),
                           width=torch.tensor([3, 1], dtype=torch.int32),
                           height=torch.tensor([2, 1], dtype=torch.int32))


def _texel(i, j, gamma):
    t = _atlas().texels[(j % 2) * 3 + (i % 3)].clone()
    t[:3] = t[:3] ** gamma
    return t


@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_bench_texture_taps_repeat_bilinear(gamma):
    """A tap at a texel's corner is that texel, decoded (RGB to the power
    gamma, alpha kept); halfway between texels it is their mean; u and v
    repeat with period one, from below as from above; the last column and
    row blend with the first; a 1x1 texture is its texel as stored."""
    atlas = _atlas()
    uv = torch.tensor([[0.0, 0.0], [1 / 3, 0.5], [2 / 3, 0.5], [1 / 3 + 2.0, 0.5 - 3.0],
                       [-2 / 3, 0.0], [1 / 6, 0.0], [0.0, 0.25], [5 / 6, 0.75], [0.3, 0.7]])
    got = tw.sample(atlas, torch.zeros(uv.shape[0], dtype=torch.int32), uv, gamma)
    want = torch.stack([
        _texel(0, 0, gamma), _texel(1, 1, gamma), _texel(2, 1, gamma), _texel(1, 1, gamma),
        _texel(1, 0, gamma),
        (_texel(0, 0, gamma) + _texel(1, 0, gamma)) / 2,
        (_texel(0, 0, gamma) + _texel(0, 1, gamma)) / 2,
        (_texel(2, 1, gamma) + _texel(0, 1, gamma) + _texel(2, 0, gamma) + _texel(0, 0, gamma)) / 4,
        (_texel(0, 1, gamma) * 0.1 + _texel(1, 1, gamma) * 0.9) * 0.6
        + (_texel(0, 0, gamma) * 0.1 + _texel(1, 0, gamma) * 0.9) * 0.4,
    ])
    assert torch.allclose(got, want, atol=2e-6), (got, want)
    one = tw.sample(atlas, torch.ones(2, dtype=torch.int32), torch.tensor([[0.3, 0.9], [-4.2, 7.1]]),
                    gamma)
    assert torch.equal(one, atlas.texels[6].expand(2, 4))
