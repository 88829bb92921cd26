"""Frozen copies of the program's plain twins that the reference may use:
the batched vector math, the direction distributions and the BSDF
(``ops/vecmath.py``, ``ops/sampling.py``, ``ops/bsdf.py``), the bilinear
texture fetch over a flat texel pool (``ops/texture.py``), the dense Woop
sweep and the dense light pdf (``ops/intersect.py``) and the plain
threefry-2x32 stream (``ops/rng.py``).  Plain PyTorch only: no kernel and
nothing of the program is imported.  They stay as they are here, whatever
later changes make to the program's own copies.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

PI = math.pi
TRI_BLOCK = 1024
JITTER_DEPTH = 0x7FFFFFFF
_M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_LIGHT_BLOCK = 128
_CONSTANTS: dict = {}
_Int = Union[int, torch.Tensor]


class TextureAtlas(NamedTuple):
    """Decoded textures in one flat texel pool: texture k occupies
    ``texels[offset[k] : offset[k] + width[k] * height[k]]`` row-major."""

    texels: torch.Tensor  # [T, 4] float32, linear
    offset: torch.Tensor  # [K] int32
    width: torch.Tensor  # [K] int32
    height: torch.Tensor  # [K] int32
    quad: Optional[torch.Tensor] = None


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


# --- direction distributions (ops/sampling.py) ---


def sphere_uniform_sample(u_z: torch.Tensor, u_phi: torch.Tensor) -> torch.Tensor:
    """sphere_uniform_dist::sample (src/raytracer.h:94-105)."""
    z = u_z * 2.0 - 1.0
    co_z = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u_phi
    return torch.stack([co_z * torch.cos(phi), co_z * torch.sin(phi), z], dim=-1)


def cosine_sample(normal, u_z, u_phi) -> torch.Tensor:
    """cosine_dist::sample (src/raytracer.h:114-121): norm(n + uniform_sphere)."""
    return normalize(normal + sphere_uniform_sample(u_z, u_phi))


def cosine_pdf(normal, direction) -> torch.Tensor:
    """cosine_dist::pdf (src/raytracer.h:123-128)."""
    return torch.clamp_min(dot(normal, direction) / PI, 0.0)


def halfway(in_dir, out_dir) -> torch.Tensor:
    """halfway (src/raytracer.h:131-134): norm(out - in)."""
    return normalize(out_dir - in_dir)


def choose_local_x(n: torch.Tensor) -> torch.Tensor:
    """VNDF_dist::choose_local_x (src/raytracer.h:208-219)."""
    ones = torch.ones_like(n)
    s = torch.sum(n, dim=-1)
    use_x = torch.abs(n[..., 0]) > 0.5
    use_y = (~use_x) & (torch.abs(n[..., 1]) > 0.5)
    use_z = ~(use_x | use_y)
    denom = torch.where(use_x, n[..., 0], torch.where(use_y, n[..., 1], n[..., 2]))
    corr = (s / denom)[..., None]
    axis = torch.stack([use_x, use_y, use_z], dim=-1).to(n.dtype)
    return normalize(ones - corr * axis)


def vndf_sample(roughness, in_dir, normal, u1, u2) -> torch.Tensor:
    """VNDF_dist::sample (src/raytracer.h:140-173): Heitz GGX visible-normal
    sampling in the (nx, ny, normal) frame, then a mirror reflect."""
    al = roughness[..., None]
    nx = choose_local_x(normal)
    ny = cross(normal, nx)
    v = -normalize(
        torch.stack([dot(nx, in_dir), dot(ny, in_dir), dot(normal, in_dir)], dim=-1)
    )
    vh = normalize(torch.cat([al, al, torch.ones_like(al)], dim=-1) * v)
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    t1_raw = torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1)
    t1 = torch.where(
        (lensq > 0)[..., None],
        t1_raw / torch.sqrt(torch.clamp_min(lensq, 1e-38))[..., None],
        constant((1.0, 0.0, 0.0), vh),
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    c1 = r * torch.cos(phi)
    c2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    c2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - c1 * c1, 0.0)) + s * c2
    ch = torch.sqrt(torch.clamp_min(1.0 - c1 * c1 - c2 * c2, 0.0))
    nh = c1[..., None] * t1 + c2[..., None] * t2 + ch[..., None] * vh
    ne = normalize(
        torch.stack(
            [
                roughness * nh[..., 0],
                roughness * nh[..., 1],
                torch.clamp_min(nh[..., 2], 0.0),
            ],
            dim=-1,
        )
    )
    res_n = normalize(frame_apply(ne, nx, ny, normal))
    return reflect(res_n, in_dir)


def vndf_pdf(roughness, in_dir, normal, direction, eps: float) -> torch.Tensor:
    """VNDF_dist::pdf (src/raytracer.h:175-206), single divides as in the
    JAX package (including its grazing-angle behaviour)."""
    nx = choose_local_x(normal)
    ny = cross(normal, nx)
    v = -torch.stack([dot(nx, in_dir), dot(ny, in_dir), dot(normal, in_dir)], dim=-1)
    nv = halfway(in_dir, direction)
    n = torch.stack([dot(nx, nv), dot(ny, nv), dot(normal, nv)], dim=-1)
    vdn = dot(v, n)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    r2 = roughness * roughness
    lam = (-1.0 + torch.sqrt(1.0 + (v0 * v0 + v1 * v1) * r2 / (v2 * v2))) / 2.0
    g1 = 1.0 / (1.0 + lam)
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    len_ns = (n0 * n0 + n1 * n1) / (roughness * roughness) + n2 * n2
    dn = 1.0 / (PI * roughness * roughness * len_ns * len_ns)
    dv = g1 * vdn * dn / torch.clamp_min(v2, eps)
    res = dv / (4.0 * vdn)
    return torch.where(vdn <= 0, torch.zeros_like(res), res)


def light_triangle_sample(x, tri_a, tri_b, tri_c, u, v) -> torch.Tensor:
    """triangle_dist::sample (src/raytracer.h:225-239): uniform point on the
    triangle (square fold), then the direction from x."""
    flip = (u + v) > 1.0
    uu = torch.where(flip, 1.0 - u, u)
    vv = torch.where(flip, 1.0 - v, v)
    p = tri_a + (tri_b - tri_a) * vv[..., None] + (tri_c - tri_a) * uu[..., None]
    return normalize(p - x)


def pick_uniform(u: torch.Tensor, count: int) -> torch.Tensor:
    """Uniform integer in [0, count) from a U[0,1) draw."""
    idx = torch.floor(u * float(count)).to(torch.int32)
    return torch.clamp(idx, 0, max(count - 1, 0))


# --- BSDF (ops/bsdf.py) ---


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x**5 in XLA's integer_pow order: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """heaviside (src/raytracer.h:264-266): strictly positive -> 1."""
    return (x > 0).to(x.dtype)


def specular_brdf(alpha, in_dir, out_dir, normal) -> torch.Tensor:
    """specular_brdf (src/raytracer.h:273-293): GGX NDF x Smith visibility."""
    h = halfway(in_dir, out_dir)
    ndh = dot(normal, h)
    a2 = alpha * alpha
    den = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 * heaviside(ndh) / (PI * (den * den))
    ndo = dot(normal, out_dir)
    ndi = dot(normal, -in_dir)
    div1 = torch.abs(ndo) + torch.sqrt(a2 + (1.0 - a2) * ndo * ndo)
    div2 = torch.abs(ndi) + torch.sqrt(a2 + (1.0 - a2) * ndi * ndi)
    v = heaviside(dot(h, out_dir)) * heaviside(dot(h, -in_dir)) / (div1 * div2)
    return v * d


def diffuse_brdf(color: torch.Tensor) -> torch.Tensor:
    """diffuse_brdf (src/raytracer.h:295-298): Lambert / pi."""
    return color / PI


def conductor_fresnel(f0, bsdf, vdh) -> torch.Tensor:
    """conductor_fresnel (src/raytracer.h:267-271)."""
    return bsdf * (f0 + (1.0 - f0) * _pow5(1.0 - torch.abs(vdh)))


def fresnel_mix(ior, base, layer, vdh) -> torch.Tensor:
    """fresnel_mix (src/raytracer.h:300-306)."""
    r = (1.0 - ior) / (1.0 + ior)
    f0 = r * r
    fr = f0 + (1.0 - f0) * _pow5(1.0 - torch.abs(vdh))
    return base * (1.0 - fr[..., None]) + layer * fr[..., None]


def pbr_brdf(
    in_dir, out_dir, shading_normal, base_color, metallic, roughness, ior,
    min_roughness: float,
) -> torch.Tensor:  # [R, 3]
    """pbr_brdf (src/raytracer.h:330-343): metallic lerp of the dielectric
    and metallic BRDFs, with the reference's branch guards kept as selects
    (observable where the unused branch is NaN/inf)."""
    a = torch.clamp_min(roughness, min_roughness)
    alpha = a * a
    spec = specular_brdf(alpha, in_dir, out_dir, shading_normal)[..., None]
    spec3 = spec.expand(base_color.shape)
    vdh = dot(-in_dir, halfway(in_dir, out_dir))
    dielectric = fresnel_mix(ior, diffuse_brdf(base_color), spec3, vdh)
    metal = conductor_fresnel(base_color, spec3, vdh[..., None])
    m = metallic[..., None]
    zero = torch.zeros_like(dielectric)
    res = torch.where(m < 1.0, (1.0 - m) * dielectric, zero)
    return res + torch.where(m > 0.0, m * metal, zero)


# --- texture fetch (ops/texture.py), flat texel pool ---


def _mod1(x: torch.Tensor) -> torch.Tensor:
    """Floored modulo by 1.0 (``jnp.mod`` semantics: result in [0, 1))."""
    m = torch.fmod(x, 1.0)
    return torch.where((m != 0) & (m < 0), m + 1.0, m)


def _wrap_repeat(x: torch.Tensor) -> torch.Tensor:
    """wrap_repeat (src/geometry.h:517-519): fmod(fmod(x, 1) + 1, 1)."""
    return _mod1(_mod1(x) + 1.0)


def _corners(atlas: TextureAtlas, tex_ids: torch.Tensor, uv: torch.Tensor):
    """Shared index math of ``sample``/``sample_many``: per (ray, texture)
    atlas offset, dims, integer texel and the fractional lerp weights."""
    ids = tex_ids.long()
    off = atlas.offset[ids]
    w = atlas.width[ids]
    h = atlas.height[ids]
    u = _wrap_repeat(uv[:, 0]).reshape((-1,) + (1,) * (tex_ids.dim() - 1))
    v = _wrap_repeat(uv[:, 1]).reshape((-1,) + (1,) * (tex_ids.dim() - 1))
    tx = u * w.to(uv.dtype)
    ty = v * h.to(uv.dtype)
    px = torch.minimum(tx.to(torch.int32), w - 1)  # trunc toward 0 (tx >= 0)
    py = torch.minimum(ty.to(torch.int32), h - 1)
    dx = tx - px.to(uv.dtype)
    dy = ty - py.to(uv.dtype)
    # mod_inc (src/geometry.h:521-523)
    px1 = torch.where(px == w - 1, torch.zeros_like(px), px + 1)
    py1 = torch.where(py == h - 1, torch.zeros_like(py), py + 1)
    return off, w, h, px, py, px1, py1, dx, dy


def sample(
    atlas: TextureAtlas, tex_id: torch.Tensor, uv: torch.Tensor, gamma: float = 1.0
) -> torch.Tensor:  # [R, 4]
    """Texture::sample (src/geometry.h:545-582) for one texture per ray."""
    off, w, h, px, py, px1, py1, dx, dy = _corners(atlas, tex_id, uv)
    dx, dy = dx[:, None], dy[:, None]

    def decode(c):
        if gamma != 1.0:
            c = torch.cat([torch.pow(c[:, :3], gamma), c[:, 3:]], dim=-1)
        return c

    if atlas.quad is not None:
        rows = atlas.quad[(off + px + py * w).long()]  # [R, 16]
        c00, c01, c10, c11 = (decode(rows[:, 4 * i:4 * i + 4]) for i in range(4))
        raw = rows[:, 0:4]
    else:
        tex = atlas.texels
        c00 = decode(tex[(off + px + py * w).long()])
        c01 = decode(tex[(off + px + py1 * w).long()])
        c10 = decode(tex[(off + px1 + py * w).long()])
        c11 = decode(tex[(off + px1 + py1 * w).long()])
        raw = tex[off.long()]
    bilinear = (1 - dx) * ((1 - dy) * c00 + dy * c01) + dx * ((1 - dy) * c10 + dy * c11)
    single = ((w * h) == 1)[:, None]
    return torch.where(single, raw, bilinear)


def env_radiance(
    atlas: TextureAtlas,
    env_tex: int,  # atlas id of the environment map
    bg_color: torch.Tensor,  # [3]
    direction: torch.Tensor,  # [R, 3] (unit)
) -> torch.Tensor:  # [R, 3]
    """Scene::bg_at equirect lookup (src/scene.h:83-89): gamma-2.2 decoded
    bilinear fetch at (u, v) from the direction, times ``bg_color``."""
    d = direction
    u = 0.5 + 0.5 * torch.atan2(d[:, 2], d[:, 0]) / math.pi
    v = 0.5 - torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    tex_ids = torch.full(d.shape[:1], env_tex, dtype=torch.int32, device=d.device)
    c = sample(atlas, tex_ids, torch.stack([u, v], dim=-1), 2.2)
    return bg_color[None, :] * c[:, :3]


# --- dense Woop sweep and dense light pdf (ops/intersect.py) ---


class Hit(NamedTuple):
    t: torch.Tensor  # [R] float32 (inf on miss)
    tri: torch.Tensor  # [R] int32 (0 on miss; gate on .hit)
    beta: torch.Tensor  # [R] barycentric along (b - a)
    gamma: torch.Tensor  # [R] barycentric along (c - a)
    hit: torch.Tensor  # [R] bool


def _block_best(rays: torch.Tensor, woop_block: torch.Tensor, min_dst: float):
    """Closest valid hit within one triangle block: (t [R], local idx [R])."""
    r = rays.shape[0] // 2
    y = (rays @ woop_block).reshape(2, r, -1, 3)
    p, q = y[0], y[1]  # [R, B, 3]
    t = -p[..., 2] / q[..., 2]
    beta = p[..., 0] + t * q[..., 0]
    gamma = p[..., 1] + t * q[..., 1]
    ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst)
    t_m = torch.where(ok, t, torch.full_like(t, float("inf")))
    best, idx = torch.min(t_m, dim=-1)  # first index of the minimum
    return best, idx.to(torch.int32)


def winner_barycentrics(o1: torch.Tensor, d0: torch.Tensor, w: torch.Tensor):
    """(t, beta, gamma) of each ray against its winning triangle's Woop
    block ``w`` [R, 4 (coefficient), 3 (component)], from the homogeneous
    rays o1 = (o, 1) and d0 = (d, 0).  The four-term dot products are
    summed in one fixed order, so the dense sweep and the chunk cascade
    give identical barycentrics for the same triangle on any device."""

    def dotw(vec, j):
        acc = vec[:, 0] * w[:, 0, j] + vec[:, 1] * w[:, 1, j]
        return (acc + vec[:, 2] * w[:, 2, j]) + vec[:, 3] * w[:, 3, j]

    t = -dotw(o1, 2) / dotw(d0, 2)
    return t, dotw(o1, 0) + t * dotw(d0, 0), dotw(o1, 1) + t * dotw(d0, 1)


def _light_pdf_block(origin, direction, light_verts, light_normal, light_area,
                     lane_ok, min_dst) -> torch.Tensor:
    """[R] unnormalised projection-term sum over one block of lights."""
    a = light_verts[:, 0]
    av = light_verts[:, 1] - a
    au = light_verts[:, 2] - a
    o = origin[:, None, :]  # [R, 1, 3]
    d = direction[:, None, :]
    y = o - a[None]  # [R, L, 3]
    at = -d
    avb = av[None].expand(y.shape)
    aub = au[None].expand(y.shape)
    denom = dot(avb, cross(aub, at))
    beta = dot(y, cross(aub, at)) / denom
    gamma = dot(avb, cross(y, at)) / denom
    t = dot(avb, cross(aub, y)) / denom
    ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst) & lane_ok[None, :]
    dist2 = t * t * dot(d, d)
    proj = dist2 / torch.abs(dot(light_normal[None].expand(y.shape), d))
    contrib = torch.where(ok, proj / light_area[None], torch.zeros_like(proj))
    return torch.sum(contrib, dim=-1)


def light_pdf_sum(origin, direction, light_verts, light_normal, light_area,
                  light_count: int, min_dst: float) -> torch.Tensor:
    """All-hits light-mixture pdf, dense over every light
    (bvh_mix_dist::pdf, src/raytracer.h:363-376), in blocks of 128 lights.
    Returns sum / count."""
    cap = light_verts.shape[0]
    lane = torch.arange(cap, device=origin.device)
    total = torch.zeros(origin.shape[0], device=origin.device)
    for s in range(0, cap, _LIGHT_BLOCK):
        e = min(s + _LIGHT_BLOCK, cap)
        total = total + _light_pdf_block(
            origin, direction, light_verts[s:e], light_normal[s:e],
            light_area[s:e], lane[s:e] < light_count, min_dst,
        )
    return total / float(max(light_count, 1))


# --- threefry-2x32 counter stream (ops/rng.py, plain twin) ---


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


def lane_uniforms(seed: _Int, sample: _Int, depth: _Int, pixel: torch.Tensor,
                  n_draws: int) -> torch.Tensor:
    """[n_draws, R] U[0, 1) draws of the lanes (``sample``, ``depth``,
    ``pixel``) under the key words (0, seed mod 2^32)."""
    return lane_uniforms_key_plain(0, seed, sample, depth, pixel, n_draws)
