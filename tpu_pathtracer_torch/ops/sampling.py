"""Direction-sampling distributions (port of ``tpu_pathtracer/ops/sampling.py``).

Pure functions over ``[R, 3]`` batches taking their uniforms explicitly, so
the caller controls the counter-based RNG layout.  Operation order follows
the JAX functions term for term.
"""

from __future__ import annotations

import math

import torch

from .vecmath import constant, cross, dot, frame_apply, normalize, reflect

PI = math.pi


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
