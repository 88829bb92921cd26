"""Dense ray-triangle intersection and the all-hits light pdf (port of
``tpu_pathtracer/ops/intersect.py:93-318``).

``light_pdf_flat`` dispatches the flat light-cluster pdf: kernel K1
(``csrc/shade_kernels.cu``) on CUDA tensors, its plain twin
``light_pdf_sum_flat`` on CPU tensors.

``closest_hit`` is the dense Woop sweep: ``[2R, 4] @ [4, 3B]`` per triangle
block of ``TRI_BLOCK`` followed by the t/barycentric epilogue and a per-ray
min.  The render uses it for scenes of at most 1,024 triangles, and it is the
on-card oracle of the chunk cascade.  The product must run in full float32:
callers on CUDA keep TF32 off (the JAX package contracts at
``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import cross, dot

TRI_BLOCK = 1024
_LIGHT_BLOCK = 128


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


def closest_hit(
    origin: torch.Tensor,  # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    woop: torch.Tensor,  # [4, 3N]
    min_dst: float,
) -> Hit:
    """Closest hit over the whole triangle soup (dense min-reduction)."""
    r = origin.shape[0]
    n = woop.shape[1] // 3
    ones = torch.ones((r, 1), dtype=origin.dtype, device=origin.device)
    o1 = torch.cat([origin, ones], dim=1)
    d0 = torch.cat([direction, ones * 0], dim=1)
    rays = torch.cat([o1, d0], dim=0)  # [2R, 4]
    if n <= TRI_BLOCK:
        t, tri = _block_best(rays, woop, min_dst)
    else:
        if n % TRI_BLOCK:
            raise ValueError("scene capacity must be a multiple of TRI_BLOCK")
        t = torch.full((r,), float("inf"), device=origin.device)
        tri = torch.zeros((r,), dtype=torch.int32, device=origin.device)
        for blk in range(n // TRI_BLOCK):
            wb = woop[:, blk * 3 * TRI_BLOCK:(blk + 1) * 3 * TRI_BLOCK]
            tb, ib = _block_best(rays, wb, min_dst)
            better = tb < t
            t = torch.where(better, tb, t)
            tri = torch.where(better, ib + blk * TRI_BLOCK, tri)
    hit = torch.isfinite(t)
    tri_safe = torch.where(hit, tri, torch.zeros_like(tri))
    cols = tri_safe.long()[:, None] * 3 + torch.arange(3, device=origin.device)[None, :]
    t_r, beta, gamma = winner_barycentrics(o1, d0, woop[:, cols].permute(1, 0, 2))
    zero = torch.zeros_like(beta)
    return Hit(
        t=torch.where(hit, t_r, torch.full_like(t_r, float("inf"))),
        tri=tri_safe,
        beta=torch.where(hit, beta, zero),
        gamma=torch.where(hit, gamma, zero),
        hit=hit,
    )


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


def light_pdf_sum_flat(origin, direction, cluster_woop, cluster_k,
                       light_count: int, min_dst: float) -> torch.Tensor:
    """The same all-hits pdf over the packed light clusters: per cluster the
    projection term ``t^2 |d|^2 k / |q_n|`` on the Woop contraction, written
    in the cluster kernel's operation order.  Invalid/padded lights carry
    NaN Woop rows and k = 0, so they contribute exactly 0."""
    o, d = origin, direction
    d2 = torch.sum(d * d, dim=1, keepdim=True)
    total = torch.zeros(origin.shape[0], device=origin.device)
    for ci in range(cluster_woop.shape[0]):
        w = cluster_woop[ci]  # [12, CL]
        k = cluster_k[ci]

        def co(r0):
            acc = o[:, 0:1] * w[r0][None, :] + w[r0 + 3][None, :]
            acc = acc + o[:, 1:2] * w[r0 + 1][None, :]
            return acc + o[:, 2:3] * w[r0 + 2][None, :]

        def cd(r0):
            acc = d[:, 0:1] * w[r0][None, :]
            acc = acc + d[:, 1:2] * w[r0 + 1][None, :]
            return acc + d[:, 2:3] * w[r0 + 2][None, :]

        p0, p1, p2 = co(0), co(4), co(8)
        q0, q1, q2 = cd(0), cd(4), cd(8)
        t = -p2 / q2
        beta = p0 + t * q0
        gamma = p1 + t * q1
        ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= min_dst)
        term = t * t * d2 * k[None, :] / torch.abs(q2)
        total = total + torch.sum(torch.where(ok, term, torch.zeros_like(term)), dim=1)
    return total / float(max(light_count, 1))


def light_pdf_flat(origin, direction, cluster_woop, cluster_k, light_count: int,
                   min_dst: float) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain twin
    ``light_pdf_sum_flat`` for CPU tensors (same contract; the kernel sums a
    cluster's terms in its own order, so the two agree to rounding)."""
    if origin.is_cuda:
        from .. import kernels

        return kernels.light_pdf_flat(origin.contiguous(), direction.contiguous(), cluster_woop,
                                      cluster_k, light_count, min_dst)
    if origin.device.type == "cpu":
        return light_pdf_sum_flat(origin, direction, cluster_woop, cluster_k, light_count, min_dst)
    raise RuntimeError(f"light_pdf_flat: no kernel for device {origin.device}")
