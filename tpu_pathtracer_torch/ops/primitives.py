"""Analytic-primitive intersection: PLANE / ELLIPSOID / BOX / TRIANGLE (port
of ``tpu_pathtracer/ops/primitives.py``).

A homebrew primitive is a local-space shape plus a position and a rotation
quaternion; each ray is taken into every primitive's local frame.  The
scenes hold tens of primitives, so the brute force over ``[R, P]`` pairs is
the acceleration structure, in plain torch: rays go through in slices of at
most ``PAIR_BUDGET // P`` so the ``[R, P, 3]`` temporaries stay bounded.

IEEE behaviour kept from the reference: a plane's ``t = -dot / dot`` may be
+-inf or NaN and ``isfinite`` filters it, the ellipsoid takes
``sqrt(max(h2, 0))``, and a tie in the closest ``t`` goes to the lowest
primitive index (``argmin`` returns the first minimum).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.types import PRIM_BOX, PRIM_ELLIPSOID, PRIM_PLANE, PrimitiveScene
from .vecmath import cross, dot, normalize

# (ray, primitive) pairs per slice of ``closest_hit``.
PAIR_BUDGET = 1 << 21


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit quaternion q=(x,y,z,w): the reference's
    ``operator*(vec3, quaternion)`` (src/geometry.h:143-147)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


class PrimHit(NamedTuple):
    t: torch.Tensor  # [R] float32 (inf on miss)
    prim: torch.Tensor  # [R] int32
    normal: torch.Tensor  # [R, 3] world-space, flipped to face the ray
    inside: torch.Tensor  # [R] bool (ray origin inside the solid)
    hit: torch.Tensor  # [R] bool


def _closest_hit_slice(origin, direction, scene: PrimitiveScene, min_dst: float) -> PrimHit:
    q = scene.rotation[None, :, :]  # [1, P, 4]
    qc = quat_conj(q)
    lo = quat_rotate(qc, origin[:, None, :] - scene.position[None])  # [R, P, 3]
    ld = quat_rotate(qc, direction[:, None, :])

    kind = scene.kind[None, :]  # [1, P]
    par = scene.param[None]  # [1, P, 9]

    # --- PLANE: local plane through origin with normal n -------------------
    n_pl = par[..., 0:3]
    t_pl = -dot(lo, n_pl) / dot(ld, n_pl)
    ok_pl = torch.isfinite(t_pl) & (t_pl >= min_dst)
    in_pl = torch.zeros_like(ok_pl)
    nrm_pl = n_pl.expand(lo.shape)

    # --- ELLIPSOID: scaled unit sphere (src/raytracer.h:61-77) -------------
    rad = par[..., 0:3]
    lor = lo / rad
    ldr = ld / rad
    a = dot(ldr, ldr)
    hb = dot(lor, ldr)
    c = dot(lor, lor) - 1.0
    h2 = hb * hb - a * c
    hd = torch.sqrt(torch.clamp_min(h2, 0.0))
    t1 = (-hb - hd) / a
    t2 = (-hb + hd) / a
    in_el = (t1 < min_dst) & (t2 >= min_dst)
    t_el = torch.where(t1 >= min_dst, t1, t2)
    ok_el = (h2 >= 0) & (t_el >= min_dst)
    p_el = lo + t_el[..., None] * ld
    nrm_el = normalize(p_el / (rad * rad))

    # --- BOX: slab test against half-sizes s -------------------------------
    s = par[..., 0:3]
    i1 = (-s - lo) / ld
    i2 = (s - lo) / ld
    tn = torch.amax(torch.minimum(i1, i2), dim=-1)
    tf = torch.amin(torch.maximum(i1, i2), dim=-1)
    in_bx = tn < min_dst
    t_bx = torch.where(tn >= min_dst, tn, tf)
    ok_bx = (tn <= tf) & (t_bx >= min_dst)
    p_bx = lo + t_bx[..., None] * ld
    rel = p_bx / s
    ax = torch.argmax(torch.abs(rel), dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=rel.dtype, device=rel.device)
    nrm_bx = torch.sign(torch.gather(rel, -1, ax)) * eye[ax[..., 0]]

    # --- TRIANGLE: Cramer in local space (src/bvh.h:36-50 math) ------------
    ta = par[..., 0:3]
    av = par[..., 3:6] - ta
    au = par[..., 6:9] - ta
    y = lo - ta
    at = -ld
    denom = dot(av, cross(au, at))
    av_b, au_b = av.expand(y.shape), au.expand(y.shape)
    beta = dot(y, cross(au_b, at)) / denom
    gamma = dot(av_b, cross(y, at)) / denom
    t_tr = dot(av_b, cross(au_b, y)) / denom
    ok_tr = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t_tr >= min_dst)
    in_tr = torch.zeros_like(ok_tr)
    nrm_tr = normalize(cross(av, au)).expand(lo.shape)

    def sel(pl, el, bx, tr):
        k = kind if pl.dim() == 2 else kind[..., None]
        return torch.where(
            k == PRIM_PLANE, pl,
            torch.where(k == PRIM_ELLIPSOID, el, torch.where(k == PRIM_BOX, bx, tr)),
        )

    t = sel(t_pl, t_el, t_bx, t_tr)
    ok = sel(ok_pl, ok_el, ok_bx, ok_tr) & scene.valid[None, :]
    inside = sel(in_pl, in_el, in_bx, in_tr)
    nrm_local = sel(nrm_pl, nrm_el, nrm_bx, nrm_tr)

    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    best = torch.argmin(t, dim=-1, keepdim=True)  # [R, 1]
    t_best = torch.gather(t, 1, best)[:, 0]
    hit = torch.isfinite(t_best)

    nrm_l = torch.gather(nrm_local, 1, best[:, :, None].expand(-1, 1, 3))[:, 0]
    inside_best = torch.gather(inside, 1, best)[:, 0]
    best = best[:, 0]
    nrm_w = normalize(quat_rotate(scene.rotation[best], nrm_l))
    # Flip to face the incoming ray (two-sided shading, as the triangle path
    # does via is_inside, src/bvh.h:92,111-112).
    facing = dot(nrm_w, direction) > 0
    nrm_w = torch.where(facing[:, None], -nrm_w, nrm_w)
    return PrimHit(t=t_best, prim=best.to(torch.int32), normal=nrm_w, inside=inside_best, hit=hit)


def closest_hit(
    origin: torch.Tensor,  # [R, 3]
    direction: torch.Tensor,  # [R, 3]
    scene: PrimitiveScene,
    min_dst: float,
) -> PrimHit:
    """Closest primitive hit per ray at ``t >= min_dst``."""
    r = origin.shape[0]
    step = max(1, PAIR_BUDGET // scene.capacity)
    if r <= step:
        return _closest_hit_slice(origin, direction, scene, min_dst)
    parts = [_closest_hit_slice(origin[i:i + step], direction[i:i + step], scene, min_dst)
             for i in range(0, r, step)]
    return PrimHit(*(torch.cat(field) for field in zip(*parts)))
