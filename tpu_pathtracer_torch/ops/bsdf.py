"""glTF metallic-roughness BSDF (port of ``tpu_pathtracer/ops/bsdf.py``).

``alpha`` is the clamped roughness squared, and ``specular_brdf`` squares it
again, exactly like the reference (src/raytracer.h:277-279).  Integer powers
are written as the multiplications XLA lowers them to, so the two packages
round alike.
"""

from __future__ import annotations

import math

import torch

from .sampling import halfway
from .vecmath import dot

PI = math.pi


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
