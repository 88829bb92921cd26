"""Bilinear texture fetch from the shared atlas (port of
``tpu_pathtracer/ops/texture.py:25-170``).

Repeat-wrap, bilinear, per-texel gamma decode before the lerp; a 1x1 texture
returns its raw texel with no gamma (src/geometry.h:548-550).  Both the flat
``[T, 4]`` texel pool and the corner-quad ``[T, 16]`` pool are supported and
give the same values.  ``env_radiance`` is the equirectangular environment
lookup of rays that leave the scene.
"""

from __future__ import annotations

import math

import torch

from ..scene.types import TextureAtlas


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


def sample_many(
    atlas: TextureAtlas,
    tex_ids: torch.Tensor,  # [R, K] int32 (K textures sampled at the same uv)
    uv: torch.Tensor,  # [R, 2]
    gammas,  # length-K tuple of floats
) -> torch.Tensor:  # [R, 4K], lane = tex*4 + channel
    """Fused K-texture bilinear fetch at one uv; equal to K ``sample`` calls."""
    k = tex_ids.shape[1]
    n = tex_ids.shape[0]
    off, w, h, px, py, px1, py1, dx, dy = _corners(atlas, tex_ids, uv)
    if atlas.quad is not None:
        rows = atlas.quad[(off + px + py * w).long()]  # [R, K, 16] = (k, corner, ch)
        flat0 = rows.reshape(n, k, 4, 4).transpose(1, 2).reshape(n, 16 * k)
    else:
        idx = torch.stack(
            [off + px + py * w, off + px + py1 * w,
             off + px1 + py * w, off + px1 + py1 * w],
            dim=1,
        )  # [R, corner, K]
        flat0 = atlas.texels[idx.reshape(n, -1).long()].reshape(n, 16 * k)
    gam_lane = torch.tensor(
        [gammas[kk] if ch < 3 else 1.0
         for _corner in range(4) for kk in range(k) for ch in range(4)],
        dtype=uv.dtype, device=uv.device,
    )[None, :]
    # gamma-1 lanes bypass pow entirely, as in the JAX package.
    dec = torch.where(gam_lane == 1.0, flat0, torch.pow(flat0, gam_lane))
    c00, c01, c10, c11 = (dec[:, i * 4 * k:(i + 1) * 4 * k] for i in range(4))
    wx = torch.repeat_interleave(dx, 4, dim=1)  # [R, 4K], lane = tex*4 + ch
    wy = torch.repeat_interleave(dy, 4, dim=1)
    bilinear = (1 - wx) * ((1 - wy) * c00 + wy * c01) + wx * (
        (1 - wy) * c10 + wy * c11
    )
    single = torch.repeat_interleave((w * h) == 1, 4, dim=1)
    return torch.where(single, flat0[:, 0:4 * k], bilinear)


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
