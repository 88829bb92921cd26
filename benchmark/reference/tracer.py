"""The plain reference path tracer: the reference renderer's estimator
(src/raytracer.h:512-627), one (pixel, sample) path at a time in batches,
with closest hits found by brute force over every triangle of the scene in
blocks (the dense Woop sweep) and the light pdf summed over every light.

A path's draws are the counter-based threefry stream keyed by (seed, pixel,
sample, depth), so a sample here is the program's sample draw for draw;
pixel sums differ only by rounding, except where rounding sends a path
another way.  ``precision="tf32"`` is the control: the sweep's product
with its inputs rounded to TF32 (10 mantissa bits, round to nearest even),
which is what a TF32 matrix product does to them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import twins as tw
from .scene import RefCamera, RefScene


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    NaN and infinity kept."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF) & 0xFFFFFFFF
    rounded = torch.where(rounded >= 0x80000000, rounded - (1 << 32), rounded)
    out = rounded.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


@contextlib.contextmanager
def full_float32():
    """Matrix products in full float32 on a CUDA card (no TF32)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def closest_hit(origin, direction, woop, min_dst: float, precision: str) -> tw.Hit:
    """Closest hit over every triangle: the dense Woop sweep (the program's
    ``ops/intersect.closest_hit``), ``[2R, 4] @ [4, 3B]`` per block of
    ``TRI_BLOCK`` triangles, then the winner's t and barycentrics in
    float32.  Under "tf32" the product's inputs are rounded to TF32."""
    r = origin.shape[0]
    ones = torch.ones((r, 1), dtype=origin.dtype, device=origin.device)
    o1 = torch.cat([origin, ones], dim=1)
    d0 = torch.cat([direction, ones * 0], dim=1)
    rays = torch.cat([o1, d0], dim=0)
    if precision == "tf32":
        rays, woop_in = tf32_round(rays), tf32_round(woop)
    else:
        woop_in = woop
    t = torch.full((r,), float("inf"), device=origin.device)
    tri = torch.zeros((r,), dtype=torch.int32, device=origin.device)
    for blk in range(woop.shape[1] // (3 * tw.TRI_BLOCK)):
        cols = slice(blk * 3 * tw.TRI_BLOCK, (blk + 1) * 3 * tw.TRI_BLOCK)
        tb, ib = tw._block_best(rays, woop_in[:, cols], min_dst)
        better = tb < t
        t = torch.where(better, tb, t)
        tri = torch.where(better, ib + blk * tw.TRI_BLOCK, tri)
    hit = torch.isfinite(t)
    tri = torch.where(hit, tri, torch.zeros_like(tri))
    cols = tri.long()[:, None] * 3 + torch.arange(3, device=origin.device)[None, :]
    t_r, beta, gamma = tw.winner_barycentrics(o1, d0, woop[:, cols].permute(1, 0, 2))
    zero = torch.zeros_like(beta)
    return tw.Hit(t=torch.where(hit, t_r, torch.full_like(t_r, float("inf"))), tri=tri,
                  beta=torch.where(hit, beta, zero), gamma=torch.where(hit, gamma, zero), hit=hit)


def camera_rays(cam: RefCamera, pixel: torch.Tensor, jitter: torch.Tensor):
    """Jittered pinhole rays (src/raytracer.h:527-538)."""
    w, h = cam.width, cam.height
    x = (pixel % w).to(torch.float32)
    y = (pixel // w).to(torch.float32)
    tx = torch.tan(cam.fov_x / 2)
    ty = tx * h / w
    cx = (2.0 * (x + jitter[0]) / w - 1.0) * tx
    cy = (2.0 * (y + jitter[1]) / h - 1.0) * ty
    d = tw.normalize(cx[:, None] * cam.right - cy[:, None] * cam.up + cam.forward[None, :])
    return d * 0.0 + cam.position, d


def _interp(attr: torch.Tensor, beta, gamma):
    """triangle::interop (src/geometry.h:497-502) of a per-vertex attribute
    [R, 3, k]."""
    wa = (1.0 - beta - gamma)[:, None]
    return wa * attr[:, 0] + beta[:, None] * attr[:, 1] + gamma[:, None] * attr[:, 2]


def surface(scene: RefScene, d, hit, use_textures: bool) -> dict:
    """to_intersection_info (src/bvh.h:80-121): normals, the texture taps of
    the slots some material uses, and the material of each hit."""
    tri = hit.tri.long()
    v = scene.verts[tri]
    mat = scene.material[tri]
    g = tw.normalize(tw.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    inside = tw.dot(g, d) > 0
    smooth = tw.normalize(_interp(scene.normals[tri], hit.beta, hit.gamma))
    smooth = tw.where3(tw.dot(g, smooth) < 0, -smooth, smooth)
    used = scene.slots if use_textures and scene.atlas.offset.shape[0] > 2 else (False,) * 4
    if any(used):
        uv = _interp(scene.uvs[tri], hit.beta, hit.gamma)
    tex = mat[:, 10:14].to(torch.int32)

    def fetch(slot, gamma):
        return tw.sample(scene.atlas, tex[:, slot], uv, gamma)

    shading = smooth
    if used[3]:
        tangent = tw.normalize(_interp(scene.tangents[tri], hit.beta, hit.gamma))
        local = tw.normalize(fetch(3, 1.0)[:, :3] * 2.0 - 1.0)
        shading = tw.normalize(tw.frame_apply(local, tangent, tw.cross(smooth, tangent), smooth))
    color = mat[:, 0:4] * fetch(0, 2.2) if used[0] else mat[:, 0:4]
    emission = mat[:, 4:7] * fetch(1, 2.2)[:, :3] if used[1] else mat[:, 4:7]
    metallic, roughness = mat[:, 7], mat[:, 8]
    if used[2]:
        mr = fetch(2, 1.0)
        metallic, roughness = metallic * mr[:, 2], roughness * mr[:, 1]
    flip = inside[:, None]
    return dict(normal=torch.where(flip, -g, g), shading_normal=torch.where(flip, -shading, shading),
                color=color, emission=emission, metallic=metallic, roughness=roughness,
                ior=mat[:, 9])


def bounce(scene: RefScene, render: dict, o, d, throughput, radiance, draws,
           precision: str = "float32"):
    """One bounce of live paths: the reference's ``shade``
    (src/raytracer.h:555-591).  Returns (o, d, throughput, radiance, moved)."""
    eps = float(render["eps"])
    vf = float(render["vndf_factor"])
    min_rough = float(render["min_roughness"])
    hit = closest_hit(o, d, scene.woop, eps, precision)
    if scene.env_tex != 0 and render["use_textures"]:
        env = tw.env_radiance(scene.atlas, scene.env_tex, scene.bg_color, d)
    else:
        env = scene.bg_color
    zero3 = torch.zeros_like(radiance)
    radiance = radiance + torch.where((~hit.hit)[:, None], throughput * env, zero3)
    info = surface(scene, d, hit, render["use_textures"])
    pos = o + hit.t[:, None] * d

    passthrough = hit.hit & (draws[0] > info["color"][:, 3])
    shade = hit.hit & ~passthrough
    radiance = radiance + torch.where(shade[:, None], throughput * info["emission"], zero3)

    a = torch.clamp_min(info["roughness"], min_rough)
    alpha_r2 = a * a
    vndf_dir = tw.vndf_sample(alpha_r2, d, info["shading_normal"], draws[2], draws[3])
    cos_dir = tw.cosine_sample(info["normal"], draws[5], draws[6])
    n = scene.n_lights
    if n > 0:
        pick_light = tw.pick_uniform(draws[4], 2) == 1
        lv = scene.light_verts.reshape(-1, 9)[tw.pick_uniform(draws[7], n).long()]
        light_dir = tw.light_triangle_sample(pos, lv[:, 0:3], lv[:, 3:6], lv[:, 6:9],
                                             draws[8], draws[9])
        mix_dir = tw.where3(pick_light, light_dir, cos_dir)
    else:
        mix_dir = cos_dir
    new_dir = tw.where3(draws[1] <= vf, vndf_dir, mix_dir)

    p_vndf = tw.vndf_pdf(alpha_r2, d, info["shading_normal"], new_dir, eps)
    p_cos = tw.cosine_pdf(info["normal"], new_dir)
    if n > 0:
        p_light = tw.light_pdf_sum(pos, new_dir, scene.light_verts, scene.light_normal,
                                   scene.light_area, n, eps)
        p_mix = (p_cos + p_light) / 2.0
    else:
        p_mix = p_cos
    p = vf * p_vndf + (1.0 - vf) * p_mix
    f = tw.pbr_brdf(d, new_dir, info["shading_normal"], info["color"][:, :3],
                    info["metallic"], info["roughness"], info["ior"], min_rough)
    scl = f * (torch.clamp_min(tw.dot(new_dir, info["shading_normal"]), 0.0) / p)[:, None]
    kill = torch.isnan(new_dir).any(dim=-1) | (p < eps) | (tw.length2(scl) == 0.0)
    cont = shade & ~kill
    throughput = torch.where(cont[:, None], throughput * scl, throughput)
    moved = passthrough | cont
    return tw.where3(moved, pos, o), tw.where3(cont, new_dir, d), throughput, radiance, moved


def trace(scene: RefScene, render: dict, seed: int, pixel: torch.Tensor, sample: torch.Tensor,
          precision: str = "float32") -> torch.Tensor:
    """[R, 3] radiance of the paths (``pixel``, ``sample``) (int64 [R] on the
    scene's device), NaN channels zeroed as the reference's
    ``sanitize_nans`` does."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}: expected float32 | tf32")
    o, d = camera_rays(scene.camera, pixel, tw.lane_uniforms(seed, sample, tw.JITTER_DEPTH,
                                                            pixel, 2))
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    out = torch.zeros_like(o)
    live = torch.nonzero(torch.isfinite(o[:, 0])).squeeze(1)
    with full_float32():
        for depth in range(scene.ray_depth):
            if live.numel() == 0:
                break
            draws = tw.lane_uniforms(seed, sample[live], depth, pixel[live], 10)
            no, nd, tp, rad, moved = bounce(scene, render, o[live], d[live], throughput[live],
                                            radiance[live], draws, precision)
            exhausted = moved & (depth + 1 >= scene.ray_depth)
            rad = rad + torch.where(exhausted[:, None], tp * 0.0, torch.zeros_like(rad))
            done = ~moved | exhausted
            out[live[done]] = torch.where(torch.isnan(rad[done]), torch.zeros_like(rad[done]),
                                          rad[done])
            o[live], d[live], throughput[live], radiance[live] = no, nd, tp, rad
            live = live[~done]
    return out


def pixel_sums(scene: RefScene, render: dict, seed: int, pixels: np.ndarray, samples: int,
               sample_base: int = 0, precision: str = "float32", batch: int = 16384) -> np.ndarray:
    """[P, 3] float64 sums over samples ``sample_base .. sample_base +
    samples - 1`` of each pixel, traced in batches of ``batch`` paths."""
    dev = scene.woop.device
    pix = torch.as_tensor(np.repeat(pixels.astype(np.int64), samples), device=dev)
    smp = torch.as_tensor(np.tile(np.arange(samples, dtype=np.int64) + sample_base,
                                  pixels.shape[0]), device=dev)
    sums = torch.zeros((pixels.shape[0], 3), dtype=torch.float64, device=dev)
    row = torch.arange(pixels.shape[0], device=dev).repeat_interleave(samples)
    for s in range(0, pix.shape[0], batch):
        rad = trace(scene, render, seed, pix[s:s + batch], smp[s:s + batch], precision)
        sums.index_add_(0, row[s:s + batch], rad.to(torch.float64))
    return sums.cpu().numpy()
