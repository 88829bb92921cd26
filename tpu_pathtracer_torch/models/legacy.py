"""Integrators for the homebrew scene format (port of
``tpu_pathtracer/models/legacy.py``).

* **Whitted mode** (no SAMPLES keyword, hw2/3 scenes): deterministic
  recursive ray tracing.  Diffuse surfaces gather ambient + shadow-tested
  point/directional lights with distance attenuation; METALLIC surfaces are
  perfect mirrors tinted by COLOR; DIELECTRIC surfaces split into
  Schlick-weighted reflection and refraction (the refracted part tinted by
  COLOR on entry).  The recursion runs as a wavefront depth-first search:
  every ray carries a stack of pending (origin, dir, weight, depth) entries
  and each iteration pops one entry per ray.

* **Monte-Carlo mode** (SAMPLES present, practice5+ scenes): a wavefront path
  tracer with the course's material semantics: diffuse = cosine-sampled
  bounce with albedo throughput, metallic = mirror bounce, dielectric =
  Schlick-probability reflect/refract Russian roulette.

Plain torch: the scenes hold tens of primitives and no kernel of the JAX
package runs here either.  The loops are eager; the Whitted search reads
one flag from the device per iteration.  The Monte-Carlo draws follow the
JAX package's key chain (``ops.rng.fold_in``), so both packages draw the
same numbers for every (seed, pixel, sample, bounce).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.primitives import closest_hit
from ..ops.rng import JITTER_DEPTH, fold_in, key_words, per_pixel_uniforms
from ..ops.sampling import cosine_sample
from ..ops.vecmath import dot, normalize, reflect, where3
from ..scene.types import MAT_DIELECTRIC, MAT_DIFFUSE, MAT_METALLIC, PrimitiveScene
from .pathtracer import gen_rays, sanitize_nans

# The ids of the light slots a scene fills: (directional, point).
_Lights = Tuple[List[int], List[int]]


def _schlick(cos_i: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    # Integer powers as XLA evaluates them (x ** 2 = x * x, x ** 5 =
    # x * ((x * x) * (x * x))), so both packages round alike.
    q = (1.0 - ior) / (1.0 + ior)
    r0 = q * q
    x = 1.0 - cos_i
    return r0 + (1.0 - r0) * (x * ((x * x) * (x * x)))


def _refract(d, n, eta, cos_i):
    """Refract d about n (n faces the ray, cos_i = -<d,n> >= 0).  Returns
    (dir, total internal reflection mask)."""
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(refr), tir


def _filled_lights(scene: PrimitiveScene) -> _Lights:
    """The light slots the parser filled (one host read per render): an
    empty slot adds exactly 0 to the irradiance, so it is skipped."""
    ids = lambda valid: [i for i, v in enumerate(valid.tolist()) if v]
    return ids(scene.dir_light_valid), ids(scene.point_light_valid)


def _direct_light(scene: PrimitiveScene, lights: _Lights, pos, normal, eps):
    """Ambient + shadow-tested directional/point lights -> [R, 3] irradiance."""
    total = scene.ambient.expand(pos.shape)
    zero = torch.zeros_like(pos)
    dir_ids, point_ids = lights

    for i in dir_ids:
        ld = scene.dir_light_dir[i].expand(pos.shape)
        sh = closest_hit(pos, ld, scene, eps)
        lam = torch.clamp_min(dot(normal, ld), 0.0)
        total = total + torch.where(
            (~sh.hit & (lam > 0))[:, None], scene.dir_light_intensity[i] * lam[:, None], zero
        )

    for i in point_ids:
        att = scene.point_light_atten[i]
        lvec = scene.point_light_pos[i] - pos
        dist = torch.sqrt(dot(lvec, lvec))
        ld = lvec / dist[:, None]
        sh = closest_hit(pos, ld, scene, eps)
        lit = ~sh.hit | (sh.t > dist)
        lam = torch.clamp_min(dot(normal, ld), 0.0)
        atten = 1.0 / (att[0] + att[1] * dist + att[2] * dist * dist)
        total = total + torch.where(
            (lit & (lam > 0))[:, None], scene.point_light_intensity[i] * (lam * atten)[:, None],
            zero,
        )
    return total


# Whitted stack: a two-way split tree of depth d needs at most d + 1 pending
# entries per ray, so the stack has max(this, depth + 1) slots.  Subtrees of
# weight at most the cutoff are pruned.
_WHITTED_STACK = 12
_WHITTED_CUTOFF = 1e-4


def _whitted_trace(scene: PrimitiveScene, lights: _Lights, origin, direction, depth: int,
                   eps: float) -> torch.Tensor:
    """Deterministic Whitted tracing as a wavefront depth-first search: each
    iteration pops one stack entry per ray, shades it and pushes its
    reflected and refracted children; it ends once every stack is empty."""
    r = origin.shape[0]
    dev = origin.device
    c = max(_WHITTED_STACK, depth + 1)

    st_o = torch.zeros((r, c, 3), device=dev)
    st_d = torch.zeros((r, c, 3), device=dev)
    st_w = torch.zeros((r, c, 3), device=dev)
    st_dep = torch.zeros((r, c), dtype=torch.int32, device=dev)
    st_o[:, 0] = origin
    st_d[:, 0] = direction
    st_w[:, 0] = 1.0
    st_dep[:, 0] = depth
    top = torch.ones((r,), dtype=torch.int32, device=dev)
    radiance = torch.zeros((r, 3), device=dev)
    zero3 = torch.zeros((r, 3), device=dev)
    slots = torch.arange(c, device=dev)

    def push(mask, o_new, d_new, w_new, dep_new):
        nonlocal st_o, st_d, st_w, st_dep, top
        at = mask[:, None] & (slots[None, :] == torch.clamp_max(top, c - 1)[:, None])  # [R, C]
        st_o = torch.where(at[:, :, None], o_new[:, None, :], st_o)
        st_d = torch.where(at[:, :, None], d_new[:, None, :], st_d)
        st_w = torch.where(at[:, :, None], w_new[:, None, :], st_w)
        st_dep = torch.where(at, dep_new[:, None], st_dep)
        top = torch.where(mask, torch.clamp_max(top + 1, c), top)

    running = True
    while running:
        active = top > 0
        slot = torch.clamp_min(top - 1, 0).long()
        take3 = lambda st: torch.gather(st, 1, slot[:, None, None].expand(r, 1, 3))[:, 0]
        o, d, w = take3(st_o), take3(st_d), take3(st_w)
        dep = torch.gather(st_dep, 1, slot[:, None])[:, 0]
        top = torch.where(active, top - 1, top)

        hit = closest_hit(o, d, scene, eps)
        live = active & hit.hit
        pos = torch.where(live[:, None], o + hit.t[:, None] * d, o)
        prim = hit.prim.long()
        mat = scene.mat_kind[prim]
        color = scene.color[prim]
        ior = scene.ior[prim]
        n = hit.normal

        # Local term: miss -> bg; diffuse -> lit (or flat for stage-1 scenes).
        if scene.lit:
            diffuse = color * _direct_light(scene, lights, pos + n * eps, n, eps)
        else:
            diffuse = color
        local = torch.where(
            live[:, None], torch.where((mat == MAT_DIFFUSE)[:, None], diffuse, zero3),
            scene.bg_color.expand(r, 3),
        )
        radiance = radiance + torch.where(active[:, None], w * local, zero3)

        # Children: the mirror branch (metallic, dielectric reflection) and
        # the dielectric refraction branch.
        rdir = normalize(reflect(n, d))
        cos_i = torch.clamp_min(-dot(d, n), 0.0)
        eta = torch.where(hit.inside, ior, 1.0 / ior)
        refr_dir, tir = _refract(d, n, eta, cos_i)
        fr = torch.where(tir, torch.ones_like(cos_i), _schlick(cos_i, ior))

        is_met = mat == MAT_METALLIC
        is_diel = mat == MAT_DIELECTRIC
        can_spawn = live & (dep > 1)

        w_refl = torch.where(is_met[:, None], w * color, w * fr[:, None])
        push_refl = can_spawn & (is_met | is_diel) & (w_refl.amax(dim=-1) > _WHITTED_CUTOFF)
        # Refracted component tinted by COLOR on entry.
        tint = torch.where(hit.inside[:, None], torch.ones_like(color), color)
        w_refr = w * (1.0 - fr[:, None]) * tint
        push_refr = can_spawn & is_diel & ~tir & (w_refr.amax(dim=-1) > _WHITTED_CUTOFF)

        push(push_refl, pos + n * eps, rdir, w_refl, dep - 1)
        push(push_refr, pos - n * eps, refr_dir, w_refr, dep - 1)
        running = bool((top > 0).any())
    return radiance


def _mc_trace(scene: PrimitiveScene, origin, direction, key: Tuple[int, int], pixel_ids,
              eps: float) -> torch.Tensor:
    """Course-style Monte-Carlo path over primitives: ``ray_depth`` bounces;
    bounce b draws from ``fold_in(key, b)``."""
    o, d = origin, direction
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    zero3 = torch.zeros_like(o)
    alive = torch.isfinite(o[:, 0])
    for b in range(scene.ray_depth):
        draws = per_pixel_uniforms(*fold_in(*key, b), pixel_ids, 4)

        hit = closest_hit(o, d, scene, eps)
        miss = alive & ~hit.hit
        radiance = radiance + torch.where(miss[:, None], throughput * scene.bg_color, zero3)
        live = alive & hit.hit

        pos = o + hit.t[:, None] * d
        prim = hit.prim.long()
        mat = scene.mat_kind[prim]
        color = scene.color[prim]
        ior = scene.ior[prim]
        n = hit.normal

        radiance = radiance + torch.where(live[:, None], throughput * scene.emission[prim], zero3)

        # Diffuse: cosine bounce; the cos/pi pdf cancels albedo/pi * cos.
        diff_dir = cosine_sample(n, draws[0], draws[1])
        mirr_dir = normalize(reflect(n, d))
        # Dielectric: reflect with probability fr, else refract.
        cos_i = torch.clamp_min(-dot(d, n), 0.0)
        eta = torch.where(hit.inside, ior, 1.0 / ior)
        refr_dir, tir = _refract(d, n, eta, cos_i)
        fr = torch.where(tir, torch.ones_like(cos_i), _schlick(cos_i, ior))
        choose_refl = draws[2] <= fr
        diel_dir = where3(choose_refl, mirr_dir, refr_dir)

        is_diff = mat == MAT_DIFFUSE
        is_met = mat == MAT_METALLIC
        new_dir = where3(is_diff, diff_dir, where3(is_met, mirr_dir, diel_dir))
        # Albedo for diffuse and metal; a dielectric tints only the branch
        # refracted on entry.
        diel_scale = torch.where((choose_refl | hit.inside)[:, None], torch.ones_like(color), color)
        scale = where3(is_diff | is_met, color, diel_scale)
        throughput = torch.where(live[:, None], throughput * scale, throughput)

        # Offset the origin to the side of the surface the ray leaves on.
        off = torch.where((is_diff | is_met | choose_refl | tir)[:, None], n * eps, -n * eps)
        o = where3(live, pos + off, o)
        d = where3(live, new_dir, d)
        alive = live
    return radiance


def _render_chunk(scene: PrimitiveScene, lights: _Lights, chunk_start: int,
                  key: Tuple[int, int], n_rays: int, spp: int, config: RenderConfig,
                  mc: bool) -> torch.Tensor:
    pixel_ids = chunk_start + torch.arange(n_rays, dtype=torch.int32, device=scene.device)
    if not mc:
        half = torch.full((2, n_rays), 0.5, device=scene.device)
        o, d = gen_rays(scene.camera, pixel_ids, half)
        return _whitted_trace(scene, lights, o, d, scene.ray_depth, config.eps)
    acc = torch.zeros((n_rays, 3), device=scene.device)
    for s in range(spp):
        k = fold_in(*key, s)
        offsets = per_pixel_uniforms(*fold_in(*k, JITTER_DEPTH), pixel_ids, 2)
        o, d = gen_rays(scene.camera, pixel_ids, offsets)
        acc = acc + sanitize_nans(_mc_trace(scene, o, d, k, pixel_ids, config.eps))
    return acc / spp


def render_homebrew(scene: PrimitiveScene, seed: int = 0,
                    config: Optional[RenderConfig] = None) -> np.ndarray:
    """Render a homebrew scene (tensors on the device it renders on) ->
    numpy [H, W, 3] float32 HDR.  Pixels go in chunks of
    ``min(config.rays_per_batch, H * W)`` lanes; the tail chunk is padded
    and its padding dropped."""
    config = config or RenderConfig()
    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return np.broadcast_to(scene.bg_color.cpu().numpy().astype(np.float32), (h, w, 3)).copy()

    mc = scene.monte_carlo
    spp = scene.samples if mc else 1
    chunk = min(config.rays_per_batch, npix)
    lights = _filled_lights(scene)
    base = key_words(seed)
    out = np.zeros((npix, 3), dtype=np.float32)
    for start in range(0, npix, chunk):
        n = min(chunk, npix - start)
        rad = _render_chunk(scene, lights, start, base, chunk, spp, config, mc)
        out[start:start + n] = rad[:n].cpu().numpy()
    return out.reshape(h, w, 3)
