"""Wavefront Monte-Carlo path tracer over triangle scenes (port of
``tpu_pathtracer/models/pathtracer.py``).

One sample of one pixel follows the reference estimator bounce for bounce
(src/raytracer.h:512-627), with every branch of ``shade`` as masked selects
over an R-lane wavefront (on the card: kernels K2, K3 and K4 around the
light pdf, ``bounce_step``).  Two engines, as in the JAX package: the
persistent one (``compaction=True``, the default) refills dead lanes with
fresh (pixel, sample) primaries every iteration (path regeneration); the
scan one (``compaction=False``) traces one sample of every lane through
``ray_depth`` bounces.  Large scenes sort the wavefront by a coherence key
before each bounce, and per-lane draws are the counter-based (seed, pixel,
sample, depth) stream, so both engines are the JAX package's estimator
draw for draw; only per-pixel summation order (and the intersector's fp
rounding) differ.

Both engines run as CUDA graphs on a CUDA device (the port of the JAX
package's jitted ``render_chunk_persistent`` and ``render_chunk``), each
captured once per static configuration (``models/graph.py``): the
persistent loop as blocks of ``LOOP_ITERATIONS`` iterations replayed with
one host read per block (``persistent_accum``), the scan engine as one
sample of all ``ray_depth`` bounces replayed once per sample with no host
read (``scan_accum``); the CPU runs the same bodies without a graph.
``eager=True`` runs either engine's loop eagerly instead.  Unknown
configuration values raise ``ValueError``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys

import numpy as np
import torch

from ..config import IntersectTuning, RenderConfig
from ..ops import bsdf, sampling, texture
from ..ops.chunk_intersect import (
    RAY_TILE,
    check_tuning,
    closest_hit_chunks,
    count_work,
    group_boxes,
    light_pdf_sum_chunks,
    ray_sort_key,
    ray_sort_key_dirhint,
    ray_sort_key_hint,
    ray_sort_key_target,
    scene_bounds,
)
from ..ops.intersect import Hit, closest_hit, light_pdf_flat, light_pdf_sum
from ..ops.rng import (
    SOBOL_TAG_LIGHT,
    SOBOL_TAG_VNDF,
    jitter_uniforms,
    lane_uniforms,
    sobol_owen_pair,
)
from ..ops.vecmath import constant, cross, dot, frame_apply, length2, normalize, where3
from ..scene.types import Camera, TriangleScene
from ..utils.profiling import last, span, stage
from .graph import CapturedBlock, CaptureError

# Uniform draws per ray per bounce:
# 0 alpha coin | 1 vndf coin | 2,3 vndf | 4 mixture pick | 5,6 cosine
# 7 light pick | 8,9 light point
_DRAWS = 10

_SORT_KEYS = ("hint", "dirhint", "cell", "target", "none")


def _check_sort_key(key: str) -> None:
    if key not in _SORT_KEYS:
        raise ValueError(f"unknown sort_key {key!r}: expected " + " | ".join(_SORT_KEYS))


def check_config(config: RenderConfig) -> None:
    """Raise ``ValueError`` for a configuration value no engine knows (never
    ignore one)."""
    if config.jitter not in ("uniform", "sobol"):
        raise ValueError(f"unknown jitter kind {config.jitter!r}: expected uniform | sobol")
    if config.lowdisc not in ("off", "sobol"):
        raise ValueError(f"unknown lowdisc {config.lowdisc!r}: expected off | sobol")
    _check_sort_key(config.sort_key)
    check_tuning(config.tuning.resolve())


def bounce_draws(seed, sample, depth, pixel: torch.Tensor, config: RenderConfig,
                 sample_base=0, pixel_base=0) -> torch.Tensor:
    """[_DRAWS, R] per-bounce estimator draws of the lanes (``sample +
    sample_base``, ``depth``, ``pixel + pixel_base``).  ``lowdisc="sobol"``
    replaces the VNDF (2, 3) and light-point (8, 9) pairs by per-(pixel,
    depth) Owen-scrambled Sobol points over the sample index."""
    draws = lane_uniforms(seed, sample, depth, pixel, _DRAWS, sample_base, pixel_base)
    if config.lowdisc == "sobol":
        sample, pixel = sample + sample_base, pixel + pixel_base
        draws[2:4] = sobol_owen_pair(seed, sample, depth, pixel, SOBOL_TAG_VNDF)
        draws[8:10] = sobol_owen_pair(seed, sample, depth, pixel, SOBOL_TAG_LIGHT)
    elif config.lowdisc != "off":
        raise ValueError(f"unknown lowdisc {config.lowdisc!r}: expected off | sobol")
    return draws


def gen_rays(camera: Camera, pixel_ids: torch.Tensor, offsets: torch.Tensor):
    """Jittered pinhole rays (gen_ray, src/raytracer.h:527-538); ``offsets``
    is the [2, R] per-pixel jitter."""
    w, h = camera.width, camera.height
    x = (pixel_ids % w).to(torch.float32)
    y = (pixel_ids // w).to(torch.float32)
    tx = torch.tan(camera.fov_x / 2)
    ty = tx * h / w
    cx = (2.0 * (x + offsets[0]) / w - 1.0) * tx
    cy = (2.0 * (y + offsets[1]) / h - 1.0) * ty
    d = normalize(cx[:, None] * camera.right - cy[:, None] * camera.up + camera.forward[None, :])
    o = d * 0.0 + camera.position
    return o, d


def intersect_tile(scene: TriangleScene, tuning: IntersectTuning) -> int:
    """Rays per tile of the chunk cascade on ``scene``: 256 past
    ``tuning.narrow_tile_chunks`` chunks, ``RAY_TILE`` up to it, 0 for a
    scene of at most 1,024 triangles (the dense sweep, no tiles)."""
    if scene.capacity <= 1024:
        return 0
    return 256 if scene.chunk_woop.shape[0] > tuning.resolve().narrow_tile_chunks else RAY_TILE


def scene_closest_hit(scene: TriangleScene, origin, direction, min_dst: float,
                      tuning: IntersectTuning) -> Hit:
    """Dense sweep for scenes of at most 1,024 triangles, the chunk cascade
    (kernels B1/B2 on CUDA) above that, in tiles of ``intersect_tile``."""
    tile = intersect_tile(scene, tuning)
    if not tile:
        return closest_hit(origin, direction, scene.woop, min_dst)
    return closest_hit_chunks(
        origin, direction, scene.chunk_woop, scene.chunk_aabb_min,
        scene.chunk_aabb_max, scene.woop_rows, min_dst, ray_tile=tile, tuning=tuning.resolve(),
    )


def _interp_flat(row, base: int, width: int, beta, gamma):
    """triangle::interop (src/geometry.h:497-502) over three ``width``-wide
    vertex slices of the packed attribute row."""
    wa = (1.0 - beta - gamma)[:, None]
    return (
        wa * row[:, base:base + width]
        + beta[:, None] * row[:, base + width:base + 2 * width]
        + gamma[:, None] * row[:, base + 2 * width:base + 3 * width]
    )


def _fetched_slots(scene: TriangleScene, config: RenderConfig) -> tuple:
    """The texture slots (color, emissive, mr, normal) ``hit_info`` fetches.
    An atlas of only the two builtin 1x1 textures makes every lookup the
    identity; so does any slot no material maps to a real texture."""
    has_textures = scene.atlas.offset.shape[0] > 2 and config.use_textures
    return scene.tex_slots if has_textures else (False,) * 4


def hit_info(scene: TriangleScene, direction, hit: Hit, config: RenderConfig) -> dict:
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain twin
    ``hit_info_plain`` for CPU tensors (same contract, the same bits).  On
    the card the fields are views of the kernel's [R, 16] record, which is
    also returned under "record" (K3's and K4's input)."""
    if direction.is_cuda:
        from .. import kernels

        slots = sum(1 << k for k, used in enumerate(_fetched_slots(scene, config)) if used)
        rec, inside = kernels.shade_gather(
            scene.shade_attrs, hit.tri.contiguous(), hit.beta.contiguous(),
            hit.gamma.contiguous(), direction.contiguous(), scene.atlas, slots,
        )
        return dict(normal=rec[:, 0:3], shading_normal=rec[:, 3:6], inside=inside,
                    color=rec[:, 6:10], emission=rec[:, 10:13], metallic=rec[:, 13],
                    roughness=rec[:, 14], ior=rec[:, 15], record=rec)
    if direction.device.type == "cpu":
        return hit_info_plain(scene, direction, hit, config)
    raise RuntimeError(f"hit_info: no kernel for device {direction.device}")


def hit_info_plain(scene: TriangleScene, direction, hit: Hit, config: RenderConfig) -> dict:
    """to_intersection_info (src/bvh.h:80-121): one packed-row gather per
    hit, then the texture fetch of the slots some material uses (the plain
    twin of kernel K2)."""
    row = scene.shade_attrs[hit.tri.long()]  # [R, 48]
    base_color = row[:, 33:37]
    base_emission = row[:, 37:40]
    base_metallic = row[:, 40]
    base_roughness = row[:, 41]
    ior = row[:, 42]
    tex_ids = row[:, 43:47].to(torch.int32)  # color, emissive, mr, normal

    e1 = row[:, 3:6] - row[:, 0:3]
    e2 = row[:, 6:9] - row[:, 0:3]
    g_normal = normalize(cross(e1, e2))
    inside = dot(g_normal, direction) > 0
    smooth = normalize(_interp_flat(row, 9, 3, hit.beta, hit.gamma))
    smooth = where3(dot(g_normal, smooth) < 0, -smooth, smooth)

    used = _fetched_slots(scene, config)
    gammas = (2.2, 2.2, 1.0, 1.0)
    slots = [k for k in range(4) if used[k]]
    at = {k: 4 * j for j, k in enumerate(slots)}  # slot -> first output lane
    if slots:
        uv = _interp_flat(row, 18, 2, hit.beta, hit.gamma)
        fetched = texture.sample_many(
            scene.atlas, tex_ids[:, constant(slots, tex_ids, torch.int64)], uv,
            tuple(gammas[k] for k in slots),
        )
    if used[3]:
        tangent = normalize(_interp_flat(row, 24, 3, hit.beta, hit.gamma))
        bitangent = cross(smooth, tangent)
        j = at[3]
        normal_loc = normalize(fetched[:, j:j + 3] * 2.0 - 1.0)
        shading = normalize(frame_apply(normal_loc, tangent, bitangent, smooth))
    else:
        shading = smooth
    color = base_color * fetched[:, at[0]:at[0] + 4] if used[0] else base_color
    emission = base_emission * fetched[:, at[1]:at[1] + 3] if used[1] else base_emission
    if used[2]:
        j = at[2]
        metallic = base_metallic * fetched[:, j + 2]  # mr B channel
        roughness = base_roughness * fetched[:, j + 1]  # mr G channel
    else:
        metallic, roughness = base_metallic, base_roughness
    flip = inside[:, None]
    return dict(
        normal=torch.where(flip, -g_normal, g_normal),
        shading_normal=torch.where(flip, -shading, shading),
        inside=inside,
        color=color,
        emission=emission,
        metallic=metallic,
        roughness=roughness,
        ior=ior,
    )


def bounce_step(scene: TriangleScene, config: RenderConfig, o, d, throughput,
                radiance, alive, draws):
    """One wavefront bounce: the masked-select form of ``shade``
    (src/raytracer.h:555-591).  Returns (o, d, throughput, radiance, alive,
    hint) where hint is the chunk id of the surface each moved ray now
    spawns from (-1 elsewhere), the next bounce's sort key input.

    Five stages: the intersector, the hit record (K2, ``hit_info``), the
    sampling chain up to the new direction (K3, ``shade_sample``), the
    light pdf of that direction (``light_pdf``) and the pdf blend, BSDF and
    throughput update (K4, ``shade_finish``).  On CUDA tensors K2, K3 and
    K4 are one hand-written kernel each; on CPU tensors each runs its plain
    twin."""
    with stage("intersector"):
        hit = scene_closest_hit(scene, o, d, config.eps, config.tuning)
    with stage("hit_info"):
        info = hit_info(scene, d, hit, config)
    pos, new_dir, radiance, flags = shade_sample(scene, config, o, d, throughput, radiance,
                                                 alive, draws, hit, info)
    with stage("light_pdf"):
        p_light = light_pdf(scene, pos, new_dir, config.eps)
    o, d, throughput, moved, hint = shade_finish(scene, config, o, d, throughput, hit, info,
                                                 pos, new_dir, flags, p_light)
    return o, d, throughput, radiance, moved, hint


def light_pdf(scene: TriangleScene, pos, new_dir, eps: float):
    """[R] all-hits light-mixture pdf of the rays (pos, new_dir), or None for
    a light set with no rows.  The same choice as the JAX package makes on
    its chip, on every device: the cluster worklists (kernel B3) past 512
    light slots, the flat contraction (K1) for up to 4 clusters, the dense
    reduce otherwise."""
    lights = scene.lights
    if lights.capacity == 0:
        return None
    n_lights = lights.count
    if lights.has_clusters and lights.capacity > 512:
        r = pos.shape[0]
        tile = RAY_TILE if r % RAY_TILE == 0 else 256
        return light_pdf_sum_chunks(
            pos, new_dir, lights.cluster_woop, lights.cluster_k, lights.cluster_min,
            lights.cluster_max, n_lights, eps, ray_tile=tile,
        )
    if lights.has_clusters and lights.cluster_woop.shape[0] <= 4:
        return light_pdf_flat(pos, new_dir, lights.cluster_woop, lights.cluster_k, n_lights, eps)
    return light_pdf_sum(pos, new_dir, lights.verts, lights.normal, lights.area, n_lights, eps)


def _env_tex(scene: TriangleScene, config: RenderConfig) -> int:
    """The atlas id of the environment map a missed ray looks up, or -1
    when it takes ``bg_color`` (no map loaded, or textures off)."""
    return scene.env_tex if scene.has_env and config.use_textures else -1


def shade_sample(scene: TriangleScene, config: RenderConfig, o, d, throughput, radiance,
                 alive, draws, hit: Hit, info: dict):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain twin
    ``shade_sample_plain`` for CPU tensors (same contract, the same bits).
    ``info`` is ``hit_info``'s dict (the kernel reads K2's record from it).
    Returns (pos, new_dir, radiance, flags): the hit points [R, 3], the
    sampled directions [R, 3], the radiance with the miss and emission
    terms added [R, 3], and flags [R, 2] bool (shade, passthrough)."""
    if d.is_cuda:
        from .. import kernels

        return kernels.shade_sample(*shade_sample_args(scene, config, o, d, throughput, radiance,
                                                       alive, draws, hit, info))
    if d.device.type == "cpu":
        return shade_sample_plain(scene, config, o, d, throughput, radiance, alive, draws,
                                  hit, info)
    raise RuntimeError(f"shade_sample: no kernel for device {d.device}")


def shade_sample_args(scene: TriangleScene, config: RenderConfig, o, d, throughput, radiance,
                      alive, draws, hit: Hit, info: dict) -> tuple:
    """``kernels.shade_sample``'s arguments for ``shade_sample``'s inputs:
    the scene's light rows (or None), light count, background, atlas and
    environment map id, and the config's VNDF share and roughness floor."""
    lights = scene.lights
    return (o.contiguous(), d.contiguous(), throughput.contiguous(), radiance.contiguous(),
            alive.contiguous(), draws.contiguous(), hit.t.contiguous(), hit.hit.contiguous(),
            info["record"], lights.verts.reshape(-1, 9) if lights.capacity > 0 else None,
            lights.count, scene.bg_color, scene.atlas, _env_tex(scene, config),
            config.vndf_factor, config.min_roughness)


def shade_sample_plain(scene: TriangleScene, config: RenderConfig, o, d, throughput,
                       radiance, alive, draws, hit: Hit, info: dict):
    """The first half of ``shade`` after the hit record (the plain twin of
    kernel K3): the environment or background radiance of missed rays, the
    emission of shaded hits, the alpha Russian roulette, and the direction
    drawn from the VNDF / cosine / light-triangle mixture."""
    vf = config.vndf_factor
    lights = scene.lights
    env_tex = _env_tex(scene, config)
    if env_tex >= 0:
        env = texture.env_radiance(scene.atlas, env_tex, scene.bg_color, d)
    else:
        # No env map loaded: bg_at degenerates to bg_color.
        env = scene.bg_color
    miss = alive & ~hit.hit
    zero3 = torch.zeros_like(radiance)
    radiance = radiance + torch.where(miss[:, None], throughput * env, zero3)

    live = alive & hit.hit
    pos = o + hit.t[:, None] * d

    # Alpha Russian roulette (src/raytracer.h:558-561).
    alpha_pass = draws[0] > info["color"][:, 3]
    passthrough = live & alpha_pass
    shade = live & ~alpha_pass
    radiance = radiance + torch.where(shade[:, None], throughput * info["emission"], zero3)

    a = torch.clamp_min(info["roughness"], config.min_roughness)
    alpha_r2 = a * a
    use_vndf = draws[1] <= vf
    vndf_dir = sampling.vndf_sample(alpha_r2, d, info["shading_normal"], draws[2], draws[3])
    cos_dir = sampling.cosine_sample(info["normal"], draws[5], draws[6])
    # A light set with no rows (never made by the loader, which pads to 8)
    # has nothing to pick or sum over: the mixture is the cosine lobe alone.
    if lights.capacity > 0:
        n_lights = lights.count
        pick_light = (sampling.pick_uniform(draws[4], 2) == 1) & (n_lights > 0)
        li = sampling.pick_uniform(draws[7], n_lights).long()
        lv = lights.verts.reshape(-1, 9)[li]  # [R, 9]
        light_dir = sampling.light_triangle_sample(
            pos, lv[:, 0:3], lv[:, 3:6], lv[:, 6:9], draws[8], draws[9]
        )
        mix_dir = where3(pick_light, light_dir, cos_dir)
    else:
        mix_dir = cos_dir
    new_dir = where3(use_vndf, vndf_dir, mix_dir)
    return pos, new_dir, radiance, torch.stack([shade, passthrough], dim=1)


def shade_finish(scene: TriangleScene, config: RenderConfig, o, d, throughput, hit: Hit,
                 info: dict, pos, new_dir, flags, p_light):
    """K4 wrapper: the CUDA kernel for CUDA tensors, the plain twin
    ``shade_finish_plain`` for CPU tensors (same contract, the same bits).
    ``p_light`` is the light pdf of (pos, new_dir), or None for a light set
    with no rows.  Returns (o, d, throughput, moved, hint)."""
    if d.is_cuda:
        from .. import kernels

        return kernels.shade_finish(*shade_finish_args(scene, config, o, d, throughput, hit, info,
                                                       pos, new_dir, flags, p_light))
    if d.device.type == "cpu":
        return shade_finish_plain(scene, config, o, d, throughput, hit, info, pos, new_dir,
                                  flags, p_light)
    raise RuntimeError(f"shade_finish: no kernel for device {d.device}")


def shade_finish_args(scene: TriangleScene, config: RenderConfig, o, d, throughput, hit: Hit,
                      info: dict, pos, new_dir, flags, p_light) -> tuple:
    """``kernels.shade_finish``'s arguments for ``shade_finish``'s inputs:
    the light pdf where the mixture uses it (else None), the config's VNDF
    share, eps and roughness floor, and the scene's chunk width."""
    use_light = p_light is not None and scene.lights.count > 0
    return (o.contiguous(), d.contiguous(), throughput.contiguous(), hit.tri.contiguous(),
            info["record"], pos.contiguous(), new_dir.contiguous(), flags.contiguous(),
            p_light.contiguous() if use_light else None, config.vndf_factor, config.eps,
            config.min_roughness, scene.chunk_woop.shape[-1])


def shade_finish_plain(scene: TriangleScene, config: RenderConfig, o, d, throughput,
                       hit: Hit, info: dict, pos, new_dir, flags, p_light):
    """The second half of ``shade`` (the plain twin of kernel K4): the MIS
    pdf blend (src/raytracer.h:572-574), the BSDF and cosine term, the kill
    test, the throughput update and the next bounce's origin, direction
    and sort hint."""
    eps = config.eps
    vf = config.vndf_factor
    shade, passthrough = flags[:, 0], flags[:, 1]
    a = torch.clamp_min(info["roughness"], config.min_roughness)
    alpha_r2 = a * a
    p_vndf = sampling.vndf_pdf(alpha_r2, d, info["shading_normal"], new_dir, eps)
    p_cos = sampling.cosine_pdf(info["normal"], new_dir)
    p_mix = (p_cos + p_light) / 2.0 if p_light is not None and scene.lights.count > 0 else p_cos
    p = vf * p_vndf + (1.0 - vf) * p_mix

    f = bsdf.pbr_brdf(
        d, new_dir, info["shading_normal"], info["color"][:, :3],
        info["metallic"], info["roughness"], info["ior"], config.min_roughness,
    )
    cos_term = torch.clamp_min(dot(new_dir, info["shading_normal"]), 0.0)
    scl = f * (cos_term / p)[:, None]

    kill = torch.isnan(new_dir).any(dim=-1) | (p < eps) | (length2(scl) == 0.0)
    cont = shade & ~kill
    throughput = torch.where(cont[:, None], throughput * scl, throughput)
    moved = passthrough | cont
    o = where3(moved, pos, o)
    d = where3(cont, new_dir, d)
    chunk_tris = scene.chunk_woop.shape[-1]
    hint = torch.where(moved, torch.div(hit.tri, chunk_tris, rounding_mode="floor"),
                       torch.full_like(hit.tri, -1))
    return o, d, throughput, moved, hint


def _make_sort_key(scene: TriangleScene, config: RenderConfig, r: int):
    """Per-bounce wavefront coherence key fn(o, d, alive, hint) -> [r] int32
    (dead rays sort last), by ``config.sort_key``:

      "hint"    direction octant x spawn-surface chunk id;
      "dirhint" fine direction bins x spawn-surface chunk id x octant;
      "cell"    direction octant x Morton origin cell;
      "target"  the worklist group each ray will first enter (kernel B4)
                x octant, on the lanes padded to a multiple of ``RAY_TILE``;
      "none"    compaction only (live order untouched)."""
    _check_sort_key(config.sort_key)
    n_chunks = scene.chunk_woop.shape[0]
    if config.sort_key == "target":
        g_lo, g_hi = group_boxes(scene.chunk_aabb_min, scene.chunk_aabb_max)
        pad = (-r) % RAY_TILE

        def key_fn(o, d, alive, hint):
            if pad:
                o = torch.cat([o, torch.full((pad, 3), 1e30, device=o.device)])
                d = torch.cat([d, torch.ones((pad, 3), device=d.device)])
                alive = torch.cat([alive, torch.zeros(pad, dtype=torch.bool, device=alive.device)])
            return ray_sort_key_target(o, d, alive, g_lo, g_hi, config.eps)[:r]

        return key_fn
    if config.sort_key == "cell":
        lo, hi = scene_bounds(scene.chunk_aabb_min, scene.chunk_aabb_max)
        return lambda o, d, alive, hint: ray_sort_key(o, d, alive, lo, hi)
    if config.sort_key == "dirhint":
        return lambda o, d, alive, hint: ray_sort_key_dirhint(d, alive, hint, n_chunks)
    if config.sort_key == "hint":
        return lambda o, d, alive, hint: ray_sort_key_hint(d, alive, hint, n_chunks)
    return lambda o, d, alive, hint: (~alive).to(torch.int32)  # "none"


def sanitize_nans(color: torch.Tensor) -> torch.Tensor:
    """sanitize_nans (src/raytracer.h:607-616): per-channel NaN -> 0."""
    return torch.where(torch.isnan(color), torch.zeros_like(color), color)


def add_rows(accum: torch.Tensor, rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``accum[rows[i]] += values[i]``, ``rows`` may repeat, in an order that
    is the same on every run, so renders of the same samples repeat bit for
    bit and a resumed render equals an uninterrupted one.  On CUDA
    ``index_add_`` adds repeats by float atomics in whatever order they
    land; ``index_put_`` with accumulate sorts the rows stably and adds each
    row's values without atomics.  On the CPU ``index_add_`` adds serially
    in i order, while ``index_put_`` splits the work over threads."""
    if accum.is_cuda:
        return accum.index_put_((rows,), values, accumulate=True)
    return accum.index_add_(0, rows, values)


# Iterations of the persistent loop between two host reads of "is work
# left?" in the "graph" loop.  Chosen on one H100 80GB HBM3
# at 700 W (chip_smoke.py phase graph; PERF.md): 4, 8, 16 and 32 took 5.9,
# 6.0, 6.3 and 7.4 ms per useful iteration of the atrium at 512x512 @ 16
# spp, the tail past a pool's end costing more than the host reads saved.
LOOP_ITERATIONS = 4
# Compiled loops kept at once (each holds its scene's tensors and its pool).
GRAPH_CACHE = 4
# The entries of the persistent loop's work carry (``ops.chunk_intersect.count_work``).
WORK_COUNTS = ("b2_units", "b1_tests")
# The counts ``persistent_accum`` returns: the rays traced, then the work.
CALL_COUNTS = ("rays",) + WORK_COUNTS


def engine_loop(config: RenderConfig, device, eager: bool = False) -> str:
    """The loop either engine runs (see ``persistent_accum``,
    ``scan_accum``): "eager" when asked for, else "graph", with one rule:
    intersector mode "bins" runs "eager" on CUDA, because it reads the host
    inside the intersector (a ``nonzero`` and its overflow flag), which a
    CUDA graph cannot hold."""
    if eager:
        return "eager"
    if torch.device(device).type == "cuda" and config.tuning.resolve().mode == "bins":
        return "eager"
    return "graph"


def _traced_scalars(device, chunk_start, seed, *rest) -> torch.Tensor:
    """[2 + len(rest)] int64 on ``device``: the first pixel, the seed's key
    word, then ``rest`` (the persistent engine's first sample, pool size and
    pool pixels; the scan engine's first sample).  Each may be a Python int
    or a 0-d tensor (the JAX package's traced arguments)."""
    vals = (chunk_start, seed, *rest)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        vals = (chunk_start, int(seed) & 0xFFFFFFFF, *rest)
        return torch.tensor([int(v) for v in vals], dtype=torch.int64, device=device)
    out = torch.stack([
        v.reshape(()).to(device=device, dtype=torch.int64) if isinstance(v, torch.Tensor)
        else torch.tensor(int(v), dtype=torch.int64, device=device) for v in vals])
    out[1] &= 0xFFFFFFFF
    return out


class _PersistentLoop:
    """The persistent engine over one lane block: its carries and the body
    of its loop.  The traced inputs are read from ``scalars`` ([5] int64 on
    the device, ``_traced_scalars``) and the camera from ``camera``'s
    tensors, so the body captured once in a CUDA graph serves every chunk,
    pass, seed and camera of its static configuration (scene, config, lane
    count, accumulator rows)."""

    def __init__(self, scene, config, n_rays: int, rows: int, camera: Camera,
                 scalars: torch.Tensor):
        dev = scene.device
        self.scene, self.config, self.camera, self.scalars = scene, config, camera, scalars
        self.n_rays, self.rows = n_rays, rows
        (self.chunk_start, self.seed, self.sample_start, self.w_total,
         self.pool_pix) = scalars.unbind()
        self.sort_rays = scene.capacity > 1024 and n_rays >= 2048
        self.key_fn = _make_sort_key(scene, config, n_rays) if self.sort_rays else None
        self.far = torch.full((3,), 1e30, device=dev)
        self.iota = torch.arange(n_rays, dtype=torch.int64, device=dev)
        # Rows past ``rows``: one drop row per lane for the lanes that finish
        # nothing, so the only repeated rows are pixels finishing two samples
        # at once (``add_rows`` adds one row's repeats one after another).
        self.drop = rows + self.iota
        self.accum = torch.zeros((rows + n_rays, 3), device=dev)

    def spawn(self, work_ids, valid):
        """Primary rays of work items ``work_ids`` (where ``valid``)."""
        with stage("spawn"):
            w = torch.where(valid, work_ids, torch.zeros_like(work_ids))
            slot = (w % self.pool_pix).to(torch.int32)
            s = (w // self.pool_pix).to(torch.int32)
            o, d = gen_rays(self.camera, self.chunk_start + slot, jitter_uniforms(
                self.seed, s, slot, self.config.jitter, self.sample_start, self.chunk_start))
        return o, d, slot, s

    def start(self) -> dict:
        """The carries before the first iteration; zeroes the accumulator."""
        dev = self.iota.device
        valid0 = self.iota < self.w_total
        o, d, slot, sample = self.spawn(self.iota, valid0)
        alive = valid0 & torch.isfinite(o[:, 0])
        self.accum.zero_()
        return dict(
            o=o, d=d, throughput=torch.ones_like(o), radiance=torch.zeros_like(o),
            alive=alive, active=alive.clone(), slot=slot, sample=sample,
            depth=torch.zeros(self.n_rays, dtype=torch.int32, device=dev),
            hint=torch.full((self.n_rays,), -1, dtype=torch.int32, device=dev),
            next_work=torch.minimum(self.w_total, torch.full_like(self.w_total, self.n_rays)),
            n_bounce=torch.zeros((), dtype=torch.int64, device=dev),
            work=torch.zeros((len(WORK_COUNTS),), dtype=torch.int64, device=dev),
        )

    def more(self, c: dict) -> torch.Tensor:
        """[] bool: some lane is alive or work is left."""
        return c["alive"].any() | (c["next_work"] < self.w_total)

    def iteration(self, c: dict) -> dict:
        """One iteration: sort, bounce, retire finished samples into the
        accumulator, regenerate freed lanes.  Returns the new carries."""
        scene, config = self.scene, self.config
        with stage("loop"):
            o, d, throughput, radiance = c["o"], c["d"], c["throughput"], c["radiance"]
            alive, active, slot, sample = c["alive"], c["active"], c["slot"], c["sample"]
            depth, hint, next_work = c["depth"], c["hint"], c["next_work"]
            if self.sort_rays:
                with stage("sort"):
                    perm = torch.argsort(self.key_fn(o, d, alive, hint), stable=True)
                    o, d = o[perm], d[perm]
                    throughput, radiance = throughput[perm], radiance[perm]
                    alive, active, slot = alive[perm], active[perm], slot[perm]
                    sample, depth, hint = sample[perm], depth[perm], hint[perm]
            n_bounce = c["n_bounce"] + alive.sum()
            with stage("draws"):
                draws = bounce_draws(self.seed, sample, depth, slot, config,
                                     self.sample_start, self.chunk_start)
            with stage("shading"), count_work(c["work"]):
                o, d, throughput, radiance, alive2, hint = bounce_step(
                    scene, config, o, d, throughput, radiance, alive, draws
                )
            alive2 = alive2 & alive
            depth = depth + 1

            # Termination: killed this bounce, or the depth budget exhausted
            # (which adds throughput * 0, the reference's NaN algebra).
            exhausted = alive2 & (depth >= scene.ray_depth)
            radiance = radiance + torch.where(
                exhausted[:, None], throughput * 0.0, torch.zeros_like(radiance)
            )
            done = active & (~alive2 | exhausted)
            alive2 = alive2 & ~exhausted
            contrib = torch.where(done[:, None], sanitize_nans(radiance), torch.zeros_like(radiance))
            with stage("add_rows"):
                add_rows(self.accum, torch.where(done, slot.long(), self.drop), contrib)

            # Regenerate: freed lanes pull the next work items.
            with stage("regenerate"):
                free = done | ~active
                work_ids = next_work + torch.cumsum(free.to(torch.int64), 0) - 1
                take = free & (work_ids < self.w_total)
                no, nd, nslot, nsample = self.spawn(work_ids, take)
                o = where3(take, no, o)
                d = where3(take, nd, d)
                throughput = torch.where(take[:, None], torch.ones_like(throughput), throughput)
                radiance = torch.where(take[:, None], torch.zeros_like(radiance), radiance)
                slot = torch.where(take, nslot, slot)
                sample = torch.where(take, nsample, sample)
                depth = torch.where(take, torch.zeros_like(depth), depth)
                hint = torch.where(take, torch.full_like(hint, -1), hint)
                alive = alive2 | take
                active = (active & ~done) | take
                next_work = torch.minimum(next_work + free.sum(), self.w_total)
                if self.sort_rays:
                    # Park dead lanes far away so their tiles activate no chunk.
                    o = where3(alive, o, self.far)
        return dict(o=o, d=d, throughput=throughput, radiance=radiance, alive=alive,
                    active=active, slot=slot, sample=sample, depth=depth, hint=hint,
                    next_work=next_work, n_bounce=n_bounce, work=c["work"])


_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_CAMERA_TENSORS = ("position", "right", "up", "forward", "fov_x")


def _static_key(scene, config: RenderConfig, *static):
    """(cache key, the scene's tensors) of a compiled body: the JAX
    package's static arguments (``static``: the engine's name, lane count,
    accumulator rows, iterations per replay) and config, with the scene (a
    ``TriangleScene`` or ``PrimitiveScene``) as the identity and version of
    its tensors and its plain fields, and the camera's pixel size; the
    camera's tensors are copied in at every call instead.  The version
    counts the in-place writes to a tensor: a graph reads the copies
    ``made_once`` derived from the scene's tensors when it was captured,
    which such a write makes stale."""
    tensors, plain = [], []

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "camera":
                plain.append((prefix + "camera", v.width, v.height))
            elif isinstance(v, torch.Tensor):
                tensors.append(v)
            elif dataclasses.is_dataclass(v):
                walk(v, prefix + f.name + ".")
            else:
                plain.append((prefix + f.name, v))

    walk(scene, "")
    config = dataclasses.replace(config, tuning=config.tuning.resolve())
    key = (str(scene.device), tuple((id(t), t._version) for t in tensors), tuple(plain), config,
           *static)
    return key, tensors


def compiled_body(engine: str, scene, config: RenderConfig, static: tuple, make) -> dict:
    """The cached compiled body of ``engine`` for this static configuration,
    made at the first call by ``make(camera, scalars)`` over device buffers
    the caller fills before every run (the graph itself is captured at the
    body's first run).  One cache of ``GRAPH_CACHE`` entries serves every
    engine: a render uses one engine on one scene, and the bound is on the
    device memory the cached graphs hold, whatever made them."""
    key, tensors = _static_key(scene, config, engine, *static)
    entry = _GRAPHS.get(key)
    if entry is None:
        dev = scene.device
        cam = scene.camera
        camera = dataclasses.replace(
            cam, **{name: torch.empty_like(getattr(cam, name), device=dev)
                    for name in _CAMERA_TENSORS})
        scalars = torch.zeros(5, dtype=torch.int64, device=dev)
        # The graph reads the scene's tensors by address: the entry keeps
        # them alive, so no other tensor can take their memory (or ids).
        entry = dict(body=make(camera, scalars), block=None, tensors=tensors)
        _GRAPHS[key] = entry
        while len(_GRAPHS) > GRAPH_CACHE:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    return entry


def load_inputs(body, camera: Camera, scalars: torch.Tensor) -> None:
    """Copy a call's camera and traced scalars into a compiled body's
    buffers (``body.camera``, ``body.scalars``)."""
    for name in _CAMERA_TENSORS:
        getattr(body.camera, name).copy_(getattr(camera, name))
    body.scalars[:scalars.shape[0]].copy_(scalars)


def run_block(entry: dict, step, more, carries: dict, iterations: int) -> CapturedBlock:
    """The entry's ``CapturedBlock`` started from ``carries`` (made over them
    at the first call)."""
    if entry["block"] is None:
        entry["block"] = CapturedBlock(step, more, carries, iterations)
    else:
        entry["block"].load(carries)
    return entry["block"]


def clear_compiled_loops() -> None:
    """Drop every cached compiled body (and the memory its graph holds)."""
    _GRAPHS.clear()


def persistent_accum(
    scene: TriangleScene,
    chunk_start,  # first linear pixel id of this lane block
    seed,
    sample_start,  # first global sample index
    n_rays: int,  # lane count
    w_total,  # work-pool size (pixels * samples)
    config: RenderConfig,
    pix_count=None,  # pixels of the pool (None = n_rays)
    accum_rows: int | None = None,  # accumulator rows (None = n_rays)
    *,
    eager: bool = False,
):
    """Persistent wavefront with path regeneration.  Work item w covers
    (pixel slot w % P, local sample w // P), P = pix_count or n_rays.
    Returns ([rows, 3] radiance sum, [3] int64 counts on the device:
    ``CALL_COUNTS``, the live lanes summed over bounces = rays traced, then
    the work below).

    ``chunk_start``, ``seed``, ``sample_start``, ``w_total`` and
    ``pix_count`` are the JAX package's traced arguments: each may be a
    Python int or a 0-d tensor, with the same result.  The iterations run
    in one of two loops (``engine_loop``):

      "eager"  one host read of "is work left?" before every iteration
               (``eager=True``, and intersector mode "bins" on CUDA);
      "graph"  blocks of ``LOOP_ITERATIONS`` iterations with one host read
               each, over buffers cached per static configuration
               (``CapturedBlock``): on CUDA the block is one CUDA graph,
               captured at the first call and replayed for every block,
               chunk, pass, seed and camera (the port of the JAX package's
               jitted ``lax.while_loop``), and ``kernels.launches`` goes
               up by the launches a replay runs; a capture that fails
               raises.  On the CPU the block runs as it is.

    Both give the same frame and rays, bit for bit.  Running up to
    ``LOOP_ITERATIONS - 1`` iterations past the end changes nothing: after
    every iteration ``active`` implies ``alive``, so once no lane is alive
    and no work is left, ``done`` and ``take`` are all false, ``add_rows``
    adds exact zeros to the drop rows only (past ``rows``), ``n_bounce``
    adds 0 and ``next_work`` stays at ``w_total``.
    ``persistent_accum.iterations`` counts the iterations run.

    The loop also counts, on the device, the intersector's work of every
    bounce into its ``work`` carry (``WORK_COUNTS``; ``count_work``): B2's
    units and B1's (tile, chunk) tests, over every launch the loop makes,
    those past the end included.

    The call is an ``engine_call`` span of the log with ``lanes``,
    ``ray_tile`` (``intersect_tile``), ``chunks``, ``iterations`` and, on
    CUDA's graph loop, ``graph`` (its stage map's id); the caller attaches
    the returned counts where it reads them (``attach_call_counts``).
    Inside it: ``call_start`` (the buffers, the inputs' load and the first
    carries) and ``drain`` (the iterations with their host reads, and the
    capture at a body's first call)."""
    dev = scene.device
    pool_pix = n_rays if pix_count is None else pix_count
    rows = n_rays if accum_rows is None else accum_rows
    kind = engine_loop(config, dev, eager)
    k = LOOP_ITERATIONS
    it0 = persistent_accum.iterations
    with span("engine_call", lanes=n_rays, ray_tile=intersect_tile(scene, config.tuning),
              chunks=scene.chunk_woop.shape[0]) as call:
        if kind == "eager":
            with span("call_start"):
                scalars = _traced_scalars(dev, chunk_start, seed, sample_start, w_total, pool_pix)
                body = _PersistentLoop(scene, config, n_rays, rows, scene.camera, scalars)
                c = body.start()
            with span("drain"):
                while bool(body.more(c)):
                    c = body.iteration(c)
                    persistent_accum.iterations += 1
            call.add(iterations=persistent_accum.iterations - it0)
            return body.accum[:rows], torch.cat([c["n_bounce"].reshape(1), c["work"]])

        with span("call_start"):
            scalars = _traced_scalars(dev, chunk_start, seed, sample_start, w_total, pool_pix)
            entry = compiled_body("persistent", scene, config, (n_rays, rows, k),
                                  lambda camera, buf: _PersistentLoop(scene, config, n_rays, rows,
                                                                      camera, buf))
            body = entry["body"]
            load_inputs(body, scene.camera, scalars)
            carries = body.start()
            block = run_block(entry, body.iteration, body.more, carries, k)
        with span("drain"):
            while True:
                more = block.run()
                persistent_accum.iterations += k
                if not more:
                    break
        call.add(iterations=persistent_accum.iterations - it0)
        if block.graph_id is not None:
            call.add(graph=block.graph_id)
        # Copies: the next call of this loop overwrites its buffers.
        carries = block.carries
        return body.accum[:rows].clone(), torch.cat([carries["n_bounce"].reshape(1),
                                                     carries["work"]])


persistent_accum.iterations = 0


def attach_call_counts(counts: torch.Tensor) -> int:
    """Read the newest engine call's ``counts`` (``persistent_accum``'s) in
    one host read, attach them to its ``engine_call`` span as ``rays``,
    ``b2_units`` and ``b1_tests``, and return the rays."""
    values = counts.tolist()
    last("engine_call").add(**dict(zip(CALL_COUNTS, values)))
    return values[0]


def render_chunk_persistent(scene, chunk_start, seed, sample_start, n_rays: int, spp: int,
                            config: RenderConfig, pix_count=None, accum_rows: int | None = None,
                            *, eager: bool = False):
    """Mean radiance over ``spp`` samples of one pixel pool, and the call's
    counts (``eager`` and the counts: see ``persistent_accum``)."""
    pool_pix = n_rays if pix_count is None else pix_count
    acc, counts = persistent_accum(
        scene, chunk_start, seed, sample_start, n_rays, pool_pix * spp, config,
        pix_count=pix_count, accum_rows=accum_rows, eager=eager,
    )
    return acc / spp, counts


class _ScanTracer:
    """The scan engine's bounce loop over ``r`` lanes, with its sort key and
    parking origin made once (so a captured body reads them at fixed
    addresses): one full path per input ray over the ``ray_depth``
    wavefront bounces, as the JAX package's ``trace`` scans them."""

    def __init__(self, scene: TriangleScene, config: RenderConfig, r: int):
        dev = scene.device
        self.scene, self.config = scene, config
        self.sort_rays = scene.capacity > 1024 and r >= 2048
        self.key_fn = _make_sort_key(scene, config, r) if self.sort_rays else None
        self.far = torch.full((3,), 1e30, device=dev)
        self.slot = torch.arange(r, dtype=torch.int32, device=dev)  # input position of each lane

    def __call__(self, origin, direction, seed, pixel_ids: torch.Tensor, sample,
                 early_exit: bool) -> torch.Tensor:
        """[R, 3] radiance in input order, not NaN-sanitized.  ``early_exit``
        stops once every ray is dead (a host read per bounce); without it
        every bounce runs, as in a CUDA graph.  Both give the same bits: a
        bounce over dead lanes leaves radiance, throughput, ``alive`` and
        the order of the lanes as they were (every dead lane's sort key is
        one constant, so the stable sort keeps their order)."""
        scene, config = self.scene, self.config
        o, d = origin, direction
        throughput = torch.ones_like(o)
        radiance = torch.zeros_like(o)
        alive = torch.isfinite(o[:, 0])
        pids, slot = pixel_ids, self.slot
        hint = torch.full_like(slot, -1)
        for depth in range(scene.ray_depth):
            if early_exit:
                if not bool(alive.any()):
                    break
                scan_accum.bounces += 1  # (``scan_accum`` counts the graph's per sample)
            if self.sort_rays:
                perm = torch.argsort(self.key_fn(o, d, alive, hint), stable=True)
                o, d, throughput, radiance = o[perm], d[perm], throughput[perm], radiance[perm]
                alive, pids, slot, hint = alive[perm], pids[perm], slot[perm], hint[perm]
            draws = bounce_draws(seed, sample, depth, pids, config)
            o, d, throughput, radiance, alive, hint = bounce_step(
                scene, config, o, d, throughput, radiance, alive, draws
            )
            if self.sort_rays:
                # Park dead rays far away so their tiles activate no chunk.
                o = where3(alive, o, self.far)
        # Depth exhaustion: the reference's deepest call returns {0,0,0},
        # which a NaN throughput chain turns into NaN (src/raytracer.h:596-598).
        radiance = radiance + torch.where(alive[:, None], throughput * 0.0,
                                          torch.zeros_like(radiance))
        if self.sort_rays:
            radiance = radiance[torch.argsort(slot)]  # undo the composed permutation
        return radiance


def trace(scene: TriangleScene, origin, direction, seed, pixel_ids: torch.Tensor,
          config: RenderConfig, sample=0, *, early_exit: bool = True) -> torch.Tensor:
    """The scan engine's bounce loop: one full path per input ray, over at
    most ``ray_depth`` wavefront bounces, by default stopping early once
    every ray is dead (a host read per bounce; ``early_exit=False`` runs
    them all, with the same result).  Returns [R, 3] radiance in input
    order, not NaN-sanitized."""
    return _ScanTracer(scene, config, origin.shape[0])(origin, direction, seed, pixel_ids,
                                                        sample, early_exit)


class _ScanSample:
    """One sample of the scan engine over ``n_rays`` pixels: what one
    iteration of the JAX package's ``render_chunk`` sample loop does (camera
    jitter, primary rays, every bounce, the sanitized add into the
    accumulator).  The first pixel and the seed's key word are read from
    ``scalars`` ([3+] int64 on the device), the sample index from the carry
    ``sample`` (which starts at the first sample) and the camera from
    ``camera``'s tensors, so the body captured once in a CUDA graph serves
    every sample, chunk, pass, seed and camera of its static configuration
    (scene, config, lane count)."""

    def __init__(self, scene: TriangleScene, config: RenderConfig, n_rays: int, camera: Camera,
                 scalars: torch.Tensor):
        self.config, self.camera, self.scalars = config, camera, scalars
        self.chunk_start, self.seed, self.sample_start = scalars.unbind()[:3]
        self.iota = torch.arange(n_rays, dtype=torch.int32, device=scene.device)
        self.tracer = _ScanTracer(scene, config, n_rays)

    def start(self) -> dict:
        """The carries before the first sample."""
        return dict(acc=torch.zeros((self.iota.shape[0], 3), device=self.iota.device),
                    sample=self.sample_start.clone())

    def step(self, c: dict) -> dict:
        gs = c["sample"]
        pids = self.chunk_start + self.iota  # int32, as the eager loop's ids
        o, d = gen_rays(self.camera, pids, jitter_uniforms(self.seed, gs, pids,
                                                           self.config.jitter))
        rad = self.tracer(o, d, self.seed, pids, gs, early_exit=False)
        return dict(acc=c["acc"] + sanitize_nans(rad), sample=gs + 1)


def scan_accum(scene: TriangleScene, chunk_start, seed, sample_start, n_rays: int, spp: int,
               config: RenderConfig, *, eager: bool = False) -> torch.Tensor:
    """The scan engine: [n_rays, 3] radiance SUM over samples
    ``sample_start .. sample_start + spp - 1`` of the ``n_rays`` pixels from
    ``chunk_start`` (render_pixel, src/raytracer.h:618-627).

    In the loop ``engine_loop`` picks: "eager" traces each sample with a
    host read per bounce (its early exit); "graph" runs ``_ScanSample``,
    cached per static configuration, once per sample with no host read: on
    CUDA as one CUDA graph captured at the first sample and replayed for
    every later one (the port of the JAX package's jitted ``render_chunk``,
    whose ``fori_loop`` over samples scans every bounce), on the CPU as it
    is.  Both give the same bits.  ``chunk_start``, ``seed`` and
    ``sample_start`` may be Python ints or 0-d tensors.
    ``scan_accum.bounces`` counts the wavefront bounces run (a replay runs
    ``ray_depth``).  The call is an ``engine_call`` span of the log with
    ``lanes`` and, on CUDA, ``graph``."""
    dev = scene.device
    with span("engine_call", lanes=n_rays) as call:
        if engine_loop(config, dev, eager) == "eager":
            pids = chunk_start + torch.arange(n_rays, dtype=torch.int32, device=dev)
            acc = torch.zeros((n_rays, 3), device=dev)
            for s in range(spp):
                gs = sample_start + s
                o, d = gen_rays(scene.camera, pids, jitter_uniforms(seed, gs, pids, config.jitter))
                acc = acc + sanitize_nans(trace(scene, o, d, seed, pids, config, sample=gs))
            return acc
        with span("call_start"):
            entry = compiled_body("scan", scene, config, (n_rays,), lambda camera, buf: (
                _ScanSample(scene, config, n_rays, camera, buf)))
            body = entry["body"]
            load_inputs(body, scene.camera, _traced_scalars(dev, chunk_start, seed, sample_start))
            block = run_block(entry, body.step, None, body.start(), 1)
        with span("drain"):
            for _ in range(spp):
                block.run()
        scan_accum.bounces += spp * scene.ray_depth
        if block.graph_id is not None:
            call.add(graph=block.graph_id)
        # A copy: the next call of this body overwrites its buffers.
        return block.carries["acc"].clone()


scan_accum.bounces = 0


def render_chunk(scene: TriangleScene, chunk_start, seed, sample_start, n_rays: int, spp: int,
                 config: RenderConfig, *, eager: bool = False) -> torch.Tensor:
    """The scan engine: mean radiance over ``spp`` samples of the ``n_rays``
    pixels from ``chunk_start`` (``eager``: see ``scan_accum``)."""
    return scan_accum(scene, chunk_start, seed, sample_start, n_rays, spp, config,
                      eager=eager) / spp


def pick_chunk(config: RenderConfig, npix: int) -> int:
    """Lane count: bounded by config, rounded up to the ray tile (the
    persistent engine never spawns the padding lanes: the tail chunk passes
    its pixel count; the scan engine renders them and drops them)."""
    chunk = min(config.rays_per_batch, npix)
    return chunk + ((-chunk) % RAY_TILE)


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """How a frame of ``npix`` pixels runs (``frame_plan``): engine calls of
    ``lanes`` lanes, passes of ``pass_spp`` samples, chunks of ``pix_step``
    pixels, and the engine (``persistent``, else the scan engine).  Under
    ``frame_pool`` the whole frame is one persistent pool per pass, so the
    drain tail is paid once per pass, not once per chunk."""

    npix: int
    lanes: int
    pass_spp: int
    pix_step: int
    frame_pool: bool
    persistent: bool

    def chunks(self) -> list:
        """(first pixel, pixels) of every chunk, in order."""
        return [(start, min(self.pix_step, self.npix - start))
                for start in range(0, self.npix, self.pix_step)]

    def passes(self, done: int, spp: int) -> list:
        """(first sample, samples) of every pass from sample ``done`` to
        ``spp``, in order."""
        return [(s0, min(self.pass_spp, spp - s0)) for s0 in range(done, spp, self.pass_spp)]

    def pool(self, n: int) -> tuple:
        """(pix_count, accum_rows) of the persistent call over a chunk of
        ``n`` pixels (see ``persistent_accum``)."""
        if self.frame_pool:
            return n, n
        return (None if n == self.lanes else n), None


def frame_plan(config: RenderConfig, npix: int, pass_spp: int | None = None) -> FramePlan:
    """The ``FramePlan`` of a frame of ``npix`` pixels under ``config``, with
    passes of ``pass_spp`` samples (default ``config.spp_per_pass``; at
    least 1)."""
    lanes = pick_chunk(config, npix)
    frame_pool = config.frame_pool and config.compaction and npix > lanes
    return FramePlan(npix, lanes, max(1, pass_spp or config.spp_per_pass),
                     npix if frame_pool else lanes, frame_pool, config.compaction)


@contextlib.contextmanager
def chunk_pass(scene: TriangleScene, config: RenderConfig, plan: FramePlan, start: int, n: int,
               seed, sample_start: int, samples: int, *, eager: bool = False, phase=None):
    """One (chunk, pass) of ``plan``: ``samples`` samples from
    ``sample_start`` of the ``n`` pixels from ``start``, in one engine call
    of ``plan.lanes`` lanes (the persistent engine over the chunk's pool,
    ``plan.pool``; else the scan engine).  Yields (the mean radiance on the
    device, [lanes or pool rows, 3], and the rays traced) inside a
    ``chunk_pass`` span of the log (``start``, ``samples``), so that what
    the caller does with them is part of it.  The rays and the work counts
    are read in one host read right after the call and attached to its
    ``engine_call`` span (``attach_call_counts``); the scan engine counts
    no rays (0).  ``phase``, a context, is entered inside the span."""
    with span("chunk_pass", start=start, samples=samples), phase or contextlib.nullcontext():
        if plan.persistent:
            pix_count, rows = plan.pool(n)
            rad, counts = render_chunk_persistent(scene, start, seed, sample_start, plan.lanes,
                                                  samples, config, pix_count=pix_count,
                                                  accum_rows=rows, eager=eager)
            yield rad, attach_call_counts(counts)
        else:
            yield render_chunk(scene, start, seed, sample_start, plan.lanes, samples, config,
                               eager=eager), 0


def background(scene: TriangleScene) -> np.ndarray:
    """The frame of a scene with RAY_DEPTH 0: its background colour."""
    bg = scene.bg_color.detach().cpu().numpy().astype(np.float32)
    return np.broadcast_to(bg, (scene.camera.height, scene.camera.width, 3)).copy()


def record_rays(stats: dict | None, config: RenderConfig, device, measured: int,
                eager: bool = False) -> None:
    """With the persistent engine, ``stats["measured_rays"]`` = ``measured``
    and ``stats["loop"]`` the loop taken (``engine_loop``); the scan engine
    leaves ``stats`` untouched, as in the JAX package."""
    if stats is not None and config.compaction:
        stats["measured_rays"] = measured
        stats["loop"] = engine_loop(config, device, eager)


def render(scene: TriangleScene, spp: int, seed: int = 0, config: RenderConfig | None = None,
           progress: bool = False, timer=None, stats: dict | None = None, *,
           eager: bool = False) -> np.ndarray:
    """Full-frame render -> host numpy [H, W, 3] float32 HDR radiance.

    The chunks and passes of ``frame_plan``: pixel chunks of ``pick_chunk``
    lanes (or, with the persistent engine, the whole frame as one pool
    under ``config.frame_pool``) run ``spp_per_pass`` samples per engine
    call, a chunk's passes accumulated on the device; ``progress`` prints one tick
    per (chunk, pass) tile.  ``timer`` (a ``utils.profiling.PhaseTimer``)
    accumulates the JAX package's phases: "dispatch" (the engine calls; the
    eager loop also waits there at its per-iteration host reads) and
    "device_wait_readback" (the chunk's copy to the host).

    A chunk whose execution raises is recomputed, up to
    ``config.failure_retries`` times: the counter RNG makes a chunk a pure
    function of (scene, seed, range), so the frame equals an undisturbed
    one.  On a GPU a retry repairs what leaves the CUDA context usable: an
    out-of-memory error, or a kernel launch that failed to start.  It cannot
    repair a fault that kills the context (an illegal address, or a kernel
    trapped by ``mbar_wait_or_trap``): every later CUDA call fails the same
    way and the retries re-raise.  A CUDA graph capture that fails
    (``CaptureError``) is a fault of the engine's body and is never
    retried.  With the persistent engine ``stats["measured_rays"]``
    receives the number of rays traced (live lanes entering each bounce) by
    the executions that succeeded, and ``stats["loop"]`` the loop taken;
    the scan engine leaves ``stats`` untouched, as in the JAX package.
    Either engine runs its loop as a CUDA graph on CUDA (eagerly under
    intersector mode "bins") and as the same body uncaptured on the CPU
    (``persistent_accum``, ``scan_accum``); ``eager=True`` runs the eager
    loop instead.  Each (chunk, pass) runs through ``chunk_pass`` (its span,
    its engine call and the call's counts), and each chunk's copy to the
    host is a ``readback`` span."""
    config = config or RenderConfig()
    check_config(config)
    phase = timer.phase if timer is not None else (lambda _name: contextlib.nullcontext())
    h, w = scene.camera.height, scene.camera.width
    npix = h * w
    if scene.ray_depth == 0:
        return background(scene)
    spp = max(int(spp), 1)
    plan = frame_plan(config, npix)
    passes = plan.passes(0, spp)
    n_tiles = len(plan.chunks()) * len(passes)
    ticked = -1  # the last tile whose progress tick was printed

    def run(start: int, n: int):
        nonlocal ticked
        acc = None
        rays = 0
        for k, (s0, todo) in enumerate(passes):
            tile = start // plan.pix_step * len(passes) + k
            if progress and tile > ticked:  # a retry does not tick again
                print(f"{tile}/{n_tiles}     \r", end="", file=sys.stderr)
                ticked = tile
            with chunk_pass(scene, config, plan, start, n, seed, s0, todo, eager=eager,
                            phase=phase("dispatch")) as (rad, call_rays):
                rays += call_rays
                contrib = rad * float(todo)
                acc = contrib if acc is None else acc + contrib
        with phase("device_wait_readback"), span("readback"):
            return acc[:n].cpu().numpy(), rays

    out = np.zeros((npix, 3), dtype=np.float32)
    measured = 0
    for start, n in plan.chunks():
        for attempt in range(config.failure_retries + 1):
            try:
                host, rays = run(start, n)
                break
            except CaptureError:  # a fault of the loop's body: no retry hides it
                raise
            except Exception as err:  # a failed execution of this chunk
                if attempt == config.failure_retries:
                    raise
                print(f"chunk {start}: execution failed ({err}), retrying "
                      f"({attempt + 1}/{config.failure_retries})", file=sys.stderr)
        out[start:start + n] = host / spp
        measured += rays
    record_rays(stats, config, scene.device, measured, eager)
    return out.reshape(h, w, 3)
