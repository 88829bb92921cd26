"""Wavefront Monte-Carlo path tracer over triangle scenes (port of
``tpu_pathtracer/models/pathtracer.py``).

One sample of one pixel follows the reference estimator bounce for bounce
(src/raytracer.h:512-627), with every branch of ``shade`` as masked selects
over an R-lane wavefront.  Two engines, as in the JAX package: the
persistent one (``compaction=True``, the default) refills dead lanes with
fresh (pixel, sample) primaries every iteration (path regeneration); the
scan one (``compaction=False``) traces one sample of every lane through
``ray_depth`` bounces.  Large scenes sort the wavefront by a coherence key
before each bounce, and per-lane draws are the counter-based (seed, pixel,
sample, depth) stream, so both engines are the JAX package's estimator
draw for draw; only per-pixel summation order (and the intersector's fp
rounding) differ.

The loops run eagerly: one host read per iteration decides whether work
remains.  Unknown configuration values raise ``ValueError``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import IntersectTuning, RenderConfig
from ..ops import bsdf, sampling, texture
from ..ops.chunk_intersect import (
    RAY_TILE,
    check_tuning,
    closest_hit_chunks,
    group_boxes,
    light_pdf_sum_chunks,
    ray_sort_key,
    ray_sort_key_dirhint,
    ray_sort_key_hint,
    ray_sort_key_target,
    scene_bounds,
)
from ..ops.intersect import Hit, closest_hit, light_pdf_sum, light_pdf_sum_flat
from ..ops.rng import (
    SOBOL_TAG_LIGHT,
    SOBOL_TAG_VNDF,
    jitter_uniforms,
    lane_uniforms,
    sobol_owen_pair,
)
from ..ops.vecmath import cross, dot, frame_apply, length2, normalize, where3
from ..scene.types import Camera, TriangleScene

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


def bounce_draws(seed: int, sample, depth, pixel: torch.Tensor,
                 config: RenderConfig) -> torch.Tensor:
    """[_DRAWS, R] per-bounce estimator draws.  ``lowdisc="sobol"`` replaces
    the VNDF (2, 3) and light-point (8, 9) pairs by per-(pixel, depth)
    Owen-scrambled Sobol points over the sample index."""
    draws = lane_uniforms(seed, sample, depth, pixel, _DRAWS)
    if config.lowdisc == "sobol":
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


def scene_closest_hit(scene: TriangleScene, origin, direction, min_dst: float,
                      tuning: IntersectTuning) -> Hit:
    """Dense sweep for scenes of at most 1,024 triangles, the chunk cascade
    (kernels B1/B2 on CUDA) above that."""
    if scene.capacity <= 1024:
        return closest_hit(origin, direction, scene.woop, min_dst)
    tuning = tuning.resolve()
    tile = 256 if scene.chunk_woop.shape[0] > tuning.narrow_tile_chunks else RAY_TILE
    return closest_hit_chunks(
        origin, direction, scene.chunk_woop, scene.chunk_aabb_min,
        scene.chunk_aabb_max, scene.woop_rows, min_dst, ray_tile=tile, tuning=tuning,
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


def hit_info(scene: TriangleScene, direction, hit: Hit, config: RenderConfig) -> dict:
    """to_intersection_info (src/bvh.h:80-121): one packed-row gather per
    hit, then the texture fetch of the slots some material uses."""
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

    # An atlas of only the two builtin 1x1 textures makes every lookup the
    # identity; so does any slot no material maps to a real texture.
    has_textures = scene.atlas.offset.shape[0] > 2 and config.use_textures
    used = scene.tex_slots if has_textures else (False,) * 4
    gammas = (2.2, 2.2, 1.0, 1.0)
    slots = [k for k in range(4) if used[k]]
    at = {k: 4 * j for j, k in enumerate(slots)}  # slot -> first output lane
    if slots:
        uv = _interp_flat(row, 18, 2, hit.beta, hit.gamma)
        fetched = texture.sample_many(
            scene.atlas, tex_ids[:, slots], uv, tuple(gammas[k] for k in slots)
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
    spawns from (-1 elsewhere), the next bounce's sort key input."""
    eps = config.eps
    vf = config.vndf_factor
    lights = scene.lights
    hit = scene_closest_hit(scene, o, d, eps, config.tuning)

    if scene.has_env and config.use_textures:
        env = texture.env_radiance(scene.atlas, scene.env_tex, scene.bg_color, d)
    else:
        # No env map loaded: bg_at degenerates to bg_color.
        env = scene.bg_color
    miss = alive & ~hit.hit
    zero3 = torch.zeros_like(radiance)
    radiance = radiance + torch.where(miss[:, None], throughput * env, zero3)

    live = alive & hit.hit
    info = hit_info(scene, d, hit, config)
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
    n_lights = lights.count
    pick_light = (sampling.pick_uniform(draws[4], 2) == 1) & (n_lights > 0)
    li = sampling.pick_uniform(draws[7], n_lights).long()
    lv = lights.verts.reshape(-1, 9)[li]  # [R, 9]
    light_dir = sampling.light_triangle_sample(
        pos, lv[:, 0:3], lv[:, 3:6], lv[:, 6:9], draws[8], draws[9]
    )
    mix_dir = where3(pick_light, light_dir, cos_dir)
    new_dir = where3(use_vndf, vndf_dir, mix_dir)

    # pdf blend (src/raytracer.h:572-574)
    p_vndf = sampling.vndf_pdf(alpha_r2, d, info["shading_normal"], new_dir, eps)
    p_cos = sampling.cosine_pdf(info["normal"], new_dir)
    # The same choice as the JAX package makes on its chip, on every device:
    # the cluster worklists (kernel B3) past 512 light slots, the flat
    # contraction for up to 4 clusters, the dense reduce otherwise.
    if lights.has_clusters and lights.capacity > 512:
        r = pos.shape[0]
        tile = RAY_TILE if r % RAY_TILE == 0 else 256
        p_light = light_pdf_sum_chunks(
            pos, new_dir, lights.cluster_woop, lights.cluster_k, lights.cluster_min,
            lights.cluster_max, n_lights, eps, ray_tile=tile,
        )
    elif lights.has_clusters and lights.cluster_woop.shape[0] <= 4:
        p_light = light_pdf_sum_flat(
            pos, new_dir, lights.cluster_woop, lights.cluster_k, n_lights, eps
        )
    else:
        p_light = light_pdf_sum(
            pos, new_dir, lights.verts, lights.normal, lights.area, n_lights, eps
        )
    p_mix = (p_cos + p_light) / 2.0 if n_lights > 0 else p_cos
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
    return o, d, throughput, radiance, moved, hint


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


def persistent_accum(
    scene: TriangleScene,
    chunk_start: int,  # first linear pixel id of this lane block
    seed: int,
    sample_start: int,  # first global sample index
    n_rays: int,  # lane count
    w_total: int,  # work-pool size (pixels * samples)
    config: RenderConfig,
    pix_count: int | None = None,  # pixels of the pool (None = n_rays)
    accum_rows: int | None = None,  # accumulator rows (None = n_rays)
):
    """Persistent wavefront with path regeneration.  Work item w covers
    (pixel slot w % P, local sample w // P), P = pix_count or n_rays.
    Returns ([rows, 3] radiance sum, [] int64 live lanes summed over
    bounces = rays traced)."""
    dev = scene.device
    pool_pix = n_rays if pix_count is None else pix_count
    rows = n_rays if accum_rows is None else accum_rows
    sort_rays = scene.capacity > 1024 and n_rays >= 2048
    key_fn = _make_sort_key(scene, config, n_rays) if sort_rays else None
    far = torch.full((3,), 1e30, device=dev)

    def spawn(work_ids, valid):
        w = torch.where(valid, work_ids, torch.zeros_like(work_ids))
        slot = (w % pool_pix).to(torch.int32)
        s = (w // pool_pix).to(torch.int32)
        pids = chunk_start + slot
        o, d = gen_rays(scene.camera, pids,
                        jitter_uniforms(seed, sample_start + s, pids, config.jitter))
        return o, d, slot, s

    iota = torch.arange(n_rays, dtype=torch.int64, device=dev)
    valid0 = iota < w_total
    o, d, slot, sample = spawn(iota, valid0)
    alive = valid0 & torch.isfinite(o[:, 0])
    active = alive.clone()
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    depth = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    hint = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    next_work = torch.tensor(min(n_rays, w_total), dtype=torch.int64, device=dev)
    accum = torch.zeros((rows + 1, 3), device=dev)  # last row: drop target
    n_bounce = torch.zeros((), dtype=torch.int64, device=dev)

    while bool(alive.any() | (next_work < w_total)):
        if sort_rays:
            perm = torch.argsort(key_fn(o, d, alive, hint), stable=True)
            o, d, throughput, radiance = o[perm], d[perm], throughput[perm], radiance[perm]
            alive, active, slot = alive[perm], active[perm], slot[perm]
            sample, depth, hint = sample[perm], depth[perm], hint[perm]
        n_bounce = n_bounce + alive.sum()
        draws = bounce_draws(seed, sample_start + sample, depth, chunk_start + slot, config)
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
        accum.index_add_(0, torch.where(done, slot, rows).long(), contrib)

        # Regenerate: freed lanes pull the next work items.
        free = done | ~active
        work_ids = next_work + torch.cumsum(free.to(torch.int64), 0) - 1
        take = free & (work_ids < w_total)
        no, nd, nslot, nsample = spawn(work_ids, take)
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
        next_work = torch.clamp_max(next_work + free.sum(), w_total)
        if sort_rays:
            # Park dead lanes far away so their tiles activate no chunk.
            o = where3(alive, o, far)
    return accum[:rows], n_bounce


def render_chunk_persistent(scene, chunk_start: int, seed: int, sample_start: int,
                            n_rays: int, spp: int, config: RenderConfig,
                            pix_count: int | None = None, accum_rows: int | None = None):
    """Mean radiance over ``spp`` samples of one pixel pool, and the rays
    traced."""
    pool_pix = n_rays if pix_count is None else pix_count
    acc, n_bounce = persistent_accum(
        scene, chunk_start, seed, sample_start, n_rays, pool_pix * spp, config,
        pix_count=pix_count, accum_rows=accum_rows,
    )
    return acc / spp, n_bounce


def trace(scene: TriangleScene, origin, direction, seed: int, pixel_ids: torch.Tensor,
          config: RenderConfig, sample=0) -> torch.Tensor:
    """The scan engine's bounce loop: one full path per input ray, over at
    most ``ray_depth`` wavefront bounces, stopping early once every ray is
    dead (a host read per bounce).  Returns [R, 3] radiance in input order,
    not NaN-sanitized."""
    r = origin.shape[0]
    dev = origin.device
    sort_rays = scene.capacity > 1024 and r >= 2048
    key_fn = _make_sort_key(scene, config, r) if sort_rays else None
    far = torch.full((3,), 1e30, device=dev)
    o, d = origin, direction
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    alive = torch.isfinite(o[:, 0])
    pids = pixel_ids
    slot = torch.arange(r, dtype=torch.int32, device=dev)  # input position of each lane
    hint = torch.full((r,), -1, dtype=torch.int32, device=dev)
    for depth in range(scene.ray_depth):
        if not bool(alive.any()):
            break
        if sort_rays:
            perm = torch.argsort(key_fn(o, d, alive, hint), stable=True)
            o, d, throughput, radiance = o[perm], d[perm], throughput[perm], radiance[perm]
            alive, pids, slot, hint = alive[perm], pids[perm], slot[perm], hint[perm]
        draws = bounce_draws(seed, sample, depth, pids, config)
        o, d, throughput, radiance, alive, hint = bounce_step(
            scene, config, o, d, throughput, radiance, alive, draws
        )
        if sort_rays:
            # Park dead rays far away so their tiles activate no chunk.
            o = where3(alive, o, far)
    # Depth exhaustion: the reference's deepest call returns {0,0,0}, which
    # a NaN throughput chain turns into NaN (src/raytracer.h:596-598).
    radiance = radiance + torch.where(alive[:, None], throughput * 0.0, torch.zeros_like(radiance))
    if sort_rays:
        radiance = radiance[torch.argsort(slot)]  # undo the composed permutation
    return radiance


def render_chunk(scene: TriangleScene, chunk_start: int, seed: int, sample_start: int,
                 n_rays: int, spp: int, config: RenderConfig) -> torch.Tensor:
    """The scan engine: mean radiance over ``spp`` samples of the ``n_rays``
    pixels from ``chunk_start`` (render_pixel, src/raytracer.h:618-627)."""
    pids = chunk_start + torch.arange(n_rays, dtype=torch.int32, device=scene.device)
    acc = torch.zeros((n_rays, 3), device=scene.device)
    for s in range(spp):
        gs = sample_start + s
        o, d = gen_rays(scene.camera, pids, jitter_uniforms(seed, gs, pids, config.jitter))
        acc = acc + sanitize_nans(trace(scene, o, d, seed, pids, config, sample=gs))
    return acc / spp


def pick_chunk(config: RenderConfig, npix: int) -> int:
    """Lane count: bounded by config, rounded up to the ray tile (the
    persistent engine never spawns the padding lanes: the tail chunk passes
    its pixel count; the scan engine renders them and drops them)."""
    chunk = min(config.rays_per_batch, npix)
    return chunk + ((-chunk) % RAY_TILE)


def render(scene: TriangleScene, spp: int, seed: int = 0, config: RenderConfig | None = None,
           progress: bool = False, stats: dict | None = None) -> np.ndarray:
    """Full-frame render -> host numpy [H, W, 3] float32 HDR radiance.

    Pixel chunks of ``pick_chunk`` lanes (or, with the persistent engine,
    the whole frame as one pool under ``config.frame_pool``) run
    ``spp_per_pass`` samples per engine call.  A chunk whose device
    execution fails is recomputed, up to ``config.failure_retries`` times:
    the counter RNG makes a chunk a pure function of (scene, seed, range).
    With the persistent engine ``stats["measured_rays"]`` receives the
    number of rays traced (live lanes entering each bounce); the scan engine
    leaves ``stats`` untouched, as in the JAX package."""
    config = config or RenderConfig()
    check_config(config)
    h, w = scene.camera.height, scene.camera.width
    npix = h * w
    if scene.ray_depth == 0:
        bg = scene.bg_color.cpu().numpy().astype(np.float32)
        return np.broadcast_to(bg, (h, w, 3)).copy()
    spp = max(int(spp), 1)
    chunk = pick_chunk(config, npix)
    pass_spp = max(1, min(config.spp_per_pass, spp))
    frame_pool = config.frame_pool and config.compaction and npix > chunk
    pix_step = npix if frame_pool else chunk
    n_tiles = -(-npix // pix_step) * -(-spp // pass_spp)
    done_tiles = 0

    def run(start: int, n: int):
        nonlocal done_tiles
        acc = None
        rays = 0
        for s0 in range(0, spp, pass_spp):
            if progress:
                print(f"{done_tiles}/{n_tiles}     \r", end="", file=sys.stderr)
                done_tiles += 1
            todo = min(pass_spp, spp - s0)
            if not config.compaction:
                rad = render_chunk(scene, start, seed, s0, chunk, todo, config)
            else:
                if frame_pool:
                    pc, ar = n, n
                else:
                    pc, ar = (None if n == chunk else n), None
                rad, nb = render_chunk_persistent(
                    scene, start, seed, s0, chunk, todo, config, pix_count=pc, accum_rows=ar
                )
                rays += int(nb)
            contrib = rad * float(todo)
            acc = contrib if acc is None else acc + contrib
        return acc[:n].cpu().numpy(), rays

    out = np.zeros((npix, 3), dtype=np.float32)
    measured = 0
    for start in range(0, npix, pix_step):
        n = min(pix_step, npix - start)
        for attempt in range(config.failure_retries + 1):
            try:
                host, rays = run(start, n)
                break
            except RuntimeError as err:  # a failed device execution
                if attempt == config.failure_retries:
                    raise
                print(f"chunk {start}: device execution failed ({err}), retrying "
                      f"({attempt + 1}/{config.failure_retries})", file=sys.stderr)
        out[start:start + n] = host / spp
        measured += rays
    if stats is not None and config.compaction:
        stats["measured_rays"] = measured
    return out.reshape(h, w, 3)
