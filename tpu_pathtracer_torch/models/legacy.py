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
package runs here either.  On CUDA both loops run as CUDA graphs (the port
of the JAX package's jitted ``_render_chunk``), each body captured once per
static configuration (``models/graph.py``): the Monte-Carlo body is one
sample, replayed once per sample with no host read, with its keys folded on
the device from a sample counter; the Whitted body is a block of
``WHITTED_ITERATIONS`` stack iterations, replayed until a block's one host
read finds every stack empty.  The CPU runs the same bodies without a
graph; ``eager=True`` runs the eager loops (host-int keys; one host read per
Whitted iteration).  The Monte-Carlo draws follow the JAX package's key
chain (``ops.rng.fold_in``), so both packages draw the same numbers for
every (seed, pixel, sample, bounce).
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
from .pathtracer import (
    compiled_body,
    gen_rays,
    load_inputs,
    run_block,
    sanitize_nans,
    _traced_scalars,
)

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

# Stack iterations of the Whitted search between two host reads of "is any
# stack left?" in the graph loop.  Chosen on one H100 80GB HBM3 at 700 W
# (chip_smoke.py phase homebrew; PERF.md): 4, 8 and 16 took 5.0 / 4.7, 7.1 /
# 6.9 and 8.9 / 8.5 ms per useful iteration of the 640x480 depth-8 scene (38
# iterations over 5 chunks): a block past the empty stacks costs a whole
# iteration of device time, a host read far less.
WHITTED_ITERATIONS = 4


class _WhittedSearch:
    """Deterministic Whitted tracing as a wavefront depth-first search over
    ``r`` lanes: every ray carries a stack of pending (origin, dir, weight,
    depth) entries; each iteration pops one entry per ray, shades it and
    pushes its reflected and refracted children.  An iteration on empty
    stacks changes nothing: ``active = top > 0`` is all false, and every
    mask (``live``, both pushes) follows from it."""

    def __init__(self, scene: PrimitiveScene, lights: _Lights, r: int, depth: int, eps: float):
        self.scene, self.lights, self.r, self.depth, self.eps = scene, lights, r, depth, eps
        self.c = max(_WHITTED_STACK, depth + 1)
        self.slots = torch.arange(self.c, device=scene.device)

    def start(self, origin, direction) -> dict:
        r, c, dev = self.r, self.c, origin.device
        st_o = torch.zeros((r, c, 3), device=dev)
        st_d = torch.zeros((r, c, 3), device=dev)
        st_w = torch.zeros((r, c, 3), device=dev)
        st_dep = torch.zeros((r, c), dtype=torch.int32, device=dev)
        st_o[:, 0] = origin
        st_d[:, 0] = direction
        st_w[:, 0] = 1.0
        st_dep[:, 0] = self.depth
        return dict(st_o=st_o, st_d=st_d, st_w=st_w, st_dep=st_dep,
                    top=torch.ones((r,), dtype=torch.int32, device=dev),
                    radiance=torch.zeros((r, 3), device=dev))

    def more(self, c: dict) -> torch.Tensor:
        """[] bool: some stack holds an entry."""
        return (c["top"] > 0).any()

    def _push(self, c: dict, mask, o_new, d_new, w_new, dep_new) -> None:
        at = mask[:, None] & (self.slots[None, :] == torch.clamp_max(c["top"], self.c - 1)[:, None])
        c["st_o"] = torch.where(at[:, :, None], o_new[:, None, :], c["st_o"])
        c["st_d"] = torch.where(at[:, :, None], d_new[:, None, :], c["st_d"])
        c["st_w"] = torch.where(at[:, :, None], w_new[:, None, :], c["st_w"])
        c["st_dep"] = torch.where(at, dep_new[:, None], c["st_dep"])
        c["top"] = torch.where(mask, torch.clamp_max(c["top"] + 1, self.c), c["top"])

    def iteration(self, c: dict) -> dict:
        scene, eps, r = self.scene, self.eps, self.r
        c = dict(c)
        top = c["top"]
        active = top > 0
        slot = torch.clamp_min(top - 1, 0).long()
        take3 = lambda st: torch.gather(st, 1, slot[:, None, None].expand(r, 1, 3))[:, 0]
        o, d, w = take3(c["st_o"]), take3(c["st_d"]), take3(c["st_w"])
        dep = torch.gather(c["st_dep"], 1, slot[:, None])[:, 0]
        c["top"] = torch.where(active, top - 1, top)

        hit = closest_hit(o, d, scene, eps)
        live = active & hit.hit
        pos = torch.where(live[:, None], o + hit.t[:, None] * d, o)
        prim = hit.prim.long()
        mat = scene.mat_kind[prim]
        color = scene.color[prim]
        ior = scene.ior[prim]
        n = hit.normal
        zero3 = torch.zeros_like(o)

        # Local term: miss -> bg; diffuse -> lit (or flat for stage-1 scenes).
        if scene.lit:
            diffuse = color * _direct_light(scene, self.lights, pos + n * eps, n, eps)
        else:
            diffuse = color
        local = torch.where(
            live[:, None], torch.where((mat == MAT_DIFFUSE)[:, None], diffuse, zero3),
            scene.bg_color.expand(r, 3),
        )
        c["radiance"] = c["radiance"] + torch.where(active[:, None], w * local, zero3)

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

        self._push(c, push_refl, pos + n * eps, rdir, w_refl, dep - 1)
        self._push(c, push_refr, pos - n * eps, refr_dir, w_refr, dep - 1)
        return c


def _whitted_trace(scene: PrimitiveScene, lights: _Lights, origin, direction, depth: int,
                   eps: float) -> torch.Tensor:
    """The eager Whitted search: one host read per iteration, ending once
    every stack is empty."""
    search = _WhittedSearch(scene, lights, origin.shape[0], depth, eps)
    c = search.start(origin, direction)
    running = True
    while running:
        c = search.iteration(c)
        render_homebrew.iterations += 1
        running = bool(search.more(c))
    return c["radiance"]


def _mc_trace(scene: PrimitiveScene, origin, direction, keys, pixel_ids,
              eps: float) -> torch.Tensor:
    """Course-style Monte-Carlo path over primitives: ``ray_depth`` bounces;
    bounce b draws from the key words ``keys[b]`` (``fold_in(key, b)``: host
    ints, or 0-d device tensors in the graphed body)."""
    o, d = origin, direction
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    zero3 = torch.zeros_like(o)
    alive = torch.isfinite(o[:, 0])
    for b in range(scene.ray_depth):
        draws = per_pixel_uniforms(*keys[b], pixel_ids, 4)

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


class _MCSample:
    """One Monte-Carlo sample over ``n_rays`` pixels, the body of the JAX
    package's ``fori_loop`` over samples: the sample's key ``fold_in(base,
    s)`` with ``s`` the carry ``sample`` (from 0), its jitter key
    ``fold_in(k, JITTER_DEPTH)`` and bounce keys ``fold_in(k, b)``, all
    folded on the device (one threefry over the ``ray_depth + 1`` counters),
    the jittered primary rays, the path, and the sanitized add into the
    accumulator.  The first pixel and the seed's key word are read from
    ``scalars``, the camera from ``camera``'s tensors."""

    def __init__(self, scene: PrimitiveScene, n_rays: int, eps: float, camera, scalars):
        dev = scene.device
        self.scene, self.eps, self.camera, self.scalars = scene, eps, camera, scalars
        self.chunk_start, self.seed = scalars.unbind()[:2]
        self.iota = torch.arange(n_rays, dtype=torch.int32, device=dev)
        self.counters = torch.tensor([JITTER_DEPTH, *range(scene.ray_depth)], dtype=torch.int64,
                                     device=dev)

    def start(self) -> dict:
        dev = self.iota.device
        return dict(acc=torch.zeros((self.iota.shape[0], 3), device=dev),
                    sample=torch.zeros((), dtype=torch.int64, device=dev))

    def step(self, c: dict) -> dict:
        s = c["sample"]
        pixel_ids = self.chunk_start + self.iota  # int32, as the eager loop's ids
        k0, k1 = fold_in(*key_words(self.seed), s)
        f0, f1 = fold_in(k0, k1, self.counters)
        offsets = per_pixel_uniforms(f0[0], f1[0], pixel_ids, 2)
        o, d = gen_rays(self.camera, pixel_ids, offsets)
        keys = [(f0[b + 1], f1[b + 1]) for b in range(self.scene.ray_depth)]
        rad = _mc_trace(self.scene, o, d, keys, pixel_ids, self.eps)
        return dict(acc=c["acc"] + sanitize_nans(rad), sample=s + 1)


def _render_chunk(scene: PrimitiveScene, lights: _Lights, chunk_start: int, seed: int,
                  n_rays: int, spp: int, config: RenderConfig, mc: bool,
                  eager: bool) -> torch.Tensor:
    dev = scene.device
    if not mc:
        pixel_ids = chunk_start + torch.arange(n_rays, dtype=torch.int32, device=dev)
        half = torch.full((2, n_rays), 0.5, device=dev)
        o, d = gen_rays(scene.camera, pixel_ids, half)
        if eager:
            return _whitted_trace(scene, lights, o, d, scene.ray_depth, config.eps)
        k = WHITTED_ITERATIONS
        entry = compiled_body("whitted", scene, config, (n_rays, k), lambda camera, buf: (
            _WhittedSearch(scene, lights, n_rays, scene.ray_depth, config.eps)))
        search = entry["body"]
        block = run_block(entry, search.iteration, search.more, search.start(o, d), k)
        while True:
            more = block.run()
            render_homebrew.iterations += k
            if not more:
                break
        # A copy: the next call of this body overwrites its buffers.
        return block.carries["radiance"].clone()
    if eager:
        pixel_ids = chunk_start + torch.arange(n_rays, dtype=torch.int32, device=dev)
        acc = torch.zeros((n_rays, 3), device=dev)
        base = key_words(seed)
        for s in range(spp):
            k = fold_in(*base, s)
            offsets = per_pixel_uniforms(*fold_in(*k, JITTER_DEPTH), pixel_ids, 2)
            o, d = gen_rays(scene.camera, pixel_ids, offsets)
            keys = [fold_in(*k, b) for b in range(scene.ray_depth)]
            acc = acc + sanitize_nans(_mc_trace(scene, o, d, keys, pixel_ids, config.eps))
            render_homebrew.iterations += 1
        return acc / spp
    entry = compiled_body("mc", scene, config, (n_rays,), lambda camera, buf: (
        _MCSample(scene, n_rays, config.eps, camera, buf)))
    body = entry["body"]
    load_inputs(body, scene.camera, _traced_scalars(dev, chunk_start, seed))
    block = run_block(entry, body.step, None, body.start(), 1)
    for _ in range(spp):
        block.run()
        render_homebrew.iterations += 1
    return block.carries["acc"] / spp


def render_homebrew(scene: PrimitiveScene, seed: int = 0,
                    config: Optional[RenderConfig] = None, *, eager: bool = False) -> np.ndarray:
    """Render a homebrew scene (tensors on the device it renders on) ->
    numpy [H, W, 3] float32 HDR.  Pixels go in chunks of
    ``min(config.rays_per_batch, H * W)`` lanes; the tail chunk is padded
    and its padding dropped.  The loops run as the bodies cached per static
    configuration (scene, config, lane count), one CUDA graph each on CUDA
    (a capture that fails raises ``CaptureError``), or eagerly under
    ``eager=True``; both give the same bits.  ``render_homebrew.iterations``
    counts the loop's iterations run: Whitted stack iterations (whole
    blocks in the graph loop), Monte-Carlo samples."""
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
    out = np.zeros((npix, 3), dtype=np.float32)
    for start in range(0, npix, chunk):
        n = min(chunk, npix - start)
        rad = _render_chunk(scene, lights, start, seed, chunk, spp, config, mc, eager)
        out[start:start + n] = rad[:n].cpu().numpy()
    return out.reshape(h, w, 3)


render_homebrew.iterations = 0
