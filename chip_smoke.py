#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``tpu_pathtracer_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``tpu_pathtracer_torch/csrc`` (one
``nvcc`` per source, in parallel) and holds each kernel against its
plain-torch twin on the inputs of the real paths, 65,536-ray batches:

  b1, b2, cascade  the enclosed atrium (~218k triangles): activity and item
                   kernels, and the cascade against the dense sweep; B1 also
                   at the super-block gate's width (4 columns) and on the
                   lit-banner atrium's 193 light-cluster boxes;
  b4               the first-entered-group kernel on the atrium's groups;
  b5, b6, b7       the dense-grid, slot-grid and per-ray-group-bits kernels
                   of the intersector's modes on the atrium's rays;
  modes            ``closest_hit_chunks`` under "twopass", "dense", "bins"
                   and the cheap rechecks against the brute force, and a
                   forced bins overflow;
  b3               the light-pdf kernel on the lit-banner atrium (the
                   atrium with its green banners emissive: ~24,600 lights
                   in 193 clusters);
  shading          K1, the flat light-cluster pdf, on the atrium's and the
                   env field's rays (its twin's zero pattern, relative
                   error <= 1e-5), and K2, ``hit_info``'s row gather and
                   texture fetch, on those, the textured Cornell box and an
                   asset that uses every texture slot, with the quad and the
                   flat texel pool (within 2 ulp of its twin; 0 so far);
                   both timed beside their twins, K1 also beside B3 over a
                   full worklist;
  shade_chain      K3 and K4, the bounce's sampling / BSDF chain before
                   and after the light pdf, against their twins bit for bit
                   on the atrium's and the env field's rays, timed beside
                   the twins and against their bytes' bound; then the shade
                   class of the atrium's captured block (device operations
                   an iteration, their names) with the kernels and with the
                   twins, and the frames of kernels (graph and eager) and
                   twins equal bit for bit.

Then it renders, each at 512x512 @ 16 spp with the launch counters set to 0
just before and read just after:

  main             the atrium through the CLI (``cli.main``), sort key "hint";
  lights_main      the lit-banner atrium through the CLI (kernel B3);
  env_main         the textured sphere field (~82k triangles) with a
                   Radiance HDR environment map and the camera light
                   triangle, through ``cli.render_scene_file``;
  sort_keys        the atrium through ``render`` under the "target" (kernel
                   B4), "cell" and "dirhint" keys;
  modes_render     the atrium under "twopass" (B6) and "bins" (B7) at 16 spp,
                   "dense" (B5) and the cheap rechecks at 4 spp beside an
                   "items" render at 4 spp;
  engine           the atrium through the scan engine with Sobol jitter and
                   bounce draws at 4 spp; then eager, graph, graph, eager
                   (frames bit-identical), ms per wavefront bounce and each
                   loop's device busy share;
  renderer         two ``look_at`` frames of the atrium through ``Renderer``
                   (no re-upload of the scene, no kernel rebuild);
  checkpoint       the atrium through ``render_with_checkpoints``: 8 spp in
                   passes of 4, resumed to 16, bit-equal to an uninterrupted
                   checkpointed render; then ``add_rows``, the engine's
                   accumulation, timed beside ``index_add_`` (accumulate);
  headline         ``tpu_pathtracer_torch.run_headline``'s ``main`` in this
                   process, the atrium at 1000x1000, 16 spp in checkpoints
                   of 8, then ``python -m tpu_pathtracer_torch.run_headline``
                   supervised (``HEADLINE_SUPERVISE=1``) in a process of its
                   own, resuming the checkpoint to 24 spp;
  sharded          in a world-size-1 NCCL process group, the atrium through
                   ``render_sharded`` on a 1x1 mesh (measured rays equal to
                   the main render's), ``render_multihost`` with a
                   checkpoint, and ``render_sharded`` with the scan engine
                   (frame bit-identical to phase engine's);

and, with the persistent engine's loop as one CUDA graph (the default on
the card) against the per-iteration eager loop:

  rng              the threefry kernel against its twin, bit for bit, in
                   the bounce, camera-jitter, key-words and homebrew forms
                   (every instance of the kernel) on 65,536 lanes and at
                   the ragged 1 and 65,537, the bounce and jitter forms
                   also on 262,144 and 1,048,576 lanes: timed at each lane
                   count beside an empty launch, with the intercept (a
                   launch's fixed cost) and slope (its cost a lane) of the
                   line through the times;
  graph            the atrium at 512x512 @ 16 spp eager, graph, graph,
                   eager (frames identical, measured rays equal), the
                   graph's iterations per host read K tried at 4, 8, 16 and
                   32 in turns, the device's busy share of both loops from
                   ``torch.profiler``, the same identity at 4 spp under
                   "twopass", on the lit-banner atrium and on the env field,
                   and two ``Renderer`` frames through the cached graph;
  worklist         K5, a cascade pass's worklist, against its twin (the
                   cascade's torch chain) bit for bit: every pass of the
                   cascade on the atrium's rays at 512- and 256-ray tiles,
                   and random passes at ``bigatrium``'s 256 tiles x 1,203
                   groups and at 4,500 groups (keys past shared memory);
                   timed beside the twin at the atrium's first near pass and
                   residual;
  tile256          the atrium with ``TPU_PT_NARROW_TILE_CHUNKS`` lowered
                   below its chunk count: B1 and B2 at 256-ray tiles against
                   their twins, the cascade against the brute force, and a
                   16-spp graphed render at 512-ray tiles against 256;

checks the Cornell goldens (plain, environment map PNG and HDR, light
triangle, Sobol bounce draws, Sobol jitter) at 64x64 @ 64 spp and, in phase
goldens_more, the textured Cornell at 64x64 and the plain one at 96x64;
runs the benchmark (``python3 -m tpu_pathtracer_torch.bench``'s ``main``)
at 256x256 @ 4 spp with 3 repeats of the atrium and the field in turns
(phase bench, last); and renders the homebrew ``.txt`` scenes (no kernel:
plain torch):

  homebrew         a Whitted scene at RAY_DEPTH 8 and a Monte-Carlo scene,
                   card against CPU at 64x48, then at 640x480 (the
                   Monte-Carlo one at 64 spp) eager, graph, graph, eager
                   (frames bit-identical), ms per stack iteration or bounce,
                   each loop's device busy share, and the Whitted graph's
                   iterations per host read K at 4, 8, 16 in turns;
  cli_txt          both through ``python -m tpu_pathtracer_torch`` at
                   160x120 in a process of their own.

Every phase prints one JSON line; any failure raises, so the script exits
non-zero without the final line.  ``python3 chip_smoke.py shading
shade_chain worklist engine homebrew sharded headline`` (any of them) runs only
those phases after the build;
``python3 chip_smoke.py headline_full`` runs the JAX package's headline
workload (the atrium at 1000x1000 @ 1000 spp in checkpoints of 50) and
holds its frame against the JAX package's committed frame by the fp-noise
rule, keeping the frame in ``build/headline_full/``.  The
last two lines before the final one are the kernel table and the card's
``nvidia-smi`` name and power limit; the final line is ``{"ok": true,
"device": {...}}``.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch

from tpu_pathtracer_torch import kernels
from tpu_pathtracer_torch.utils.profiling import card_line

ROOT = os.path.dirname(os.path.abspath(__file__))
W = H = 512
SPP = 16
EPS = 1e-4  # RenderConfig.eps, the intersector's min_dst
DEV = "cuda"
N_RAYS = 1 << 16  # RenderConfig.rays_per_batch

# The least time a kernel could take (``bound_ms``): the larger of its bytes
# (each input read once, each output written once) over the H100's 3.35 TB/s
# and its lane operations over the float32 peak.  The published 67 TFLOP/s
# counts a fused multiply-add as two operations; the kernels are built with
# --fmad=false, so each add, multiply, compare or select is one operation of
# one lane: SMs x 128 lanes x 1.98 GHz (33.45 T/s on 132 SMs).
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
# Lane operations per pair, counted from the sources.  A Woop pair
# (csrc/stage.cuh woop_hit + the running first minimum): 18 + 15 products
# and sums, 4 for beta and gamma, 8 for the tests, ~6 for the IEEE divide,
# 4 for the select and the minimum.  A light-pdf pair: the same test and the
# term t*t*|d|^2*k/|q2| with its second divide and sum, ~65.  A slab pair
# (csrc/slab.cuh slab_interval + csrc/chunk_kernels.cu activity_kernel): 12
# differences and products, 10 NaN-propagating min/max, ~8 for the tests and
# the entry minimum.  A NaN-propagating min/max counts as ONE operation: the
# card has it as one instruction (min.NaN.f32 / max.NaN.f32), and a bound is
# the least the card could do, whatever the source spells out.
WOOP_OPS = 55
PDF_OPS = 65
SLAB_OPS = 30
# The threefry kernel (csrc/rng_kernels.cu) runs integer operations on two
# pipes.  Each of an SM's four schedulers dispatches one warp instruction a
# clock; the ALU pipe and the FMA pipe each take 16 lanes a clock of a
# scheduler's, 64 an SM (INT_PIPE_LANES).  Counted from what the function
# needs a lane, by the pipes that can run each operation: only the ALU pipe
# rotates (SHF), xors (LOP3, which xors three words at once) and shifts and
# ors a draw's bits into a float (LEA.HI); only the FMA pipe subtracts the
# 1 (FADD); an add runs on either (IADD3 or IMAD), so the adds go where they
# balance the two (``rng_lane_ops``).  A threefry block is 20 rounds of an
# add, a rotate and a xor, 2 first adds and 10 key-injection adds (the
# round number folds into a three-way add).  The SASS of the 10-draw
# instance (``python3 -m tpu_pathtracer_torch.tune_kernels sass rng_kernels
# uniforms_kernel``) holds the same 120 SHF, 122 LOP3, 10 LEA.HI and 10 FADD
# and 201 adds (39 IADD3 / VIADD, 162 IMAD) against the 195 counted here.
RNG_BLOCK_ALU = 40  # 20 rotates and 20 xors
RNG_BLOCK_ADDS = 32  # 20 round adds, 2 first adds, 10 key injections
INT_PIPE_LANES = 64


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def sync_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs for a kernel
    shorter than the host's time to launch it: the card first spins for ~20
    ms while the host queues every launch, so the launches then run back to
    back and the events time the device, not the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.02 * CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bound(pipes, n_bytes):
    """(bound_ms, bound_by) for work of ``pipes`` {pipe: (lane operations,
    lanes of an SM that pipe takes a clock)} that moves ``n_bytes``: the
    busiest pipe's time against the bytes' time."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_ops = max(ops / (sms * per_clock * CLOCK_HZ) for ops, per_clock in pipes.values()) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card_line(), torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():

    t0 = time.perf_counter()
    info = kernels.build()
    wall = time.perf_counter() - t0
    for name, lib in info.items():
        with open(os.path.join(kernels.BUILD_DIR, f"nvcc_{name}.log")) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
        kernels.library(name)
        emit("build", library=name, built=lib["built"], nvcc_seconds=round(lib["seconds"], 3),
             ptxas=ptxas)
    emit("build", libraries=len(info), wall_seconds=round(wall, 3))


def make_inputs(tmp, lit_banners=False):
    """The atrium (or the lit-banner atrium) on the card, its first 65,536
    primary rays and one bounce of their sorted, compacted secondaries."""
    import dataclasses

    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.scene import fixtures, gltf

    try:
        import PIL  # noqa: F401
        textured = True
    except ImportError:
        textured = False
    t0 = time.perf_counter()
    make = fixtures.make_lit_banner_atrium_gltf if lit_banners else fixtures.make_atrium_gltf
    name = "lit_atrium" if lit_banners else "atrium"
    path = make(os.path.join(tmp, name, "atrium.gltf"), detail=2, textured=textured)
    t_gen = time.perf_counter() - t0
    config = pt.RenderConfig()
    t0 = time.perf_counter()
    scene = gltf.parse_gltf_scene(path, W / H, config)
    t_parse = time.perf_counter() - t0
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(W, H)).to(DEV)
    if gltf.native.load_library() is None:
        raise AssertionError("the port's native packer (csrc/accel_pack.cpp) did not build or load")
    emit("inputs", scene=name, pil=textured, native_packer=gltf.native.LIBRARY,
         triangles=int(scene.valid.sum()), chunks=scene.chunk_woop.shape[0],
         lights=scene.lights.count, light_clusters=scene.lights.cluster_woop.shape[0],
         gen_seconds=round(t_gen, 3), parse_seconds=round(t_parse, 3))
    return path, textured, t_gen, scene, bounce_rays(scene, config)


def bounce_rays(scene, config, stride=1):
    """65,536 primary rays of the scene, through every ``stride``-th pixel
    from the first, and one bounce of their sorted, compacted secondaries
    (the surviving lanes' hit points and new directions: the light pdf's
    inputs; dead lanes parked at 1e30)."""
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.ops.rng import jitter_uniforms

    n = N_RAYS
    pids = torch.arange(n, dtype=torch.int32, device=DEV) * stride
    o, d = pt.gen_rays(scene.camera, pids, jitter_uniforms(0, 0, pids))
    alive = torch.ones(n, dtype=torch.bool, device=DEV)
    draws = pt.bounce_draws(0, 0, 0, pids, config)
    o2, d2, _, _, alive2, hint = pt.bounce_step(
        scene, config, o, d, torch.ones_like(o), torch.zeros_like(o), alive, draws
    )
    key = pt._make_sort_key(scene, config, n)(o2, d2, alive2, hint)
    perm = torch.argsort(key, stable=True)
    o2, d2, alive2 = o2[perm], d2[perm], alive2[perm]
    o2 = torch.where(alive2[:, None], o2, torch.full_like(o2, 1e30))
    return {"primary": (o, d), "secondary": (o2, d2)}


def check_b1(rays_name, mode, args):
    """One B1 launch against its twin on the same inputs: m8, ent and (when
    asked) sub_ent exactly equal.  Returns the max abs error of ent."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    mk, ek, sk = kernels.activity(*args)
    mp, ep, sp = ci.tile_chunk_activity_plain(*args)
    torch.cuda.synchronize()
    bad_m8 = int((mk != mp).sum())
    bad_ent = int((ek != ep).sum())
    bad_sub = int((sk != sp).sum()) if sp is not None else 0
    fin = torch.isfinite(ep)
    err = float((ek[fin] - ep[fin]).abs().max()) if fin.any() else 0.0
    emit("b1", rays=rays_name, mode=mode, columns=args[1].shape[0], n_sub=args[7],
         active_pairs=int((mp != 0).sum()), m8_mismatch=bad_m8, ent_mismatch=bad_ent,
         sub_mismatch=bad_sub, max_abs_err=err)
    if bad_m8 or bad_ent or bad_sub:
        raise AssertionError(f"B1 kernel disagrees with its twin ({rays_name}, {mode})")
    return err


def phase_b1(scene, rays_sets):
    """B1 kernel vs its twin at the shapes the render launches: the chunk
    boxes unbounded, t-bounded, gated, and gated and t-bounded with sub-tile
    entries (n_sub 8), and the super-block gate itself (one box per 512
    chunks, n_sub 1), unbounded and t-bounded.  m8 / ent / sub_ent must be
    exactly equal (both sides round the same IEEE ops in the same order: the
    kernel is built with --fmad=false).  Returns (max abs error, {shape:
    timing args} on the secondaries)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    cmin, cmax = scene.chunk_aabb_min, scene.chunk_aabb_max
    gmin, gmax = ci.group_boxes(cmin, cmax, ci.ACT_COLS)
    worst, timing = 0.0, None
    for name, (o, d) in rays_sets.items():
        rays = ci.pack_rays(o, d)
        tb = ci.closest_hit_chunks(o, d, scene.chunk_woop, cmin, cmax, scene.woop_rows, EPS).t
        cbits = ci.super_block_bits(rays, cmin, cmax, EPS, ci.RAY_TILE)
        cases = {
            "unbounded": (rays, cmin, cmax, None, None, EPS, ci.RAY_TILE, 8, False),
            "bounded": (rays, cmin, cmax, tb, None, EPS, ci.RAY_TILE, 8, False),
            "gated": (rays, cmin, cmax, None, cbits, EPS, ci.RAY_TILE, 8, False),
            "gated_bounded": (rays, cmin, cmax, tb, cbits, EPS, ci.RAY_TILE, 8, False),
            "gated_bounded_sub": (rays, cmin, cmax, tb, cbits, EPS, ci.RAY_TILE, 8, True),
            "gate": (rays, gmin, gmax, None, None, EPS, ci.RAY_TILE, 1, False),
            "gate_bounded": (rays, gmin, gmax, tb, None, EPS, ci.RAY_TILE, 1, False),
        }
        for mode, args in cases.items():
            worst = max(worst, check_b1(name, mode, args))
        if name == "secondary":
            # The three launches of a render iteration: the gate, the gated
            # initial pass and a gated t-bounded recheck.
            timing = {"gate": cases["gate"], "initial": cases["gated"],
                      "recheck": cases["gated_bounded"]}
    return worst, timing


def worklists(scene, o, d):
    """The first near pass's and a residual-sized worklist of the real
    cascade on these rays (the cascade's own glue functions)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    group = ci.GROUP
    c = scene.chunk_woop.shape[0]
    cg = -(-c // group)
    cw = ci._nan_pad(scene.chunk_woop, cg * group).contiguous()
    cmin = ci._nan_pad(scene.chunk_aabb_min, cg * group).contiguous()
    cmax = ci._nan_pad(scene.chunk_aabb_max, cg * group).contiguous()
    rays = ci.pack_rays(o, d)
    cbits = ci.super_block_bits(rays, cmin, cmax, EPS, ci.RAY_TILE)
    m8, ent, _ = ci.tile_chunk_activity(rays, cmin, cmax, None, cbits, EPS, ci.RAY_TILE, 8)
    ga, ge = ci._group_stats(m8 != 0, ent, group)
    packed = ci._pack_group_masks(m8, group)
    out = {}
    for name, cap in (("near1", max(4, cg // 9) * 2 // 4), ("residual", cg)):
        idx, counts, _ = ci._worklist(ga, ge, cap)
        masks = torch.take_along_dim(packed, idx[:, :, None].long(), dim=1)
        out[name] = (idx.contiguous(), counts.contiguous(), masks.contiguous())
    return rays, cw, out


def b2_kernel(*args):
    """``kernels.items`` on B2's twin's arguments, with the unit prefix sum
    its wrapper passes (``ci.item_unit_offsets``)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    counts, masks, _, group, n_sub = args[5:]
    return kernels.items(*args, ci.item_unit_offsets(counts, masks, group, n_sub))


def phase_b2(scene, rays_sets):
    """B2 kernel vs its twin on real worklists: t and tri bit-equal to the
    twin (ties included) and across two runs.  Returns (max abs error,
    timing args, set mask bits of the timing worklist)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    worst = 0.0
    timing = units = None
    for name, (o, d) in rays_sets.items():
        rays, cw, wls = worklists(scene, o, d)
        r = rays.shape[0]
        t0 = torch.full((r,), math.inf, device=DEV)
        i0 = torch.zeros((r,), dtype=torch.int32, device=DEV)
        for wl_name, (idx, counts, masks) in wls.items():
            args = (rays, t0, i0, cw, idx, counts, masks, EPS, ci.GROUP, 8)
            tk, ik = b2_kernel(*args)
            tk2, ik2 = b2_kernel(*args)
            tp, ip = ci.run_items_plain(*args)
            torch.cuda.synchronize()
            bits = int(ci.item_unit_offsets(counts, masks, ci.GROUP, 8)[-1])
            equal = bool(torch.equal(tk, tp) and torch.equal(ik, ip))
            det = bool(torch.equal(tk, tk2) and torch.equal(ik, ik2))
            worst = max(worst, compare_hits("b2", name, tk, ik, tp, ip, worklist=wl_name,
                                            items=int(counts.sum()), set_bits=bits,
                                            bit_equal_to_twin=equal, deterministic=det))
            if not (equal and det):
                raise AssertionError(f"B2 is not bit-equal to its twin or itself ({name}, {wl_name})")
            if name == "secondary" and wl_name == "residual":
                timing, units = args, bits
    return worst, timing, units


def brute_force(scene, o, d):
    """The closest hit in the kernels' own arithmetic: the B2 twin run over
    every chunk group of every tile with all sub-tile bits set."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    group = ci.GROUP
    cg = -(-scene.chunk_woop.shape[0] // group)
    cw = ci._nan_pad(scene.chunk_woop, cg * group).contiguous()
    r = o.shape[0]
    t_tiles = r // ci.RAY_TILE
    idx = torch.arange(cg, dtype=torch.int32, device=DEV).expand(t_tiles, cg).contiguous()
    counts = torch.full((t_tiles,), cg, dtype=torch.int32, device=DEV)
    masks = torch.full((t_tiles, cg, 2), -1, dtype=torch.int32, device=DEV)
    return ci.run_items_plain(
        ci.pack_rays(o, d), torch.full((r,), math.inf, device=DEV),
        torch.zeros((r,), dtype=torch.int32, device=DEV), cw, idx, counts, masks,
        EPS, group, 8,
    )


def check_brute(phase, label, scene, o, d, got, brute):
    """``got`` (an intersector's Hit) against the brute force: t exactly
    equal (a differing triangle is then an exact-t tie) except on rays whose
    own slab test, rounded, cannot reach the brute-force winner's chunk
    before the ray's hit (a hit on a chunk's AABB face, which the JAX
    package's modes share).  Each differing ray is checked for that and
    printed; they may be at most 0.1% of the rays.  Returns the printed
    fields."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    t_bf, tri_bf = brute
    bf_hit = torch.isfinite(t_bf)
    differ = (bf_hit != got.hit) | (bf_hit & (got.t != t_bf))
    bf_ties = int(((got.tri != tri_bf) & bf_hit & ~differ).sum())
    ids = differ.nonzero()[:, 0]
    ch = torch.div(tri_bf[ids], ci.CHUNK_TRIS, rounding_mode="floor").long()
    oo, dd = o[ids], d[ids]
    inv = 1.0 / torch.where(dd == 0, torch.full_like(dd, 1e-30), dd)
    t1 = (scene.chunk_aabb_min[ch] - oo) * inv
    t2 = (scene.chunk_aabb_max[ch] - oo) * inv
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t_lo = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    t_hi = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    reach = (t_lo <= t_hi) & (t_hi >= EPS) & (t_lo <= got.t[ids])
    for k in range(min(8, ids.numel())):
        emit(phase + "_diff", rays=label, ray=int(ids[k]), t_brute=float(t_bf[ids[k]]),
             tri_brute=int(tri_bf[ids[k]]), t_got=float(got.t[ids[k]]),
             tri_got=int(got.tri[ids[k]]), slab_t_lo=float(t_lo[k]),
             slab_t_hi=float(t_hi[k]), reachable=bool(reach[k]))
    if bool(reach.any()) or int(differ.sum()) > 1e-3 * o.shape[0]:
        raise AssertionError(f"{phase} differs from the brute force ({label})")
    return dict(brute_differ=int(differ.sum()), brute_differ_unexplained=int(reach.sum()),
                brute_tri_ties=bf_ties)


def phase_cascade(scene, rays_sets):
    """closest_hit_chunks through the kernels, over all ~218k triangles,
    against two oracles.

    1. The brute force in the kernels' own arithmetic (``check_brute``):
       the cascade skips only chunks whose AABB no ray of a 64-ray sub-tile
       reaches before its best hit.
    2. The dense sweep (``ops.intersect.closest_hit``, a float32 matrix
       product), with the criteria of tests/test_pallas_intersect.py:62-72:
       hit masks agree on > 99.5% of rays, triangles on > 99% of common
       hits, and t (rtol 1e-5, atol 1e-6) and beta (rtol 1e-4, atol 1e-5)
       on the common hits where both pick the same triangle.  The t
       tolerance adds the float32 forward-error bound of the two ways of
       summing p2 = o.w + w3, 8 * 2^-24 * sum|terms| / |q2|: from a
       surface-spawned origin the terms are ~1e3 while p2 is ~1e-3, so a
       hit a few 1e-4 away is only known to ~1e-4 in either form.  Rays
       where the forms pick different triangles (an edge falls on either
       side, or such a near-origin hit) are counted and reported.

    Returns {rays name: brute force (t, tri)} for the modes phase."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch.ops.intersect import closest_hit

    brutes = {}
    for name, (o, d) in rays_sets.items():
        got = ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min,
                                    scene.chunk_aabb_max, scene.woop_rows, EPS)
        brutes[name] = brute_force(scene, o, d)
        row = check_brute("cascade", name, scene, o, d, got, brutes[name])

        dense = closest_hit(o, d, scene.woop, EPS)
        hd, hp = dense.hit, got.hit
        agree = float((hd == hp).float().mean())
        both = hd & hp
        tri_eq = float((got.tri[both] == dense.tri[both]).float().mean())
        same = both & (got.tri == dense.tri)
        w = scene.woop_rows[dense.tri.long()][same]
        os_, ds_ = o[same], d[same]
        terms = (os_ * w[:, 8:11]).abs().sum(dim=1) + w[:, 11].abs()
        q2 = (ds_[:, 0] * w[:, 8] + ds_[:, 1] * w[:, 9]) + ds_[:, 2] * w[:, 10]
        t_tol = 1e-6 + 1e-5 * dense.t[same].abs() + 8 * 2.0**-24 * terms / q2.abs()
        t_rel = float(((got.t[same] - dense.t[same]).abs() / t_tol).max())
        b_rel = float(((got.beta[same] - dense.beta[same]).abs()
                       / (1e-5 + 1e-4 * dense.beta[same].abs())).max())
        emit("cascade", rays=name, hits=int(both.sum()), **row, dense_hit_agree=agree,
             dense_tri_agree=tri_eq, dense_other_tri=int((both & ~same).sum()),
             t_tol_ratio=t_rel, beta_tol_ratio=b_rel)
        if not (agree > 0.995 and tri_eq > 0.99 and t_rel <= 1.0 and b_rel <= 1.0):
            raise AssertionError(f"cascade disagrees with the dense sweep ({name})")
    return brutes


def compare_hits(phase, label, tk, ik, tp, ip, **fields):
    """A hit kernel's (t, tri) against its twin's: hit masks equal, t within
    1 ulp, triangles equal except where the two t are exactly equal (counted
    and printed: the kernels' designs should give none).  Returns the max
    abs error of t."""
    fin = torch.isfinite(tp)
    if not torch.equal(torch.isfinite(tk), fin):
        raise AssertionError(f"{phase} hit masks differ ({label})")
    ulp = (tk[fin].view(torch.int32) - tp[fin].view(torch.int32)).abs()
    err = float((tk[fin] - tp[fin]).abs().max()) if fin.any() else 0.0
    tri_diff = (ik != ip) & fin
    ties = int((tri_diff & (tk == tp)).sum())
    bad_tri = int(tri_diff.sum()) - ties
    emit(phase, rays=label, **fields, hits=int(fin.sum()),
         max_ulp=int(ulp.max()) if fin.any() else 0, max_abs_err=err, tri_mismatch=bad_tri,
         exact_t_ties=ties)
    if (fin.any() and int(ulp.max()) > 1) or bad_tri or not fin.any():
        raise AssertionError(f"{phase} kernel disagrees with its twin ({label})")
    return err


def dense_inputs(scene, o, d):
    """B5's inputs in mode "dense" on these rays: the packed rays, the
    NaN-padded chunk Woop blocks and the bit-packed initial activity (the
    super-block gate included)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    group = ci.GROUP
    cg = -(-scene.chunk_woop.shape[0] // group)
    cw = ci._nan_pad(scene.chunk_woop, cg * group).contiguous()
    cmin = ci._nan_pad(scene.chunk_aabb_min, cg * group).contiguous()
    cmax = ci._nan_pad(scene.chunk_aabb_max, cg * group).contiguous()
    rays = ci.pack_rays(o, d)
    cbits = ci.super_block_bits(rays, cmin, cmax, EPS, ci.RAY_TILE)
    m8, _, _ = ci.tile_chunk_activity(rays, cmin, cmax, None, cbits, EPS, ci.RAY_TILE, 8)
    r = rays.shape[0]
    return (rays, torch.full((r,), math.inf, device=DEV),
            torch.zeros((r,), dtype=torch.int32, device=DEV), cw, ci._bitpack(m8 != 0), EPS)


def phase_b5(scene, rays_sets):
    """B5 kernel vs its twin on the bit-packed initial activity of the
    atrium's primaries and secondaries ([128, 54] words), and bit-equal
    across two runs (its atomics take a minimum, whose result does not
    depend on their order).  Returns (max abs error, timing args)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    worst, timing = 0.0, None
    for name, (o, d) in rays_sets.items():
        args = dense_inputs(scene, o, d)
        tk, ik = kernels.dense(*args)
        tk2, ik2 = kernels.dense(*args)
        tp, ip = ci.run_dense_plain(*args)
        torch.cuda.synchronize()
        bits = args[4]
        worst = max(worst, compare_hits(
            "b5", name, tk, ik, tp, ip, bits_shape=list(bits.shape),
            active_pairs=int(sum(int((bits >> k & 1).sum()) for k in range(32))),
            deterministic=bool(torch.equal(tk, tk2) and torch.equal(ik, ik2))))
        if not (torch.equal(tk, tk2) and torch.equal(ik, ik2)):
            raise AssertionError(f"B5 is not deterministic ({name})")
        if name == "secondary":
            timing = args
    return worst, timing


def phase_b6(scene, rays_sets):
    """B6 kernel vs its twin on the near-pass-1 and residual worklists of
    phase b2, bit-equal across two runs, and equal to B2's output on the
    same worklists (t and triangle).  Returns (max abs error, timing args)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    worst, timing = 0.0, None
    for name, (o, d) in rays_sets.items():
        rays, cw, wls = worklists(scene, o, d)
        r = rays.shape[0]
        t0 = torch.full((r,), math.inf, device=DEV)
        i0 = torch.zeros((r,), dtype=torch.int32, device=DEV)
        for wl_name, (idx, counts, masks) in wls.items():
            args = (rays, t0, i0, cw, idx, counts, masks, EPS, ci.GROUP, 8)
            tk, ik = kernels.slots(*args)
            tk2, ik2 = kernels.slots(*args)
            tb, ib = b2_kernel(*args)
            tp, ip = ci.run_slots_plain(*args)
            torch.cuda.synchronize()
            same_b2 = bool(torch.equal(tk, tb) and torch.equal(ik, ib))
            det = bool(torch.equal(tk, tk2) and torch.equal(ik, ik2))
            turns = [sync_ms(lambda: b2_kernel(*args), 10),  # B2, B6, B6, B2
                     sync_ms(lambda: kernels.slots(*args), 10),
                     sync_ms(lambda: kernels.slots(*args), 10),
                     sync_ms(lambda: b2_kernel(*args), 10)]
            worst = max(worst, compare_hits(
                "b6", f"{name}/{wl_name}", tk, ik, tp, ip, items=int(counts.sum()),
                slots=idx.shape[1], equal_to_b2=same_b2, deterministic=det,
                b2_ms=[turns[0], turns[3]], b6_ms=[turns[1], turns[2]]))
            if not (same_b2 and det):
                raise AssertionError(f"B6 differs from B2 or from itself ({name}, {wl_name})")
            if name == "secondary" and wl_name == "residual":
                timing = args
    return worst, timing


def phase_b7(scene, rays_sets):
    """B7 kernel vs its twin: the per-ray group bits [256, 65,536] of the
    atrium's 2,048 padded chunks, exactly equal.  Returns (max abs
    difference, timing args)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    c = scene.chunk_aabb_min.shape[0]
    cpad = -(-c // ci.ACT_COLS) * ci.ACT_COLS
    cmin = ci._nan_pad(scene.chunk_aabb_min, cpad).contiguous()
    cmax = ci._nan_pad(scene.chunk_aabb_max, cpad).contiguous()
    worst, timing = 0, None
    for name, (o, d) in rays_sets.items():
        args = (ci.pack_rays(o, d), cmin, cmax, EPS, ci.GROUP)
        k = kernels.ray_groups(*args)
        p = ci.ray_group_bools_plain(*args)
        torch.cuda.synchronize()
        cg = -(-c // ci.GROUP)
        bad = int((k != p).sum())
        worst = max(worst, int((k - p).abs().max()))
        emit("b7", rays=name, shape=list(k.shape), pairs=int(p[:cg].sum()),
             pairs_per_ray=float(p[:cg].sum()) / p.shape[1], mismatch=bad,
             padding_set=int(k[cg:].sum()))
        if bad or int(k[cg:].sum()) or not int(p.sum()):
            raise AssertionError(f"B7 kernel disagrees with its twin ({name})")
        if name == "secondary":
            timing = args
    return worst, timing


def phase_modes(scene, rays_sets, brutes):
    """closest_hit_chunks on the atrium's rays under "twopass", "dense",
    "bins", and "items" with cheap_recheck 1 and 2: "twopass" must equal
    "items" bit for bit, the others are held to the brute force as the
    cascade is; each launch counter is read around its call.  Then the bins
    overflow is forced (bins_cap 1): B5 must launch, B2 must not, and the
    result must equal "dense".  Returns "items" vs "twopass" ms per call on
    the secondaries."""
    from tpu_pathtracer_torch.models.pathtracer import IntersectTuning
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    def run(o, d, **tuning):
        kernels.launches.clear()
        hit = ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min,
                                    scene.chunk_aabb_max, scene.woop_rows, EPS,
                                    tuning=IntersectTuning(**tuning))
        torch.cuda.synchronize()
        return hit, kernels.launches.copy()

    cases = {
        "twopass": (dict(mode="twopass"), ("b1", "b6")),
        "dense": (dict(mode="dense"), ("b1", "b5")),
        "bins": (dict(mode="bins"), ("b7", "b2")),
        "cheap1": (dict(cheap_recheck=1), ("b1", "b2")),
        "cheap2": (dict(cheap_recheck=2), ("b1", "b2")),
    }
    ms = {}
    for name, (o, d) in rays_sets.items():
        items, _ = run(o, d)
        gb = ci.ray_group_bools(ci.pack_rays(o, d), scene.chunk_aabb_min, scene.chunk_aabb_max,
                                EPS)[:-(-scene.chunk_woop.shape[0] // ci.GROUP)]
        rows = int(gb.sum())
        hits = {}
        for case, (tuning, needs) in cases.items():
            got, launches = run(o, d, **tuning)
            hits[case] = got
            row = check_brute("modes", f"{name}/{case}", scene, o, d, got, brutes[name])
            extra = {}
            if case == "twopass":
                extra["equal_to_items"] = bool(torch.equal(got.t, items.t)
                                               and torch.equal(got.tri, items.tri))
            if case == "bins":
                extra.update(bins_rows=rows, bins_row_cap=o.shape[0] * 12,
                             overflow=launches["b5"] > 0)
            emit("modes", rays=name, case=case, hits=int(got.hit.sum()), **row, **extra,
                 **{f"launches_{k}": v for k, v in launches.items()})
            if any(launches[k] == 0 for k in needs) or extra.get("equal_to_items") is False:
                raise AssertionError(f"modes {case} ({name}): {launches} {extra}")
            if case == "bins" and launches["b5"]:
                raise AssertionError(f"modes bins overflowed at the default cap ({name})")
        got, launches = run(o, d, mode="bins", bins_cap=1)
        same = bool(torch.equal(got.t, hits["dense"].t) and torch.equal(got.tri, hits["dense"].tri))
        emit("modes", rays=name, case="bins_overflow", bins_rows=rows, bins_row_cap=o.shape[0],
             equal_to_dense=same, **{f"launches_{k}": v for k, v in launches.items()})
        if not same or launches["b5"] == 0 or launches["b2"] != 0:
            raise AssertionError(f"forced bins overflow did not run B5 alone ({name}): {launches}")
        if name == "secondary":
            for mode in ("items", "twopass"):
                ms[mode] = sync_ms(lambda: ci.closest_hit_chunks(
                    o, d, scene.chunk_woop, scene.chunk_aabb_min, scene.chunk_aabb_max,
                    scene.woop_rows, EPS, tuning=IntersectTuning(mode=mode)), 5)
    emit("modes_timing", rays="secondary", items_ms=ms["items"], twopass_ms=ms["twopass"])
    return ms


def phase_golden(tmp, config=None, phase="golden", make="make_cornell_gltf",
                 golden="cornell_64x64_4096spp.ppm", size=(64, 64)):
    """A fixture (default Cornell, 64x64) at 64 spp through the port against
    the committed 4096-spp golden of the reference: rmse < 14, |mean
    difference| < 3 (u8)."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models.pathtracer import render
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
    from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm

    w, h = size
    p = getattr(fixtures, make)(os.path.join(tmp, make, "scene.gltf"))
    scene = parse_gltf_scene(p, w / h)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(w, h)).to(DEV)
    t0 = time.perf_counter()
    img = render(scene, spp=64, seed=0, config=config)
    secs = time.perf_counter() - t0
    ours = quantize_u8(torch.from_numpy(img)).numpy().astype(np.float64)
    ref = read_ppm(os.path.join(ROOT, "tests", "golden", golden)).astype(np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    dmean = float(abs(ours.mean() - ref.mean()))
    emit(phase, scene=f"{make} {w}x{h}@64spp", golden=golden, rmse=rmse, abs_mean_diff=dmean,
         seconds=round(secs, 3), **({} if config is None else dict(
             jitter=config.jitter, lowdisc=config.lowdisc)))
    if ours.shape != ref.shape or not (rmse < 14.0 and dmean < 3.0):
        raise AssertionError(f"golden {golden} failed")


def phase_render(phase, label, path, tmp, needs, config=None, gen_seconds=None, spp=None):
    """One 512x512 render at ``spp`` (default ``SPP``) with every launch
    counter set to 0 just before and read just after: through the CLI entry
    point (``cli.main``, default config) when ``config`` is None, else through
    ``cli.render_scene_file`` with ``config``.  Fails unless each kernel in
    ``needs`` launched, the HDR frame is finite and the PPM has the right
    shape.  Returns the printed fields, with the u8 image under "img"."""
    import numpy as np

    from tpu_pathtracer_torch import cli
    from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm, write_ppm

    spp = SPP if spp is None else spp
    captured = {}
    render = cli.render

    def tap(*a, **kw):  # keep the HDR frame for the finiteness check
        captured["hdr"] = render(*a, **kw)
        return captured["hdr"]

    out = os.path.join(tmp, phase + ".ppm")
    err = io.StringIO()
    cli.render = tap
    kernels.launches.clear()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            if config is None:
                rc = cli.main(["tpu_pathtracer_torch", path, str(W), str(H), str(spp), out])
                metrics = err.getvalue().strip().splitlines()[-1]
            else:
                rc = 0
                hdr, m = cli.render_scene_file(path, W, H, spp, config, device=torch.device(DEV))
                write_ppm(out, quantize_u8(torch.from_numpy(hdr)).numpy())
                metrics = m.to_json()
        total = time.perf_counter() - t0
    finally:
        cli.render = render
    launches = kernels.launches.copy()
    if rc != 0:
        raise AssertionError(f"CLI failed (rc {rc}): {err.getvalue()[-2000:]}")
    metrics = json.loads(metrics)
    hdr = captured["hdr"]
    img = read_ppm(out)
    load, rend = metrics["load_seconds"], metrics["render_seconds"]
    rays = metrics.get("measured_rays")  # absent under the scan engine, as in the JAX package
    row = dict(scene=label, seconds_scene_generation=gen_seconds,
               seconds_load=load, seconds_render=rend,
               seconds_write=round(total - load - rend, 4), seconds_total=round(total, 4),
               pixel_samples_per_s=W * H * spp / rend, measured_rays=rays,
               measured_mrays_per_s=None if rays is None else rays / rend / 1e6,
               **{f"launches_{k}": v for k, v in launches.items()}, ppm_shape=list(img.shape),
               hdr_finite=bool(np.isfinite(hdr).all()), u8_mean=float(img.mean()))
    emit(phase, **row)
    row["img"], row["hdr"] = img, hdr
    missing = [k for k in needs if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels {missing} never launched ({launches})")
    if img.shape != (H, W, 3) or not np.isfinite(hdr).all() or not img.mean() > 0:
        raise AssertionError(f"{phase}: render output is wrong")
    return row


def fp_noise(want, got):
    """tests/test_torch_render.py's rule for two renders with the same draws:
    at most 0.5% of u8 channels differ by more than 1 (an ulp can flip one
    Russian-roulette, alpha or strategy coin), image means within 0.1.
    Returns (share of channels off by more than 1, mean difference, ok)."""
    diff = abs(want.astype(int) - got.astype(int))
    share = float((diff > 1).mean())
    dmean = float(abs(want.astype(float).mean() - got.astype(float).mean()))
    return share, dmean, share <= 0.005 and dmean < 0.1


def phase_modes_render(path, tmp, main_row):
    """The atrium through ``cli.render_scene_file`` with the intersector mode
    set in ``RenderConfig.tuning``: "twopass" and "bins" at 512x512 @ 16 spp
    beside the main phase's "items" render, "dense" and cheap_recheck 1 and
    2 at 4 spp beside one "items" render at 4 spp.  Each must launch its
    kernels; "twopass" must give the main phase's u8 image exactly, the
    others agree with "items" at the same spp to fp noise.  Returns
    {case: printed fields}."""
    from tpu_pathtracer_torch.models.pathtracer import IntersectTuning, RenderConfig

    cases = [
        ("twopass", SPP, IntersectTuning(mode="twopass"), ("b1", "b6")),
        ("bins", SPP, IntersectTuning(mode="bins"), ("b7", "b2")),
        ("items", 4, IntersectTuning(), ("b1", "b2")),
        ("dense", 4, IntersectTuning(mode="dense"), ("b1", "b5")),
        ("cheap1", 4, IntersectTuning(cheap_recheck=1), ("b1", "b2")),
        ("cheap2", 4, IntersectTuning(cheap_recheck=2), ("b1", "b2")),
    ]
    rows = {}
    for case, spp, tuning, needs in cases:
        row = phase_render(f"modes_render_{case}", f"atrium 512x512@{spp}spp mode {case}", path,
                           tmp, needs, config=RenderConfig(tuning=tuning), spp=spp)
        rows[case] = row
        if case == "items":
            continue
        ref = main_row if spp == SPP else rows["items"]
        if case == "twopass":
            same = bool((row["img"] == ref["img"]).all())
            emit("modes_render", case=case, spp=spp, identical_to_items=same)
            if not same:
                raise AssertionError("the twopass image differs from the items image")
        else:
            share, dmean, ok = fp_noise(ref["img"], row["img"])
            emit("modes_render", case=case, spp=spp, u8_off_by_more_than_1=share,
                 abs_mean_diff=dmean)
            if not ok:
                raise AssertionError(f"the {case} image disagrees with items")
    return rows


def bits_identical(a, b):
    """Two float32 frames equal bit for bit (compared as uint32)."""
    import numpy as np

    a, b = (np.ascontiguousarray(x, dtype=np.float32) for x in (a, b))
    return a.shape == b.shape and bool(np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def profiled_busy_ms(fn):
    """(device busy ms, kernels seen) of ``fn()`` under ``torch.profiler``:
    the sum of its kernel and memory operation times (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.profile_render import _device_times

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = _device_times(prof)
    return sum(ms for ms, _ in dev.values()), len(dev)


def loops_in_turns(phase, label, render, order, unit):
    """``render(eager)`` -> (HDR frame, ``unit``s run) once per loop of
    ``order``, the launch and graph counters set to 0 just before and read
    just after.  Fails unless every frame is finite and bit-identical (as
    uint32) to the first eager frame, the graph ran (a capture or replays)
    and the eager loop captured and replayed nothing.  Returns {loop:
    [rows]}."""
    import numpy as np

    from tpu_pathtracer_torch.models.graph import CapturedBlock

    rows = {}
    for loop in order:
        kernels.launches.clear()
        r0, c0 = CapturedBlock.replays, CapturedBlock.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, units = render(loop == "eager")
        secs = time.perf_counter() - t0
        rows.setdefault(loop, []).append(dict(
            img=img, seconds=secs, units=units, launches=kernels.launches.copy(),
            replays=CapturedBlock.replays - r0, captures=CapturedBlock.captures - c0))
    want = rows["eager"][0]["img"]
    for loop, runs in rows.items():
        for row in runs:
            same = bits_identical(row["img"], want)
            ran = row["replays"] + row["captures"]
            emit(phase, scene=label, loop=loop, seconds_render=row["seconds"],
                 **{f"{unit}s": row["units"],
                    f"ms_per_{unit}": row["seconds"] * 1e3 / max(row["units"], 1)},
                 graph_replays=row["replays"], graph_captures=row["captures"],
                 identical_to_eager=same, hdr_finite=bool(np.isfinite(row["img"]).all()),
                 **{f"launches_{k}": v for k, v in row["launches"].items() if v})
            if not same or not np.isfinite(row["img"]).all() \
                    or (loop == "graph") != (ran > 0):
                raise AssertionError(f"{phase}: {label} {loop} differs from eager or ran "
                                     f"the wrong loop ({ran} graph runs)")
    return rows


def busy_share(phase, label, rows, unit, busy, replay):
    """Print each loop's device busy ms per ``unit`` (``busy[loop]`` = (busy
    ms, ``unit``s, kernels seen) of one profiled render) against the timed
    renders' ms per ``unit``: the share of the wall the device is busy;
    beside ``replay_cost``'s figures."""
    out = {}
    for loop, (ms, units, kernels) in busy.items():
        timed = sum(r["seconds"] for r in rows[loop]) * 1e3 / sum(r["units"] for r in rows[loop])
        per = ms / units if kernels else None  # no kernel seen: not measured
        out[loop] = {f"busy_ms_per_{unit}": per, f"timed_ms_per_{unit}": timed,
                     "busy_share": per / timed if per is not None else None,
                     "profiled_busy_ms": ms, f"profiled_{unit}s": units, "kernels_seen": kernels}
    emit(phase + "_summary", scene=label, **out, **replay, nvidia_smi=card_line())
    return out


def replay_cost(engine):
    """Host ms that ``graph.replay()`` of the newest cached ``engine`` body's
    graph takes to return (to launch it) and ms until the card has run it,
    over three replays one at a time (the replays rerun the last call's
    work on its buffers; no counter moves)."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    graph = next(e["block"].graph for k, e in reversed(pt._GRAPHS.items()) if k[4] == engine)
    launch, total = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    return {"replay_launch_host_ms": launch, "replay_total_ms": total}


def phase_engine(path, tmp):
    """The scan engine with Sobol jitter and bounce draws: the atrium at
    512x512 @ 4 spp through the CLI's ``render_scene_file`` (measured rays
    are not counted by the scan engine); then the same render eager, graph,
    graph, eager (frames bit-identical, ms per wavefront bounce) and the
    device's busy share of each loop under ``torch.profiler`` (one 256x256
    chunk at 1 spp), and the host's cost of launching the graph; then the
    Cornell golden with lowdisc="sobol" and with jitter="sobol".  Returns
    the scan frame."""
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.pathtracer import RenderConfig

    t_phase = time.perf_counter()
    config = RenderConfig(compaction=False, jitter="sobol", lowdisc="sobol")
    row = phase_render("engine", "atrium 512x512@4spp scan engine, Sobol", path, tmp,
                       ("b1", "b2", "rng", "k1", "k2"), config=config, spp=4)
    if row["measured_rays"] is not None:
        raise AssertionError("the scan engine reported measured rays")
    scene = load_scene(path)

    def scan(eager, spp=4, s=scene):
        pt.scan_accum.bounces = 0
        img = pt.render(s, spp=spp, seed=0, config=config, eager=eager)
        return img, pt.scan_accum.bounces

    label = "atrium 512x512@4spp scan engine, Sobol"
    pt.render(scene, spp=1, seed=1, config=config)  # captures the graph before the turns
    rows = loops_in_turns("engine_loops", label, scan, ("eager", "graph", "graph", "eager"),
                          "bounce")
    if not bits_identical(rows["graph"][0]["img"], row["hdr"]):
        raise AssertionError("engine: the CLI's scan frame differs from render's")
    # Profiled on one chunk (256x256 pixels, one 65,536-lane wavefront) at 1
    # spp: the profiler's cost grows with its events.
    crop = dataclasses.replace(scene, camera=scene.camera.with_dims(256, 256))
    scan(False, 1, crop)  # captures its graph outside the profile
    busy = {}
    for loop in ("eager", "graph"):
        box = {}
        ms, kernels = profiled_busy_ms(lambda: box.update(n=scan(loop == "eager", 1, crop)[1]))
        busy[loop] = (ms, box["n"], kernels)
    busy_share("engine_loops", label, rows, "bounce", busy, replay_cost("scan"))
    phase_golden(tmp, RenderConfig(lowdisc="sobol"), phase="engine_golden")
    phase_golden(tmp, RenderConfig(jitter="sobol"), phase="engine_golden")
    del scene
    pt.clear_compiled_loops()
    emit("engine_done", phase_seconds=time.perf_counter() - t_phase)
    return {"hdr": rows["graph"][0]["img"], "config": config, "spp": 4}


def phase_b4(scene, rays_sets):
    """B4 kernel vs its twin on the atrium's worklist-group boxes: ids
    exactly equal, entry distances equal, and no padding group returned.
    Returns (max abs error of the entry t, timing args)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    g_lo, g_hi = ci.group_boxes(scene.chunk_aabb_min, scene.chunk_aabb_max)
    g = g_lo.shape[0]
    gpad = -(-g // ci.ACT_COLS) * ci.ACT_COLS
    bmin = ci._nan_pad(g_lo, gpad).contiguous()
    bmax = ci._nan_pad(g_hi, gpad).contiguous()
    nan_box = torch.isnan(bmin[:, 0])
    worst, timing = 0.0, None
    for name, (o, d) in rays_sets.items():
        args = (ci.pack_rays(o, d), bmin, bmax, EPS)
        tk, ik = kernels.nearest(*args)
        tp, ip = ci.nearest_box_ids_plain(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(tp)
        err = float((tk[fin] - tp[fin]).abs().max()) if fin.any() else 0.0
        worst = max(worst, err)
        hit = ik >= 0
        bad_pad = int(nan_box[ik[hit].long()].sum()) + int((ik >= g).sum())
        emit("b4", rays=name, groups=g, padded_groups=gpad, entered=int(hit.sum()),
             id_mismatch=int((ik != ip).sum()), t_mismatch=int((tk[fin] != tp[fin]).sum()),
             finite_mismatch=int((torch.isfinite(tk) != fin).sum()), padding_returned=bad_pad,
             distinct_ids=int(torch.unique(ik).numel()), max_abs_err=err)
        if not torch.equal(ik, ip) or not torch.equal(torch.isfinite(tk), fin) or err or bad_pad:
            raise AssertionError(f"B4 kernel disagrees with its twin ({name})")
        if name == "secondary":
            timing = args
    return worst, timing


def light_worklists(scene, o, d):
    """The inputs B3 gets inside ``light_pdf_sum_chunks`` on these rays:
    the packed rays and each tile's worklist of pierced light clusters."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    lights = scene.lights
    rays = ci.pack_rays(o, d)
    m8, ent, _ = ci.tile_chunk_activity(rays, lights.cluster_min.contiguous(),
                                        lights.cluster_max.contiguous(), None, None, EPS,
                                        ci.RAY_TILE)
    ga, ge = ci._group_stats(m8 != 0, ent, 1)
    idx, counts, _ = ci._worklist(ga, ge, lights.cluster_woop.shape[0])
    return (rays, lights.cluster_woop.contiguous(), lights.cluster_k.contiguous(),
            idx.contiguous(), counts.contiguous(), EPS)


def phase_b3(scene, rays_sets):
    """B3 kernel vs its twin on the lit-banner atrium's real worklists: the
    zero / non-zero pattern equal (the Woop test rounds op for op alike),
    relative error <= 1e-5 on the non-zero sums (all terms are >= 0 and only
    the order of the sum differs), and the kernel bit-equal across two runs
    (no atomics).  Returns (max abs error, timing args)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    worst, timing = 0.0, None
    for name, (o, d) in rays_sets.items():
        args = light_worklists(scene, o, d)
        k1 = kernels.light_pdf(*args)
        k2 = kernels.light_pdf(*args)
        p = ci.run_light_pdf_plain(*args)
        torch.cuda.synchronize()
        nz = p != 0
        pattern = int(((k1 != 0) != nz).sum())
        rel = float(((k1[nz] - p[nz]).abs() / p[nz]).max()) if nz.any() else 0.0
        err = float((k1 - p).abs().max())
        worst = max(worst, err)
        counts = args[4]
        emit("b3", rays=name, clusters=args[1].shape[0], items=int(counts.sum()),
             max_tile_items=int(counts.max()), nonzero=int(nz.sum()),
             pattern_mismatch=pattern, max_rel_err=rel, max_abs_err=err,
             deterministic=bool(torch.equal(k1, k2)))
        if pattern or rel > 1e-5 or not torch.equal(k1, k2) or int(nz.sum()) == 0:
            raise AssertionError(f"B3 kernel disagrees with its twin ({name})")
        if name == "secondary":
            timing = args
    return worst, timing


# Lane operations a ray of K2 (csrc/shade_kernels.cu shade_gather_kernel),
# counted from the source: the two normals, the inside test, the flip and
# the barycentric weights ~65; the UV and its wrap ~20 when a slot is
# fetched; a slot's addresses and four-channel bilinear lerp ~70, and ~240
# more for a gamma slot's 12 powf (~20 operations each); the normal map ~75.
SHADE_OPS = {"base": 65, "uv": 20, "slot": 70, "gamma": 240, "normal": 75}
# K2's record: field -> its columns of the [R, 16] record (None: one column).
RECORD = (("normal", 0, 3), ("shading_normal", 3, 6), ("color", 6, 10),
          ("emission", 10, 13), ("metallic", 13, None), ("roughness", 14, None),
          ("ior", 15, None))


def ulps(a, b):
    """Elementwise distance of two float32 tensors in units in the last
    place (two NaNs: 0; a NaN against a number: 2^31)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    diff = (ordered(a) - ordered(b)).abs()
    return torch.where(nan_a & nan_b, 0, torch.where(nan_a ^ nan_b, 2**31, diff))


def flat_pdf_args(scene, o, d):
    lights = scene.lights
    return (o.contiguous(), d.contiguous(), lights.cluster_woop.contiguous(),
            lights.cluster_k.contiguous(), lights.count, EPS)


def phase_light_pdf_flat(label, scene, rays_sets):
    """K1 against its twin ``light_pdf_sum_flat`` on a scene's primaries and
    secondaries: the same zero pattern (the Woop test rounds op for op
    alike), relative error <= 1e-5 on the non-zero values (every term is
    >= 0; only the order of a cluster's sum differs), the kernel bit-equal
    across two runs.  Returns (max abs error, non-zero values)."""
    from tpu_pathtracer_torch.ops.intersect import light_pdf_sum_flat

    worst, nonzero = 0.0, 0
    for name, (o, d) in rays_sets.items():
        args = flat_pdf_args(scene, o, d)
        k1 = kernels.light_pdf_flat(*args)
        k2 = kernels.light_pdf_flat(*args)
        p = light_pdf_sum_flat(*args)
        torch.cuda.synchronize()
        nz = p != 0
        pattern = int(((k1 != 0) != nz).sum())
        rel = float(((k1[nz] - p[nz]).abs() / p[nz]).max()) if nz.any() else 0.0
        err = float((k1 - p).abs().max())
        worst, nonzero = max(worst, err), nonzero + int(nz.sum())
        cw = args[2]
        emit("light_pdf_flat", scene=label, rays=name, clusters=cw.shape[0],
             lights=args[4], live_lanes=int((~torch.isnan(cw).any(dim=1)).sum()),
             nonzero=int(nz.sum()), pattern_mismatch=pattern, max_rel_err=rel, max_abs_err=err,
             bit_equal_to_twin=int((k1 != p).sum()) == 0, deterministic=bool(torch.equal(k1, k2)))
        if pattern or rel > 1e-5 or not torch.equal(k1, k2) or not torch.isfinite(k1).all():
            raise AssertionError(f"K1 disagrees with its twin ({label}, {name})")
    return worst, nonzero


def fetched_slots(scene, config):
    from tpu_pathtracer_torch.models import pathtracer as pt

    return [k for k, used in enumerate(pt._fetched_slots(scene, config)) if used]


def shade_args(scene, config, d, hit):
    return (scene.shade_attrs, hit.tri.contiguous(), hit.beta.contiguous(),
            hit.gamma.contiguous(), d.contiguous(), scene.atlas,
            sum(1 << k for k in fetched_slots(scene, config)))


def phase_shade_gather(label, scene, config, rays_sets):
    """K2 against its twin ``hit_info_plain`` on the closest hits of a
    scene's primaries and secondaries (missed rays included, tri 0):
    ``inside`` exact and every float of the record within 2 ulp of the
    twin's (the goal is 0: the same operations in the same order).  Returns
    (max abs error, largest ulp difference)."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    worst, worst_ulp = 0.0, 0
    for name, (o, d) in rays_sets.items():
        hit = pt.scene_closest_hit(scene, o, d, EPS, config.tuning)
        args = shade_args(scene, config, d, hit)
        rec, inside = kernels.shade_gather(*args)
        want = pt.hit_info_plain(scene, d, hit, config)
        torch.cuda.synchronize()
        fields = {}
        for key, a, b in RECORD:
            got = rec[:, a:b] if b else rec[:, a]
            ref = want[key].reshape(got.shape)
            same_nan = torch.isnan(got) & torch.isnan(ref)
            bits = (got.contiguous().view(torch.int32) != ref.contiguous().view(torch.int32))
            fin = torch.isfinite(got) & torch.isfinite(ref)
            fields[key] = {"bit_mismatch": int((bits & ~same_nan).sum()),
                           "max_ulp": int(ulps(got, ref).max()),
                           "nan": int(torch.isnan(ref).sum())}
            if fin.any():
                worst = max(worst, float((got[fin] - ref[fin]).abs().max()))
        bad_inside = int((inside != want["inside"]).sum())
        max_ulp = max(f["max_ulp"] for f in fields.values())
        worst_ulp = max(worst_ulp, max_ulp)
        emit("shade_gather", scene=label, rays=name, slots=fetched_slots(scene, config),
             quad_pool=scene.atlas.quad is not None, textures=scene.atlas.offset.shape[0],
             hits=int(hit.hit.sum()), misses=int((~hit.hit).sum()), inside=int(inside.sum()),
             inside_mismatch=bad_inside, max_ulp=max_ulp, fields=fields)
        if bad_inside or max_ulp > 2:
            raise AssertionError(f"K2 disagrees with its twin ({label}, {name})")
    return worst, worst_ulp


def shade_work(scene, config, d, hit):
    """(lane operations, bytes) K2 needs on these rays: each input byte read
    once, so the rows and texels of this run's hits counted once each (a
    quad pool: one 64-byte row per (ray, slot) corner set), the record and
    inside written once."""
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.ops import texture

    slots = fetched_slots(scene, config)
    r = d.shape[0]
    per_ray = SHADE_OPS["base"] + (SHADE_OPS["uv"] if slots else 0)
    per_ray += sum(SHADE_OPS["slot"] + (SHADE_OPS["gamma"] if k < 2 else 0) for k in slots)
    per_ray += SHADE_OPS["normal"] if 3 in slots else 0
    n_bytes = nbytes(hit.tri, hit.beta, hit.gamma, d) + r * (16 * 4 + 1)
    n_bytes += int(torch.unique(hit.tri).numel()) * 48 * 4
    if slots:
        atlas = scene.atlas
        row = scene.shade_attrs[hit.tri.long()]
        ids = row[:, 43:47].to(torch.int32)[:, slots]
        uv = pt._interp_flat(row, 18, 2, hit.beta, hit.gamma)
        off, w, _, px, py, px1, py1, _, _ = texture._corners(atlas, ids, uv)
        if atlas.quad is not None:
            n_bytes += int(torch.unique(off + px + py * w).numel()) * 64
        else:
            idx = torch.cat([off + px + py * w, off + px + py1 * w, off + px1 + py * w,
                             off + px1 + py1 * w])
            n_bytes += int(torch.unique(idx).numel()) * 16
        n_bytes += int(torch.unique(ids).numel()) * 12
    return r * per_ray, n_bytes


def phase_shading(tmp, scene, rays_sets, field, env):
    """Kernels K1 (the flat light-cluster pdf) and K2 (``hit_info``'s row
    gather and texture fetch) against their twins on real rays: K1 on the
    atrium's and the env field's (camera light triangle) primaries and
    secondaries; K2 on those, on the textured Cornell box, and on the
    maximal asset (every texture slot used) with the corner-quad pool (the
    loader's default, as in every other scene here) and with the flat
    texel pool.  Then each timed on the atrium's secondaries beside
    its twin, and K1 beside the other route to the same sum: B3 with a full
    worklist (every tile, every cluster).  Returns (errs, ulp, times, work,
    b3 route ms)."""
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch.ops.intersect import light_pdf_sum_flat
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.utils.fuzz import make_maximal_gltf

    config = RenderConfig()
    k1_err, nonzero = phase_light_pdf_flat("atrium", scene, rays_sets)
    if nonzero == 0:
        raise AssertionError("K1: no atrium ray reaches a light")
    k2_err, ulp = phase_shade_gather("atrium", scene, config, rays_sets)
    # The other scenes' rays sample the whole frame (every 4th pixel).
    stride = W * H // N_RAYS
    env_config = RenderConfig(use_env_map=True, env_map_path=env, add_light_triangle=True)
    fscene = load_scene(field, env_config)
    frays = bounce_rays(fscene, env_config, stride)
    errs = {"k1": max(k1_err, phase_light_pdf_flat("env field", fscene, frays)[0])}
    e, u = phase_shade_gather("env field", fscene, env_config, frays)
    k2_err, ulp = max(k2_err, e), max(ulp, u)
    del fscene, frays
    corn = load_scene(fixtures.make_textured_cornell_gltf(os.path.join(tmp, "tcornell", "c.gltf")))
    e, u = phase_shade_gather("textured Cornell", corn, config, bounce_rays(corn, config, stride))
    k2_err, ulp = max(k2_err, e), max(ulp, u)
    maximal = load_scene(make_maximal_gltf(os.path.join(tmp, "maximal", "m.gltf")))
    if fetched_slots(maximal, config) != [0, 1, 2, 3]:
        raise AssertionError(f"the maximal asset must use every texture slot: {maximal.tex_slots}")
    if maximal.atlas.quad is None:
        raise AssertionError("the maximal asset's atlas must have its quad pool")
    mrays = bounce_rays(maximal, config, stride)
    for pool in ("quad", "flat"):
        m = maximal if pool == "quad" else dataclasses.replace(
            maximal, atlas=dataclasses.replace(maximal.atlas, quad=None))
        e, u = phase_shade_gather(f"maximal asset ({pool} pool)", m, config, mrays)
        k2_err, ulp = max(k2_err, e), max(ulp, u)
    errs["k2"] = k2_err
    del corn, maximal, mrays, m

    o, d = rays_sets["secondary"]
    args = flat_pdf_args(scene, o, d)
    hit = pt.scene_closest_hit(scene, o, d, EPS, config.tuning)
    sargs = shade_args(scene, config, d, hit)
    times = {"k1": (queued_ms(lambda: kernels.light_pdf_flat(*args), 50),
                    sync_ms(lambda: light_pdf_sum_flat(*args), 10)),
             "k2": (queued_ms(lambda: kernels.shade_gather(*sargs), 50),
                    sync_ms(lambda: pt.hit_info_plain(scene, d, hit, config), 10))}
    # B3 with every tile's worklist holding every cluster, divided as K1 divides.
    cw, ck = args[2], args[3]
    t_tiles = N_RAYS // ci.RAY_TILE
    idx = torch.arange(cw.shape[0], dtype=torch.int32, device=DEV).repeat(t_tiles, 1).contiguous()
    counts = torch.full((t_tiles,), cw.shape[0], dtype=torch.int32, device=DEV)
    b3_args = (ci.pack_rays(o, d), cw, ck, idx, counts, EPS)
    b3_ms = queued_ms(lambda: kernels.light_pdf(*b3_args), 50)
    k1 = kernels.light_pdf_flat(*args)
    b3 = kernels.light_pdf(*b3_args) / float(max(args[4], 1))
    nz = k1 != 0
    live = int((~torch.isnan(cw).any(dim=1)).sum())
    work = {"k1": (N_RAYS * live * PDF_OPS, nbytes(o, d, cw, ck) + 4 * N_RAYS),
            "k2": shade_work(scene, config, d, hit)}
    emit("shading_timing", rays="atrium secondary", k1_ms=times["k1"][0],
         k1_plain_ms=times["k1"][1], k1_b3_route_ms=b3_ms,
         b3_route_pattern_mismatch=int(((b3 != 0) != nz).sum()),
         b3_route_max_rel_err=float(((b3[nz] - k1[nz]).abs() / k1[nz]).max()) if nz.any() else 0.0,
         k2_ms=times["k2"][0], k2_plain_ms=times["k2"][1], k2_slots=fetched_slots(scene, config),
         k2_max_ulp=ulp, nvidia_smi=card_line())
    return errs, ulp, times, work, b3_ms


def bits_differ(a, b):
    """[R] lanes of ``a`` and ``b`` (R first) where some element's bits
    differ (two NaNs agree)."""
    if a.dtype.is_floating_point:
        same = a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)
        same = same | (torch.isnan(a) & torch.isnan(b))
    else:
        same = a == b
    return ~same.reshape(a.shape[0], -1).all(dim=1)


# K3's and K4's outputs, in order.
CHAIN_OUTPUTS = ("pos", "new_dir", "radiance", "flags", "o", "d", "throughput", "moved", "hint")


def chain_case(scene, config, o, d, seed):
    """K3 and K4 on rays (o, d): lanes parked at 1e30 dead, a throughput and
    a radiance drawn from ``seed``, the bounce draws at depth 1, the closest
    hits and their record (K2).  Returns the twins' arguments after scene
    and config ("sample_in", "finish_in", K4's from K3's twin outputs and
    the light pdf of those), the kernels' ("a3", "a4"), the twins' outputs
    ("t3", "t4") and "p_light"."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    n = o.shape[0]
    g = torch.Generator(device=DEV).manual_seed(seed)
    pids = torch.arange(n, dtype=torch.int32, device=DEV)
    hit = pt.scene_closest_hit(scene, o, d, EPS, config.tuning)
    sample_in = (o.contiguous(), d.contiguous(), 0.1 + torch.rand((n, 3), generator=g, device=DEV),
                 torch.rand((n, 3), generator=g, device=DEV), o[:, 0].abs() < 1e29,
                 pt.bounce_draws(seed, 0, 1, pids, config), hit, pt.hit_info(scene, d, hit, config))
    t3 = pt.shade_sample_plain(scene, config, *sample_in)
    p_light = pt.light_pdf(scene, t3[0], t3[1], EPS)
    finish_in = sample_in[:3] + sample_in[6:] + (t3[0], t3[1], t3[3], p_light)
    return dict(sample_in=sample_in, finish_in=finish_in, t3=t3, p_light=p_light,
                t4=pt.shade_finish_plain(scene, config, *finish_in),
                a3=pt.shade_sample_args(scene, config, *sample_in),
                a4=pt.shade_finish_args(scene, config, *finish_in))


def check_chain(label, scene, config, rays_sets, seed):
    """K3 and K4 against their twins on a scene's primaries and secondaries:
    every output bit for bit.  Emits the lanes that differ per output and,
    where some do, the first ones' inputs and outputs.  Returns the number
    of lanes that differ."""

    bad = 0
    for name, (o, d) in rays_sets.items():
        c = chain_case(scene, config, o, d, seed)
        got = kernels.shade_sample(*c["a3"]) + kernels.shade_finish(*c["a4"])
        outs = dict(zip(CHAIN_OUTPUTS, zip(got, c["t3"] + c["t4"])))
        differ = {k: bits_differ(a, b) for k, (a, b) in outs.items()}
        o_in, d_in, thr, rad, alive, draws, hit, info = c["sample_in"]
        flags = c["t3"][3]
        emit("shade_chain", scene=label, rays=name, lanes=o.shape[0],
             alive=int(alive.sum()), misses=int((alive & ~hit.hit).sum()),
             shade=int(flags[:, 0].sum()), passthrough=int(flags[:, 1].sum()),
             moved=int(c["t4"][3].sum()), p_light=c["p_light"] is not None,
             lanes_differing={k: int(v.sum()) for k, v in differ.items()},
             max_ulp={k: int(ulps(a, b).max()) for k, (a, b) in outs.items()
                      if a.dtype.is_floating_point})
        lanes = torch.stack(list(differ.values())).any(dim=0)
        for i in torch.nonzero(lanes).flatten()[:4].tolist():
            emit("shade_chain_diff", scene=label, rays=name, lane=i,
                 inputs=dict(o=o_in[i].tolist(), d=d_in[i].tolist(), throughput=thr[i].tolist(),
                             radiance=rad[i].tolist(), alive=bool(alive[i]),
                             draws=draws[:, i].tolist(), record=info["record"][i].tolist(),
                             t=float(hit.t[i]), hit=bool(hit.hit[i]),
                             p_light=None if c["p_light"] is None else float(c["p_light"][i])),
                 kernel={k: a[i].tolist() for k, (a, _) in outs.items()},
                 twin={k: b[i].tolist() for k, (_, b) in outs.items()})
        bad += int(lanes.sum())
    return bad


def chain_bytes(c):
    """Bytes K3 and K4 must move on a ``chain_case``: each per-ray input
    read once and each output written once; K4 reads a ray's record only
    where the ray shades.  The light rows and texels read are left out (a
    few KB)."""
    o, d, thr, rad, alive, draws, hit, _ = c["sample_in"]
    pos, new_dir, _, flags = c["t3"]
    r = o.shape[0]
    k3 = nbytes(o, d, thr, rad, alive, draws, hit.t, hit.hit) + r * 16 * 4 + r * (3 * 3 * 4 + 2)
    shade = int(flags[:, 0].sum())
    k4 = nbytes(o, d, thr, hit.tri, pos, new_dir, flags, c["p_light"]) + shade * 16 * 4
    return k3, k4 + r * (3 * 3 * 4 + 1 + 4)


def shade_nodes(smap):
    """Nodes an iteration of the captured block in the ``shade`` class of
    the stage map (``shading`` outside its ``intersector``, ``hit_info``
    and ``light_pdf`` stages), and the node ids."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    ids = []
    for path, first, last in smap.rows:
        parts = path.split("/")
        if "shading" in parts and not {"intersector", "hit_info", "light_pdf"} & set(parts):
            ids += list(range(first, last + 1))
    return len(ids) / pt.LOOP_ITERATIONS, ids


def twin_chain():
    """A context in which ``bounce_step`` runs the twins of K3 and K4 on
    the card (no launch)."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    def sample(*a):
        return pt.shade_sample_plain(*a)

    def finish(*a):
        return pt.shade_finish_plain(*a)

    return mock.patch.multiple(pt, shade_sample=sample, shade_finish=finish)


def chain_frame(scene, variant):
    """(frame, stage map, names of the shade nodes of the first replay) of a
    512x512 @ 1 spp atrium render under ``variant``: "kernels" (graph),
    "eager" (kernels, the eager loop) or "twins" (graph, the twin chain)."""
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.utils import profiling

    pt.clear_compiled_loops()
    with twin_chain() if variant == "twins" else contextlib.nullcontext():
        pt.render(scene, spp=1, seed=5, eager=variant == "eager")  # capture
        torch.cuda.synchronize()
        if variant == "eager":
            return pt.render(scene, spp=1, seed=3, eager=True), None, None
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            img = pt.render(scene, spp=1, seed=3)
    smap = profiling.stage_maps()[-1]
    evs = list(prof.profiler.kineto_results.events())
    first = next(ev.correlation_id() for ev in evs if ev.name() == "cudaGraphLaunch")
    ops = sorted((ev for ev in evs if ev.correlation_id() == first
                  and str(ev.device_type()).endswith("CUDA")), key=lambda ev: ev.start_ns())
    _, ids = shade_nodes(smap)
    names = [ops[i].name() for i in ids] if len(ops) == smap.nodes else None
    return img, smap, names


def phase_shade_chain(tmp, scene, rays_sets, field, env):
    """K3 (``shade_sample``) and K4 (``shade_finish``) against their twins
    bit for bit on the atrium's and the env field's rays (phase shading's
    ray sets), each timed on the secondaries beside its twin and against
    its bytes' bound; then the shade class of the atrium's captured block
    and its frame with the kernels (graph and eager) and with the twin
    chain.  Returns {k3, k4: (ms, twin ms, bytes)} of the atrium."""
    import numpy as np

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt

    config = RenderConfig()
    stride = W * H // N_RAYS
    env_config = RenderConfig(use_env_map=True, env_map_path=env, add_light_triangle=True)
    fscene = load_scene(field, env_config)
    frays = bounce_rays(fscene, env_config, stride)
    bad = check_chain("atrium", scene, config, rays_sets, 11)
    bad += check_chain("env field", fscene, env_config, frays, 12)
    timing = {}
    for label, sc, cfg, rays in (("atrium", scene, config, rays_sets),
                                 ("env field", fscene, env_config, frays)):
        c = chain_case(sc, cfg, *rays["secondary"], 13)
        row = {}
        for k, launch, twin, n_bytes in (
                ("k3", lambda: kernels.shade_sample(*c["a3"]),
                 lambda: pt.shade_sample_plain(sc, cfg, *c["sample_in"]), chain_bytes(c)[0]),
                ("k4", lambda: kernels.shade_finish(*c["a4"]),
                 lambda: pt.shade_finish_plain(sc, cfg, *c["finish_in"]), chain_bytes(c)[1])):
            ms, plain_ms = queued_ms(launch, 50), sync_ms(twin, 10)
            bound_ms, bound_by = bound({"fp32": (0, 128)}, n_bytes)
            row[k] = dict(ms=ms, plain_ms=plain_ms, bytes=n_bytes, bound_ms=bound_ms,
                          bound_by=bound_by, share=bound_ms / ms)
        emit("shade_chain_timing", scene=label, rays="secondary", **row, nvidia_smi=card_line())
        if label == "atrium":
            timing = {k: (v["ms"], v["plain_ms"], v["bytes"]) for k, v in row.items()}
    del fscene, frays

    frames, names = {}, {}
    for variant in ("kernels", "eager", "twins"):
        kernels.launches.clear()
        img, smap, nm = chain_frame(scene, variant)
        frames[variant] = img
        launches = kernels.launches.copy()
        if smap is not None:
            per_iter, _ = shade_nodes(smap)
            names[variant] = nm
            emit("shade_chain_map", variant=variant, graph_nodes=smap.nodes,
                 shade_nodes_per_iteration=per_iter,
                 shade_names_first_iteration=None if nm is None
                 else nm[:len(nm) // pt.LOOP_ITERATIONS],
                 k3=launches["k3"], k4=launches["k4"])
    equal = {f"{a}_vs_{b}": bool(np.array_equal(frames[a].view(np.uint32),
                                                frames[b].view(np.uint32)))
             for a, b in (("kernels", "eager"), ("kernels", "twins"))}
    emit("shade_chain_frames", **equal, finite=bool(np.isfinite(frames["kernels"]).all()))
    pt.clear_compiled_loops()
    kernel_names = names.get("kernels") or []
    others = [nm for nm in kernel_names if "shade_sample_kernel" not in nm
              and "shade_finish_kernel" not in nm]
    if bad or not all(equal.values()):
        raise AssertionError(f"K3/K4 differ from their twins on {bad} lanes, frames {equal}")
    if (sum("shade_sample_kernel" in nm for nm in kernel_names) != pt.LOOP_ITERATIONS
            or sum("shade_finish_kernel" in nm for nm in kernel_names) != pt.LOOP_ITERATIONS
            or len(others) > 3 * pt.LOOP_ITERATIONS):
        raise AssertionError(f"the captured shade class is not K3 + K4: {kernel_names}")
    return timing


def phase_goldens_env_lt(tmp):
    """Cornell 64x64 @ 64 spp with the environment map (PNG, Radiance HDR)
    and with the camera light triangle, against the reference's 4096-spp
    goldens: rmse < 14, |mean difference| < 3 (u8)."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models.pathtracer import RenderConfig, render
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
    from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm

    d = os.path.join(tmp, "goldens")
    p = fixtures.make_cornell_gltf(os.path.join(d, "cornell.gltf"))
    cases = {
        "cornell_env": RenderConfig(use_env_map=True, env_map_path=fixtures.make_env_image(
            os.path.join(d, "env.png"))),
        "cornell_envhdr": RenderConfig(use_env_map=True, env_map_path=fixtures.make_env_hdr(
            os.path.join(d, "env.hdr"))),
        "cornell_lt": RenderConfig(add_light_triangle=True),
    }
    for name, config in cases.items():
        scene = parse_gltf_scene(p, 1.0, config)
        scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64)).to(DEV)
        t0 = time.perf_counter()
        img = render(scene, spp=64, seed=0, config=config)
        secs = time.perf_counter() - t0
        ours = quantize_u8(torch.from_numpy(img)).numpy().astype(np.float64)
        ref = read_ppm(os.path.join(ROOT, "tests", "golden", f"{name}_64x64_4096spp.ppm"))
        ref = ref.astype(np.float64)
        rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
        dmean = float(abs(ours.mean() - ref.mean()))
        emit("goldens_env_lt", golden=name, rmse=rmse, abs_mean_diff=dmean,
             seconds=round(secs, 3))
        if not (rmse < 14.0 and dmean < 3.0):
            raise AssertionError(f"{name} golden failed")


def phase_sort_keys(path, hint):
    """The atrium at 512x512 @ 16 spp through ``render`` under the "target",
    "cell" and "dirhint" sort keys (each counter set to 0 just before and
    read just after); "target" must launch B4.  Printed beside the "hint"
    run of the main phase."""
    import numpy as np

    from tpu_pathtracer_torch.models.pathtracer import RenderConfig, render

    scene = load_scene(path)
    emit("sort_keys", sort_key="hint", **{k: v for k, v in hint.items() if k in (
        "seconds_render", "measured_rays", "pixel_samples_per_s", "measured_mrays_per_s")},
        **{k: v for k, v in hint.items() if k.startswith("launches_")})
    out = {}
    for key in ("target", "cell", "dirhint"):
        stats = {}
        kernels.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene, spp=SPP, seed=0, config=RenderConfig(sort_key=key), stats=stats)
        secs = time.perf_counter() - t0
        launches = kernels.launches.copy()
        emit("sort_keys", sort_key=key, seconds_render=secs, measured_rays=stats["measured_rays"],
             pixel_samples_per_s=W * H * SPP / secs,
             measured_mrays_per_s=stats["measured_rays"] / secs / 1e6,
             **{f"launches_{k}": v for k, v in launches.items()},
             hdr_finite=bool(np.isfinite(img).all()), mean=float(img.mean()))
        needs = ("b1", "b2", "b4") if key == "target" else ("b1", "b2")
        if any(launches[k] == 0 for k in needs) or not np.isfinite(img).all():
            raise AssertionError(f"sort key {key}: {launches}, finite {np.isfinite(img).all()}")
        out[key] = launches
    return out


# Homebrew scenes: every primitive kind (moved and rotated), every material
# kind; the Whitted scene lit by both light kinds at RAY_DEPTH 8, the
# Monte-Carlo scene by an emissive triangle.
_HB_CAMERA = """
CAMERA_POSITION 0 1.2 4.5
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.1
"""
_HB_PRIMS = """
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.6 0.8 0.6
NEW_PRIMITIVE
ELLIPSOID 0.6 0.9 0.6
POSITION -1 0.9 0
ROTATION 0 0.3826834 0 0.9238795
COLOR 1 0.6 0.6
DIELECTRIC
IOR 1.5
NEW_PRIMITIVE
BOX 0.4 0.4 0.4
POSITION 1 0.4 -0.5
ROTATION 0.2 0.3 0.1 0.9273618
COLOR 0.9 0.9 0.3
METALLIC
NEW_PRIMITIVE
ELLIPSOID 0.35 0.35 0.35
POSITION 0.3 0.35 1
COLOR 0.5 0.5 0.9
NEW_PRIMITIVE
TRIANGLE -2.5 0 -2 2.5 0 -2 0 3 -2
"""
HOMEBREW = {
    "whitted": "DIMENSIONS 640 480\nRAY_DEPTH 8\nBG_COLOR 0.1 0.2 0.4\nAMBIENT_LIGHT 0.1 0.1 0.1\n"
    "NEW_LIGHT\nLIGHT_POSITION 1 4 2\nLIGHT_INTENSITY 6 6 6\nLIGHT_ATTENUATION 1 0.1 0.05\n"
    "NEW_LIGHT\nLIGHT_DIRECTION 0.3 1 0.2\nLIGHT_INTENSITY 0.5 0.5 0.4\n"
    + _HB_CAMERA + _HB_PRIMS + "COLOR 0.3 0.3 1\n",
    "mc": "DIMENSIONS 640 480\nRAY_DEPTH 6\nSAMPLES 64\nBG_COLOR 0.3 0.3 0.35\n"
    + _HB_CAMERA + _HB_PRIMS + "COLOR 0 0 0\nEMISSION 4 3 2\n",
}


def write_homebrew(tmp):
    paths = {}
    for name, text in HOMEBREW.items():
        paths[name] = os.path.join(tmp, f"homebrew_{name}.txt")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


# The Whitted graph's stack iterations per host read tried in turns.
WHITTED_K_TURNS = (4, 8, 16, 16, 8, 4)


def phase_homebrew(tmp):
    """Each homebrew scene rendered by the port on the card and on the CPU
    at 64x48 (the Monte-Carlo scene at 8 spp) must agree to the render
    tests' u8 rule (``fp_noise``: the card's elementwise kernels may round
    a product in another order, which can flip a Russian-roulette coin);
    then each at 640x480 (the Monte-Carlo scene at 64 spp), after a graphed
    warm-up, eager, graph, graph, eager (Monte-Carlo: graph, eager, graph):
    the frames bit-identical, ms per Whitted stack iteration or Monte-Carlo
    bounce, each loop's device busy share under ``torch.profiler`` (one
    256x256 chunk, the Monte-Carlo scene at 1 spp) and the host's cost of
    launching each graph; the Whitted graph's iterations per host read K also at 4,
    8, 16, 16, 8, 4 in turns, each frame bit-identical; beside the card's name
    and power limit."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import legacy
    from tpu_pathtracer_torch.models.legacy import render_homebrew
    from tpu_pathtracer_torch.models.pathtracer import clear_compiled_loops
    from tpu_pathtracer_torch.scene.homebrew import parse_homebrew_scene
    from tpu_pathtracer_torch.utils.image import quantize_u8

    u8 = lambda hdr: quantize_u8(torch.from_numpy(hdr)).numpy()
    t_phase = time.perf_counter()
    out = {}
    for name, path in write_homebrew(tmp).items():
        scene = parse_homebrew_scene(path)
        small = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 48),
                                    samples=8 if scene.monte_carlo else None)
        t0 = time.perf_counter()
        cpu = render_homebrew(small, seed=0)
        cpu_s = time.perf_counter() - t0
        card = render_homebrew(small.to(DEV), seed=0)
        share, dmean, ok = fp_noise(u8(cpu), u8(card))
        full = scene.to(DEV)
        w, h = scene.camera.width, scene.camera.height
        mc = scene.monte_carlo
        unit = "bounce" if mc else "iteration"
        chunks = -(-w * h // min(RenderConfig().rays_per_batch, w * h))

        def run(eager, s=full):
            legacy.render_homebrew.iterations = 0
            img = render_homebrew(s, seed=0, eager=eager)
            # Monte-Carlo: every bounce of every sample runs in both loops.
            n = legacy.render_homebrew.iterations
            return img, n * s.ray_depth if mc else n

        render_homebrew(full, seed=1)  # warm-up: captures the graph
        label = f"homebrew {name} {w}x{h}@{scene.samples or 1}spp"
        # One eager Monte-Carlo render: it takes ~14 s, the graph ~2.6 s.
        order = ("graph", "eager", "graph") if mc else ("eager", "graph", "graph", "eager")
        rows = loops_in_turns("homebrew_loops", label, run, order, unit)
        replay = replay_cost("mc" if mc else "whitted")
        img = rows["graph"][0]["img"]
        if not mc:
            # Whitted: ms per useful iteration (the eager loop's count) at each K.
            useful = rows["eager"][0]["units"]
            default_k, per_k = legacy.WHITTED_ITERATIONS, {}
            try:
                for k in WHITTED_K_TURNS:
                    legacy.WHITTED_ITERATIONS = k
                    run(False)  # captures this K's graph
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got, ran = run(False)
                    secs = time.perf_counter() - t0
                    per_k.setdefault(k, []).append(secs * 1e3 / useful)
                    emit("homebrew_k", scene=label, k=k, seconds_render=secs, iterations=ran,
                         useful_iterations=useful, ms_per_useful_iteration=secs * 1e3 / useful,
                         identical_to_eager=bits_identical(got, img))
                    if not bits_identical(got, img):
                        raise AssertionError(f"Whitted with K={k} differs from eager")
            finally:
                legacy.WHITTED_ITERATIONS = default_k
                clear_compiled_loops()
            emit("homebrew_k_summary", scene=label, k=default_k,
                 best_k=min(per_k, key=lambda k: sum(per_k[k]) / len(per_k[k])),
                 k_ms_per_useful_iteration={str(k): v for k, v in per_k.items()},
                 nvidia_smi=card_line())
        # Profiled on one chunk (256x256 pixels, one 65,536-lane wavefront),
        # the Monte-Carlo scene at 1 spp: the profiler's cost grows with its
        # events.
        prof_scene = dataclasses.replace(full, camera=full.camera.with_dims(256, 256),
                                         samples=1 if mc else None)
        run(False, prof_scene)  # captures the profiled graph outside the profile
        busy = {}
        for loop in ("eager", "graph"):
            box = {}
            ms, kernels = profiled_busy_ms(
                lambda: box.update(n=run(loop == "eager", prof_scene)[1]))
            busy[loop] = (ms, box["n"], kernels)
        summary = busy_share("homebrew_loops", label, rows, unit, busy, replay)
        secs = rows["graph"][1]["seconds"]
        emit("homebrew", scene=name, monte_carlo=mc, ray_depth=scene.ray_depth,
             primitives=int(scene.valid.sum()), check="64x48 card vs cpu",
             hdr_max_abs_diff=float(np.abs(cpu - card).max()), u8_off_by_more_than_1=share,
             abs_mean_diff=dmean, cpu_seconds=round(cpu_s, 3),
             timed=f"{w}x{h}@{scene.samples or 1}spp", chunks=chunks, seconds_render=secs,
             seconds_render_eager=rows["eager"][-1]["seconds"],
             pixel_samples_per_s=w * h * (scene.samples or 1) / secs,
             hdr_finite=bool(np.isfinite(img).all()), u8_mean=float(u8(img).mean()),
             nvidia_smi=card_line())
        if not ok or not np.isfinite(card).all() or img.shape != (h, w, 3):
            raise AssertionError(f"homebrew {name}: the card disagrees with the CPU")
        out[name] = {"rows": rows, "busy": summary}
        clear_compiled_loops()
    emit("homebrew_done", phase_seconds=time.perf_counter() - t_phase)
    return out


def phase_cli_txt(tmp):
    """``python -m tpu_pathtracer_torch scene.txt 160 120 1 out.ppm`` on the
    card, in its own process: exit 0, a 160x120 P6, and both the
    ``phases_seconds`` line and the metrics line on stderr."""
    from tpu_pathtracer_torch.utils.image import read_ppm

    out = os.path.join(tmp, "cli_txt.ppm")
    env = {k: v for k, v in os.environ.items() if k != "TPU_PATHTRACER_TORCH_DEVICE"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    rows = {}
    for name, path in write_homebrew(tmp).items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_pathtracer_torch", path, "160", "120", "1", out],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        lines = proc.stderr.strip().splitlines()
        phases = json.loads(lines[-2]).get("phases_seconds") if len(lines) >= 2 else None
        metrics = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
        shape = list(read_ppm(out).shape) if proc.returncode == 0 else None
        rows[name] = dict(rc=proc.returncode, process_seconds=round(secs, 3),
                          phases_seconds=phases, metrics=metrics, ppm_shape=shape)
        emit("cli_txt", scene=name, **rows[name])
        if proc.returncode != 0 or phases is None or "render_seconds" not in metrics \
                or shape != [120, 160, 3]:
            raise AssertionError(f"cli_txt {name}: {proc.stderr[-2000:]}")
    return rows


BENCH_ENV = {"BENCH_SIZE": "256", "BENCH_SPP": "4", "BENCH_REPS": "3"}


def phase_bench():
    """``tpu_pathtracer_torch.bench``'s ``main`` in this process at 256x256 @
    4 spp with 3 repeats (atrium and field in turns): exit 0 (its gate:
    every timed frame bit-identical to the first, measured rays equal),
    ``bench.py``'s keys and the card's, the graph loop, and the device
    fields measured."""
    from tpu_pathtracer_torch import bench
    from tpu_pathtracer_torch.models.pathtracer import clear_compiled_loops

    clear_compiled_loops()  # the earlier phases' graphs: the bench measures its own memory
    torch.cuda.empty_cache()
    out = io.StringIO()
    with mock.patch.dict(os.environ, BENCH_ENV), contextlib.redirect_stdout(out):
        code = bench.main()
    lines = out.getvalue().strip().splitlines()
    for text in lines[:-1]:  # the profiled render's top device operations
        print(text, flush=True)
    line = json.loads(lines[-1]) if lines else {}
    emit("bench", rc=code, **line)
    keys = {"metric", "value", "unit", "vs_baseline", "pixel_samples_per_s",
            "mrays_depth8_upper_bound", "measured_rays", "timing", "rep_times_s",
            "field_open_scene_samples_per_s", "card", "reps", "render_s_median",
            "render_s_spread", "iterations", "loop", "device_busy_ms_per_iteration",
            "device_busy_share", "peak_allocated_bytes", "reserved_bytes"}
    if code != 0 or set(line) != keys or line["loop"] != "graph" \
            or line["timing"] != "median_of_3_alternating" \
            or any(line[k] is None for k in keys):
        raise AssertionError(f"bench: rc {code}, line {line}")
    clear_compiled_loops()
    torch.cuda.empty_cache()


def phase_renderer(path):
    """A ``Renderer`` on the atrium, two ``look_at`` frames at 512x512 @ 16
    spp, each with the launch counters set to 0 just before and read just
    after: B1 and B2 launch in both, the frames differ, the scene's tensors
    keep their device addresses, and no kernel library is built again.
    The second frame is timed."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.renderer import Renderer

    builds = []
    real_build = kernels.build
    kernels.build = lambda *a, **k: builds.append(1) or real_build(*a, **k)
    try:
        r = Renderer(path, aspect_ratio=W / H, device=torch.device(DEV))
        tensors = lambda s: {f.name: getattr(s, f.name).data_ptr() for f in dataclasses.fields(s)
                             if isinstance(getattr(s, f.name), torch.Tensor)}
        ptrs = tensors(r.scene)
        cam = r.camera
        eye = cam.position.cpu().numpy()
        fwd = cam.forward.cpu().numpy()
        frames, launches, secs = [], [], []
        for shift in (0.0, 0.6):
            r.look_at(eye=eye + np.array([shift, 0.0, 0.0]), target=eye + 10 * fwd)
            kernels.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames.append(r.render(W, H, SPP, seed=0))
            secs.append(time.perf_counter() - t0)
            launches.append(kernels.launches.copy())
        same = tensors(r.scene) == ptrs
    finally:
        kernels.build = real_build
    diff = float(np.abs(frames[0] - frames[1]).mean())
    emit("renderer", scene="atrium 512x512@16spp, two look_at frames", seconds_render=secs,
         second_frame_seconds=secs[1], pixel_samples_per_s=W * H * SPP / secs[1],
         launches=launches, scene_tensors_kept=same, kernel_builds=len(builds),
         frames_mean_abs_diff=diff, hdr_finite=bool(all(np.isfinite(f).all() for f in frames)))
    if not same or builds or diff == 0 or any(l["b1"] == 0 or l["b2"] == 0 for l in launches) \
            or not all(np.isfinite(f).all() for f in frames):
        raise AssertionError("renderer: a camera move re-uploaded, rebuilt or rendered wrong")
    return launches


def load_scene(path, config=None):
    """A glTF scene (the atrium unless another is named) on the card, with
    the camera at W x H, loaded under ``config`` (default RenderConfig)."""
    from tpu_pathtracer_torch.config import DEFAULT_CONFIG
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    scene = parse_gltf_scene(path, W / H, config or DEFAULT_CONFIG)
    return dataclasses.replace(scene, camera=scene.camera.with_dims(W, H)).to(DEV)


def against_main(main_row, hdr):
    """(u8 channels off by more than 1, u8 mean difference, fp noise ok,
    HDR max |difference|) of a frame against the main phase's."""
    from tpu_pathtracer_torch.utils.image import quantize_u8

    share, dmean, ok = fp_noise(main_row["img"], quantize_u8(torch.from_numpy(hdr)).numpy())
    return share, dmean, ok, float(abs(hdr - main_row["hdr"]).max())


def phase_checkpoint(path, tmp, main_row):
    """The atrium at 512x512 through ``render_with_checkpoints``: 8 spp in
    passes of 4 (the launch counters set to 0 just before and read just
    after), then resumed to 16, against an uninterrupted checkpointed 16-spp
    render: bit-equal, within fp noise of the main render, B1 and B2
    launched, and the file has the JAX package's six keys."""
    import numpy as np

    from tpu_pathtracer_torch.parallel.checkpoint import render_with_checkpoints

    scene = load_scene(path)
    half, whole = os.path.join(tmp, "ck", "resumed.npz"), os.path.join(tmp, "ck", "whole.npz")
    every = SPP // 4
    secs = {}
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_with_checkpoints(scene, SPP // 2, 0, checkpoint_path=half, checkpoint_every=every)
    secs["first_half"] = time.perf_counter() - t0
    launches = kernels.launches.copy()
    with np.load(half) as z:
        keys, done = sorted(z.files), int(z["samples_done"])
    t0 = time.perf_counter()
    resumed = render_with_checkpoints(scene, SPP, 0, checkpoint_path=half, checkpoint_every=every)
    secs["resume"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    uninterrupted = render_with_checkpoints(scene, SPP, 0, checkpoint_path=whole,
                                            checkpoint_every=every)
    secs["uninterrupted"] = time.perf_counter() - t0
    same = bool(np.array_equal(resumed, uninterrupted))
    share, dmean, ok, hdr_diff = against_main(main_row, resumed)
    emit("checkpoint", scene=f"atrium {W}x{H}, {SPP // 2} then {SPP} spp in passes of {every}",
         seconds=secs, npz_keys=keys, samples_done_after_first_half=done,
         **{f"launches_{k}": v for k, v in launches.items()},
         resumed_equals_uninterrupted=same, hdr_max_abs_diff_vs_main=hdr_diff,
         u8_off_by_more_than_1=share, abs_mean_diff=dmean)
    six = sorted(["accum", "samples_done", "width", "height", "seed", "fingerprint"])
    if not same or not ok or keys != six or done != SPP // 2 \
            or launches["b1"] == 0 or launches["b2"] == 0:
        raise AssertionError("checkpoint: the resumed render is wrong")


HEADLINE_SIZE = 1000
# The JAX package's headline frame at seed 0 (its scripts/run_headline.py),
# and an earlier run of the same script: their difference is the noise
# between two runs of one package.
HEADLINE_REF = os.path.join(ROOT, "out", "samples", "atrium_1000x1000_1000spp_r5.ppm")
HEADLINE_EARLIER = os.path.join(ROOT, "out", "samples", "atrium_1000x1000_1000spp.ppm")


def headline_main(env):
    """``run_headline.main()`` in this process, the atrium at 1000x1000 with
    ``env`` added to the environment, the launch counters set to 0 just
    before and read just after.  Returns its exit code, ledger line,
    progress lines, seconds, launches, CUDA graphs captured, the compiled
    loops cached, and the device memory after each saved pass (allocated,
    reserved, peak allocated since the start)."""
    from tpu_pathtracer_torch import run_headline
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock

    real = run_headline.render_with_checkpoints
    memory = []

    def render(*args, progress, **kw):
        def watch(done, total):
            memory.append((done, torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
                           torch.cuda.max_memory_allocated()))
            progress(done, total)
        return real(*args, progress=watch, **kw)

    pt.clear_compiled_loops()  # earlier phases' graphs: the run measures its own memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    captures = CapturedBlock.captures
    out = io.StringIO()
    env = {"HEADLINE_SIZE": str(HEADLINE_SIZE), **{k: str(v) for k, v in env.items()}}
    with mock.patch.dict(os.environ, env), mock.patch.object(run_headline,
                                                             "render_with_checkpoints", render):
        kernels.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = run_headline.main()
        secs = time.perf_counter() - t0
        launches = kernels.launches.copy()
    lines = out.getvalue().strip().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    row = dict(rc=code, ckpt=env["HEADLINE_CKPT"], progress=rows[:-1],
               line=rows[-1] if code == 0 and rows else None,
               seconds=secs, launches=launches, graph_captures=CapturedBlock.captures - captures,
               cached_loops=len(pt._GRAPHS), memory=memory)
    pt.clear_compiled_loops()
    torch.cuda.empty_cache()
    return row


def headline_checks(label, row, spp, every, resumed_from=0):
    """The in-process run's checks: exit 0, one progress line a saved pass,
    the ledger line's keys and card and offsets, B1, B2 and the threefry
    kernel launched, one or two captured graphs (the full chunks' and the
    tail's, at most), device memory flat after the
    first pass; the frame read back at 1000x1000 and the checkpoint's
    accumulator finite.  Returns the frame (u8) and the emitted fields."""
    import numpy as np

    from tpu_pathtracer_torch.parallel.checkpoint import RenderState
    from tpu_pathtracer_torch.utils.image import read_ppm

    line = row["line"] or {}
    keys = {"workload", "wall_s_this_run", "spp_rendered_this_run", "samples_per_s",
            "resumed_from_spp", "out", "card"}
    img = read_ppm(line["out"]) if row["rc"] == 0 else None
    accum = RenderState.load(row["ckpt"]).accum if row["rc"] == 0 else None
    passes = [p["spp_done"] for p in row["progress"]]
    _, alloc0, reserved0, _ = row["memory"][0] if row["memory"] else (0, 0, 0, 0)
    flat = all(a == alloc0 and r == reserved0 for _, a, r, _ in row["memory"])
    fields = dict(
        rc=row["rc"], seconds=row["seconds"], ledger=line, passes=passes,
        **{f"launches_{k}": v for k, v in row["launches"].items()},
        graph_captures=row["graph_captures"], cached_loops=row["cached_loops"],
        peak_allocated_bytes=max((m[3] for m in row["memory"]), default=None),
        reserved_bytes=row["memory"][-1][2] if row["memory"] else None,
        allocated_after_each_pass=sorted({m[1] for m in row["memory"]}),
        reserved_after_each_pass=sorted({m[2] for m in row["memory"]}), memory_flat=flat,
        frame_shape=None if img is None else list(img.shape),
        accum_finite=None if accum is None else bool(np.isfinite(accum).all()),
        nvidia_smi=card_line())
    want_passes = list(range(resumed_from + every, spp, every)) + [spp]
    if row["rc"] != 0 or set(line) != keys or line["card"] != card_line() \
            or (line["resumed_from_spp"], line["spp_rendered_this_run"]) != (
                resumed_from, spp - resumed_from) \
            or passes != want_passes or not flat or not 1 <= row["graph_captures"] <= 2 \
            or any(row["launches"][k] == 0 for k in ("b1", "b2", "rng", "k1", "k2")) \
            or img.shape != (HEADLINE_SIZE, HEADLINE_SIZE, 3) or not fields["accum_finite"]:
        emit(label, **fields)
        raise AssertionError(f"{label}: the headline run is wrong")
    return img, fields


def phase_headline(tmp):
    """``run_headline``, the atrium at 1000x1000: ``main()`` in this process
    at 16 spp in checkpoints of 8 (``headline_checks``), then
    ``python -m tpu_pathtracer_torch.run_headline`` supervised
    (``HEADLINE_SUPERVISE=1``) at 24 spp on the same checkpoint in a
    process of its own, which must exit 0 having resumed at 16 and
    rendered 8, with no restart."""
    from tpu_pathtracer_torch.utils.image import read_ppm

    d = os.path.join(tmp, "headline")
    env = dict(HEADLINE_SPP=16, HEADLINE_CKPT_EVERY=8, HEADLINE_CKPT=os.path.join(d, "ck.npz"),
               HEADLINE_OUT=os.path.join(d, "16.ppm"),
               HEADLINE_LEDGER=os.path.join(d, "ledger.jsonl"))
    row = headline_main(env)
    _, fields = headline_checks("headline", row, 16, 8)
    env.update(HEADLINE_SIZE=HEADLINE_SIZE, HEADLINE_SUPERVISE=1, HEADLINE_SPP=24,
               HEADLINE_OUT=os.path.join(d, "24.ppm"))
    sub_env = dict(os.environ, **{k: str(v) for k, v in env.items()})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.run_headline"], cwd=ROOT,
                          env=sub_env, capture_output=True, text=True, timeout=900)
    sub_secs = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    sub = json.loads(out[-1]) if proc.returncode == 0 and out else {}
    events = [ln for ln in out if '"supervisor"' in ln]
    shape = list(read_ppm(sub["out"]).shape) if sub else None
    emit("headline", scene=f"atrium {HEADLINE_SIZE}x{HEADLINE_SIZE}, 16 spp in checkpoints of "
         "8 in this process, then resumed to 24 supervised in a subprocess", **fields,
         pixel_samples_per_s=fields["ledger"]["samples_per_s"], supervised_rc=proc.returncode,
         supervised_seconds=sub_secs, supervised_ledger=sub, supervisor_events=events,
         supervised_frame_shape=shape)
    if proc.returncode != 0 or sub.get("resumed_from_spp") != 16 \
            or sub.get("spp_rendered_this_run") != 8 or events \
            or shape != [HEADLINE_SIZE, HEADLINE_SIZE, 3]:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", flush=True)
        raise AssertionError("headline: the supervised resume is wrong")


def frame_diff(a, b):
    """u8 frames ``a`` against ``b``: share of values off by more than 1 and
    by anything, RMSE, largest difference, each frame's channel means and
    their largest difference."""
    import numpy as np

    a, b = a.astype(np.int64), b.astype(np.int64)
    d = np.abs(a - b)
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    return dict(off_by_more_than_1=float((d > 1).mean()), any_difference=float((d > 0).mean()),
                rmse=float(np.sqrt(((a - b) ** 2).mean())), max_abs=int(d.max()),
                channel_means=ma.tolist(), ref_channel_means=mb.tolist(),
                channel_mean_max_diff=float(np.abs(ma - mb).max()))


def phase_headline_full(tmp):
    """The JAX script's default workload through ``run_headline.main()``:
    the atrium at 1000x1000 @ 1000 spp in checkpoints of 50
    (``headline_checks``), its frame held against the JAX package's
    committed seed-0 frame: at most 0.5% of u8 values off by more than 1
    (the fp-noise rule of tests/test_torch_render.py) and every channel
    mean within 0.1, printed beside the two JAX runs' own difference.  The
    frame and ledger are kept in the git-ignored ``build/headline_full/``."""
    from tpu_pathtracer_torch.utils.image import read_ppm

    keep = os.path.join(ROOT, "build", "headline_full")
    env = dict(HEADLINE_SPP=1000, HEADLINE_CKPT_EVERY=50,
               HEADLINE_CKPT=os.path.join(tmp, "headline_full", "ck.npz"),
               HEADLINE_OUT=os.path.join(keep, "atrium_1000x1000_1000spp.ppm"),
               HEADLINE_LEDGER=os.path.join(keep, "ledger.jsonl"))
    row = headline_main(env)
    img, fields = headline_checks("headline_full", row, 1000, 50)
    ref = read_ppm(HEADLINE_REF)
    vs_ref = frame_diff(img, ref)
    jax_runs = frame_diff(read_ppm(HEADLINE_EARLIER), ref)
    emit("headline_full", scene=f"atrium {HEADLINE_SIZE}x{HEADLINE_SIZE} @ 1000 spp in "
         "checkpoints of 50", **fields, pixel_samples_per_s=fields["ledger"]["samples_per_s"],
         pass_seconds=[p["elapsed_s"] for p in row["progress"]],
         vs_jax_frame=vs_ref, jax_runs_yardstick=jax_runs,
         reference=os.path.relpath(HEADLINE_REF, ROOT))
    if vs_ref["off_by_more_than_1"] > 0.005 or vs_ref["channel_mean_max_diff"] > 0.1:
        raise AssertionError("headline_full: the frame is not within fp noise of the JAX frame")


def phase_accumulate():
    """The persistent engine's accumulation at the render's shape (65,536
    lanes into 65,536 pixel rows, each idle lane into a drop row of its
    own), with 10% and all of the lanes finishing a sample at random pixels:
    device ms of ``add_rows`` beside ``index_add_`` (turns add, index_add,
    index_add, add), and how many of 10 repeats differ from the first.
    ``add_rows`` must repeat exactly; ``index_add_`` adds repeated rows by
    float atomics."""
    from tpu_pathtracer_torch.models.pathtracer import add_rows

    n = N_RAYS
    g = torch.Generator().manual_seed(0)
    lane = torch.arange(n, device=DEV)
    for share in (0.1, 1.0):
        done = (torch.rand(n, generator=g) < share).to(DEV)
        slot = torch.randint(0, n, (n,), generator=g).to(DEV)
        rows = torch.where(done, slot, n + lane)
        values = torch.where(done[:, None], torch.rand((n, 3), generator=g).to(DEV) * 100, 0.0)
        acc = torch.zeros((2 * n, 3), device=DEV)

        def put():
            return add_rows(acc.zero_(), rows, values)

        def add():
            return acc.zero_().index_add_(0, rows, values)

        ms = [sync_ms(put, 50), sync_ms(add, 50), sync_ms(add, 50), sync_ms(put, 50)]
        differ = {}
        for name, fn in (("add_rows", put), ("index_add", add)):
            first = fn().clone()
            differ[name] = sum(not torch.equal(fn(), first) for _ in range(10))
        emit("accumulate", lanes=n, finishing_share=share, add_rows_ms=[ms[0], ms[3]],
             index_add_ms=[ms[1], ms[2]], add_rows_repeats_differing_of_10=differ["add_rows"],
             index_add_repeats_differing_of_10=differ["index_add"])
        if differ["add_rows"]:
            raise AssertionError("add_rows does not repeat exactly on the card")


def phase_sharded(path, tmp, main_row, engine_row):
    """A world-size-1 NCCL process group (no fallback: a failed init fails
    the phase), then the atrium at 512x512 @ 16 spp through
    ``render_sharded`` on a 1x1 mesh (launch counters set to 0 just before
    and read just after): the very engine calls of the main render, so its
    HDR frame and measured rays must equal the main render's exactly;
    through ``render_multihost`` with a checkpoint every 8 samples (fp
    noise); and through ``render_sharded`` with the scan engine
    (``compaction=False``, phase engine's config and spp), whose frame must
    equal phase engine's single-device scan frame bit for bit."""
    import numpy as np
    import torch.distributed as dist

    from tpu_pathtracer_torch.parallel.mesh import TIMEOUT, make_mesh, render_sharded
    from tpu_pathtracer_torch.parallel.multihost import render_multihost

    scene = load_scene(path)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "nccl_store"),
                            world_size=1, rank=0, timeout=TIMEOUT)
    try:
        backend = dist.get_backend()
        mesh = make_mesh()
        stats = {}
        kernels.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = render_sharded(scene, SPP, 0, mesh=mesh, stats=stats)
        t_sharded = time.perf_counter() - t0
        launches = kernels.launches.copy()
        t0 = time.perf_counter()
        multi = render_multihost(scene, SPP, 0, checkpoint_path=os.path.join(tmp, "ck", "mh.npz"),
                                 checkpoint_every=SPP // 2)
        t_multi = time.perf_counter() - t0
        kernels.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan = render_sharded(scene, engine_row["spp"], 0, config=engine_row["config"], mesh=mesh)
        t_scan = time.perf_counter() - t0
        scan_launches = kernels.launches.copy()
    finally:
        dist.destroy_process_group()
    scan_same = bits_identical(scan, engine_row["hdr"])
    emit("sharded", entry="render_sharded scan engine", backend=backend, world_size=1,
         mesh=mesh.shape, spp=engine_row["spp"], seconds_render=t_scan,
         identical_to_single_device_scan=scan_same,
         **{f"launches_{k}": v for k, v in scan_launches.items()})
    if not scan_same or scan_launches["b1"] == 0 or scan_launches["b2"] == 0:
        raise AssertionError("sharded: the scan engine's frame differs from the single-device "
                             f"scan frame ({scan_launches})")
    identical = bool(np.array_equal(sharded, main_row["hdr"]))
    rows = {}
    for name, hdr in (("render_sharded", sharded), ("render_multihost", multi)):
        share, dmean, ok, hdr_diff = against_main(main_row, hdr)
        rows[name] = ok
        emit("sharded", entry=name, backend=backend, world_size=1, mesh=mesh.shape,
             seconds_render=t_sharded if name == "render_sharded" else t_multi,
             hdr_max_abs_diff_vs_main=hdr_diff, u8_off_by_more_than_1=share, abs_mean_diff=dmean,
             **({"identical_to_main": identical, "measured_rays": stats["measured_rays"],
                 "main_measured_rays": main_row["measured_rays"],
                 **{f"launches_{k}": v for k, v in launches.items()}}
                if name == "render_sharded" else {"checkpoint_every": SPP // 2}))
    if backend != "nccl" or not all(rows.values()) or not identical \
            or stats["measured_rays"] != main_row["measured_rays"] \
            or launches["b1"] == 0 or launches["b2"] == 0:
        raise AssertionError(f"sharded: {rows}, rays {stats['measured_rays']} vs "
                             f"{main_row['measured_rays']}, {launches}")


RNG_LANES = (N_RAYS, 4 * N_RAYS, 16 * N_RAYS)  # the bounce and jitter forms' timing shapes
RNG_RAGGED = (1, N_RAYS + 1)


def rng_forms(n, seed=0):
    """The threefry kernel's inputs on ``n`` lanes, made from ``seed``, in
    the forms the port launches: {form: (positional args, sample base, pixel
    base)}.  "bounce": 10 draws of per-lane sample, depth and pool slot with
    the render's traced seed, first sample and first pixel as device
    scalars past 2^32 (how ``_PersistentLoop.iteration`` passes them);
    "jitter": the camera jitter's 2 draws at JITTER_DEPTH, the same way;
    "key_words": folded key words, scalar sample and depth, 8 draws (the
    generic instance); "homebrew": ``per_pixel_uniforms``' 4 draws."""
    from tpu_pathtracer_torch.ops import rng

    g = torch.Generator().manual_seed(seed)
    pixel = torch.randint(0, W * H, (n,), generator=g, dtype=torch.int32).to(DEV)
    sample = torch.randint(0, SPP, (n,), generator=g, dtype=torch.int32).to(DEV)
    depth = torch.randint(0, 8, (n,), generator=g, dtype=torch.int32).to(DEV)
    seed_t, sample0, pixel0 = (torch.tensor(v, dtype=torch.int64, device=DEV)
                               for v in (2**32 + 12345, 2**32 + 3 * SPP, 2**33 + 7))
    return {
        "bounce": ((0, seed_t, sample, depth, pixel, 10), sample0, pixel0),
        "jitter": ((0, seed_t, sample, rng.JITTER_DEPTH, pixel, 2), sample0, pixel0),
        "key_words": ((*rng.fold_in(*rng.key_words(7), 3), 0, 0, pixel, 8), 0, 0),
        "homebrew": ((*rng.fold_in(*rng.key_words(7), 5), 0, 0, pixel, 4), 0, 0),
    }


def fit_line(xs, ys):
    """(intercept, slope) of the least-squares line through (xs, ys)."""
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return my - slope * mx, slope


def rng_lane_ops(n_draws):
    """{pipe: operations} a lane of the threefry kernel for ``n_draws`` with
    per-lane sample, depth and pixel, its adds placed to balance the ALU
    and FMA pipes: a stage-key block and a block per two draws, two parity
    words, a shift-or and a subtract a draw, three sums of the stream."""
    blocks = 1 + (n_draws + 1) // 2
    alu = RNG_BLOCK_ALU * blocks + 2 + n_draws
    fma = n_draws
    adds = RNG_BLOCK_ADDS * blocks + 3
    to_alu = min(adds, max(0, (fma + adds - alu + 1) // 2))
    return {"alu": alu + to_alu, "fma": fma + adds - to_alu}


def rng_work(n, n_draws=10):
    """({pipe: (operations, lanes an SM takes a clock)}, bytes) of the
    bounce draws on ``n`` lanes: three int32 inputs read, the draws
    written."""
    ops = {pipe: (n * v, INT_PIPE_LANES) for pipe, v in rng_lane_ops(n_draws).items()}
    return ops, 4 * n * n_draws + 3 * 4 * n


def phase_rng():
    """The threefry kernel against its plain twin, bit for bit, in the four
    forms of ``rng_forms`` at 65,536 lanes and at the ragged 1 and 65,537,
    and the bounce and jitter forms at 262,144 and 1,048,576 lanes.  The
    bounce and jitter forms are timed at each lane count beside an empty
    launch (a one-element fill), and a line through the three times splits
    a launch's fixed cost (the intercept) from its cost a lane (the slope).
    Returns {form: (ms, plain ms, max abs error)} at 65,536 lanes and
    {form: (intercept ms, slope ms a lane)}."""
    from tpu_pathtracer_torch.ops import rng

    out, times = {}, {}
    for n in RNG_RAGGED + RNG_LANES:
        for name, (args, sb, pb) in rng_forms(n).items():
            if n > N_RAYS and name not in ("bounce", "jitter"):
                continue
            k = kernels.uniforms(*args, sb, pb)
            k2 = kernels.uniforms(*args, sb, pb)
            p = rng.lane_uniforms_key_plain(*args, sb, pb)
            torch.cuda.synchronize()
            equal = bool(torch.equal(k.view(torch.int32), p.view(torch.int32)))
            det = bool(torch.equal(k, k2))
            row = {"form": name, "lanes": n, "draws": args[5], "bit_equal_to_twin": equal,
                   "deterministic": det, "max_abs_err": float((k - p).abs().max())}
            if not (equal and det):
                emit("rng", **row)
                raise AssertionError(f"the threefry kernel differs from its twin ({name}, {n})")
            if n in RNG_LANES:
                row["ms"] = queued_ms(lambda: kernels.uniforms(*args, sb, pb), 50)
                times.setdefault(name, []).append(row["ms"])
            if n == N_RAYS:
                row["plain_ms"] = sync_ms(lambda: rng.lane_uniforms_key_plain(*args, sb, pb), 10)
                out[name] = (row["ms"], row["plain_ms"], row["max_abs_err"])
            emit("rng", **row)
    one = torch.zeros(1, device=DEV)
    fits = {name: fit_line(RNG_LANES, ms) for name, ms in times.items() if len(ms) > 1}
    emit("rng_fit", lanes=RNG_LANES, empty_ms=queued_ms(one.zero_, 50),
         **{f"{name}_ms": times[name] for name in fits},
         **{f"{name}_intercept_ms": a for name, (a, _) in fits.items()},
         **{f"{name}_ns_per_1k_lanes": b * 1e9 for name, (_, b) in fits.items()})
    return out, fits


def render_loop(scene, spp, config, loop, seed=0):
    """One ``render`` with the persistent engine's ``loop``, the launch
    counters, the iteration counter and the graph counters set to 0 just
    before and read just after."""
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock

    kernels.launches.clear()
    pt.persistent_accum.iterations = 0
    r0, c0 = CapturedBlock.replays, CapturedBlock.captures
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pt.render(scene, spp=spp, seed=seed, config=config, stats=stats, eager=loop == "eager")
    secs = time.perf_counter() - t0
    return dict(img=img, rays=stats.get("measured_rays"), loop=stats.get("loop"), seconds=secs,
                iterations=pt.persistent_accum.iterations, launches=kernels.launches.copy(),
                replays=CapturedBlock.replays - r0, captures=CapturedBlock.captures - c0)


def device_busy_ms(scene, spp, config, loop):
    """(device busy ms, iterations run, wall seconds, kernels seen) of one
    render under ``torch.profiler``: the sum of its kernel and memory
    operation times (one stream)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.profile_render import _device_times

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        row = render_loop(scene, spp, config, loop)
    dev = _device_times(prof)
    return sum(ms for ms, _ in dev.values()), row["iterations"], row["seconds"], len(dev)


def check_loops(label, scene, spp, config, needs, order=("eager", "graph")):
    """``render`` of ``scene`` with each loop of ``order`` (repeats allowed):
    every graph frame identical to the eager one, measured rays equal, the
    kernels in ``needs`` launched by both loops, the graph replayed.
    Returns {loop: [rows]}."""
    import numpy as np

    rows = {}
    for loop in order:
        rows.setdefault(loop, []).append(render_loop(scene, spp, config, loop))
    eager = rows["eager"][0]
    for loop, runs in rows.items():
        for row in runs:
            same = bool(np.array_equal(row["img"], eager["img"]))
            emit("graph", scene=label, spp=spp, loop=loop, taken=row["loop"],
                 seconds_render=row["seconds"], iterations=row["iterations"],
                 ms_per_iteration=row["seconds"] * 1e3 / max(row["iterations"], 1),
                 graph_replays=row["replays"], graph_captures=row["captures"],
                 measured_rays=row["rays"], identical_to_eager=same,
                 rays_equal_to_eager=row["rays"] == eager["rays"],
                 **{f"launches_{k}": v for k, v in row["launches"].items()},
                 hdr_finite=bool(np.isfinite(row["img"]).all()))
            missing = [k for k in needs if row["launches"][k] == 0]
            if not same or row["rays"] != eager["rays"] or missing or row["loop"] != loop \
                    or (loop == "graph" and row["replays"] + row["captures"] == 0) \
                    or not np.isfinite(row["img"]).all():
                raise AssertionError(f"graph: {label} {loop} differs from eager or did not "
                                     f"launch {missing}")
    return rows


# The graph's iterations per host read tried in turns.
K_TURNS = (4, 8, 16, 32, 32, 16, 8, 4)


def phase_graph(path, lit_path, field, env):
    """The persistent engine's loop as one CUDA graph against the eager loop.

    1. The atrium at 512x512 @ 16 spp: eager, graph, graph, eager; frames
       identical, measured rays equal, B1 / B2 / threefry launched, the
       graph replayed (the first graph render captures it).
    2. K, the iterations per replay, at 4, 8, 16, 32, 32, 16, 8, 4 (a 1-spp
       render first captures each K's graph): ms per useful iteration (the
       eager loop's count) and the tail waste (iterations run past it); the
       fastest K is printed.
    3. The device's busy ms per iteration of each loop at 4 spp under
       ``torch.profiler`` against the timed renders' ms per iteration.
    4. Eager against graph at 4 spp: "twopass" (B6), the lit-banner atrium
       (B3), the env field.
    5. Two ``Renderer`` frames at 4 spp through the cached graph (one
       capture for both), each identical to its eager frame."""
    import numpy as np

    from tpu_pathtracer_torch.config import IntersectTuning, RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock
    from tpu_pathtracer_torch.renderer import Renderer

    config = RenderConfig()
    scene = load_scene(path)
    rows = check_loops("atrium", scene, SPP, config, ("b1", "b2", "rng", "k1", "k2"),
                       order=("eager", "graph", "graph", "eager"))
    useful = rows["eager"][0]["iterations"]
    eager_ms = [r["seconds"] * 1e3 / useful for r in rows["eager"]]
    graph_ms = [r["seconds"] * 1e3 / useful for r in rows["graph"]]

    default_k = pt.LOOP_ITERATIONS
    per_k = {}
    try:
        for k in K_TURNS:
            pt.LOOP_ITERATIONS = k
            render_loop(scene, 1, config, "graph")  # captures this K's graph
            row = render_loop(scene, SPP, config, "graph")
            same = bool(np.array_equal(row["img"], rows["eager"][0]["img"]))
            per_k.setdefault(k, []).append(row["seconds"] * 1e3 / useful)
            emit("graph_k", k=k, seconds_render=row["seconds"], iterations=row["iterations"],
                 useful_iterations=useful, tail_iterations=row["iterations"] - useful,
                 ms_per_useful_iteration=row["seconds"] * 1e3 / useful,
                 graph_replays=row["replays"], identical_to_eager=same)
            if not same:
                raise AssertionError(f"graph with K={k} differs from eager")
    finally:
        pt.LOOP_ITERATIONS = default_k
        pt.clear_compiled_loops()
    best_k = min(per_k, key=lambda k: sum(per_k[k]) / len(per_k[k]))

    busy = {}
    for loop in ("eager", "graph"):
        render_loop(scene, 1, config, loop)  # the graph of this K again
        busy[loop] = device_busy_ms(scene, 4, config, loop)
    # If the profiler saw no kernel of the replays, the graph's busy time is
    # not measured (null), never taken from the eager loop.
    method = "torch.profiler" if busy["graph"][3] else \
        "torch.profiler (no graph kernels seen: graph not measured)"
    busy_eager_it = busy["eager"][0] / busy["eager"][1]
    busy_graph_it = busy["graph"][0] / busy["graph"][1] if busy["graph"][3] else None
    timed_eager_it = rows["eager"][1]["seconds"] * 1e3 / rows["eager"][1]["iterations"]
    timed_graph_it = rows["graph"][1]["seconds"] * 1e3 / rows["graph"][1]["iterations"]
    share_graph = busy_graph_it / timed_graph_it if busy_graph_it is not None else None
    emit("graph_summary", scene=f"atrium {W}x{H}@{SPP}spp", k=default_k, best_k=best_k,
         k_ms_per_useful_iteration={str(k): v for k, v in per_k.items()},
         eager_ms_per_iteration=eager_ms, graph_ms_per_iteration=graph_ms,
         useful_iterations=useful, graph_iterations=rows["graph"][1]["iterations"],
         busy_method=method, busy_ms_per_iteration={"eager": busy_eager_it, "graph": busy_graph_it},
         busy_share={"eager": busy_eager_it / timed_eager_it, "graph": share_graph},
         profiled={loop: {"busy_ms": b[0], "iterations": b[1], "seconds": b[2], "kernels": b[3]}
                   for loop, b in busy.items()},
         nvidia_smi=card_line())

    check_loops("atrium twopass", scene, 4, RenderConfig(tuning=IntersectTuning(mode="twopass")),
                ("b1", "b6", "rng", "k1", "k2"))
    del scene
    pt.clear_compiled_loops()
    check_loops("lit-banner atrium", load_scene(lit_path), 4, config,
                ("b1", "b2", "b3", "rng", "k2"))
    env_config = RenderConfig(use_env_map=True, env_map_path=env, add_light_triangle=True)
    fscene = load_scene(field, env_config)
    check_loops("env field", fscene, 4, env_config, ("b1", "b2", "rng", "k1", "k2"))
    del fscene
    pt.clear_compiled_loops()

    r = Renderer(path, aspect_ratio=W / H, device=torch.device(DEV))
    eye, fwd = r.camera.position.cpu().numpy(), r.camera.forward.cpu().numpy()
    c0 = CapturedBlock.captures
    for shift in (0.0, 0.6):
        r.look_at(eye=eye + np.array([shift, 0.0, 0.0]), target=eye + 10 * fwd)
        kernels.launches.clear()
        t0 = time.perf_counter()
        got = r.render(W, H, 4, seed=0)
        secs = time.perf_counter() - t0
        launches = kernels.launches.copy()
        cam_scene = dataclasses.replace(r.scene, camera=r.scene.camera.with_dims(W, H))
        want = pt.render(cam_scene, spp=4, seed=0, config=r.config, eager=True)
        same = bool(np.array_equal(got, want))
        emit("graph", scene="Renderer atrium look_at", shift=shift, spp=4, seconds_render=secs,
             identical_to_eager=same, graph_captures_so_far=CapturedBlock.captures - c0,
             **{f"launches_{k}": v for k, v in launches.items()})
        if not same or launches["b1"] == 0 or launches["b2"] == 0:
            raise AssertionError("a Renderer frame through the graph differs from eager")
    if CapturedBlock.captures - c0 != 1:
        raise AssertionError("the second Renderer frame did not reuse the cached graph")
    del r
    pt.clear_compiled_loops()
    torch.cuda.empty_cache()
    return {"eager_ms": eager_ms, "graph_ms": graph_ms, "best_k": best_k}


def cascade_worklists(scene, o, d, ray_tile):
    """Every ``worklist_pass`` call of one ``closest_hit_chunks`` call on
    these rays: [(its arguments with ``tested`` as it came in, its output,
    ``tested`` as it left)]."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    calls, real = [], ci.worklist_pass

    def spy(m8_p, ent, tested, cap, group, n_sub, cbits=None, want_gate=False):
        before = tested.clone()
        out = real(m8_p, ent, tested, cap, group, n_sub, cbits, want_gate)
        calls.append(((m8_p, ent, before, cap, group, n_sub, cbits, want_gate), out,
                      tested.clone()))
        return out

    with mock.patch.object(ci, "worklist_pass", spy):
        ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min, scene.chunk_aabb_max,
                              scene.woop_rows, EPS, ray_tile=ray_tile)
    return calls


def check_worklist(label, args, got, tested_after):
    """One K5 launch's output against its twin's on the same inputs, every
    field and ``tested`` bit for bit."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    m8, ent, before, cap, group, n_sub, cbits, want_gate = args
    tested = before.clone()
    want = ci.worklist_pass_plain(m8, ent, tested, cap, group, n_sub, cbits, want_gate)
    torch.cuda.synchronize()
    bad = [name for name, g, w in zip(ci.Worklist._fields, got, want)
           if (g is None) != (w is None) or (g is not None and not torch.equal(g, w))]
    if not torch.equal(tested, tested_after):
        bad.append("tested")
    emit("worklist", case=label, tiles=m8.shape[0], groups=m8.shape[1] // group, cap=cap,
         n_sub=n_sub, gate=want_gate, coarse_gate=cbits is not None,
         active_groups=int(want.ga.sum()), listed=int(want.counts.sum()),
         units=int(want.offsets[-1]), mismatched=bad)
    if bad:
        raise AssertionError(f"K5 disagrees with its twin ({label}: {bad})")


def phase_worklist(scene, rays_sets):
    """K5 against its twin bit for bit: each pass of the cascade on the
    atrium's primaries and secondaries at 512- and 256-ray tiles, then a
    whole cascade's random passes at ``bigatrium``'s shape (256 tiles x
    1,203 groups, 4 sub-tiles) and at 4,500 groups, the keys then in global
    scratch.  Timed beside the twin on the secondaries' first near pass and
    residual.  Returns (ms, twin ms, bytes) of the first near pass."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_cuda import worklist_caps, worklist_case

    timing = {}
    for name, (o, d) in rays_sets.items():
        for tile in (ci.RAY_TILE, 256):
            calls = cascade_worklists(scene, o, d, tile)
            for k, (args, got, after) in enumerate(calls):
                check_worklist(f"{name} tile {tile} pass {k}", args, got, after)
            if name == "secondary" and tile == ci.RAY_TILE:
                timing = {"near1": calls[0], "residual": calls[-1]}
    for label, (t_tiles, cg, n_sub) in {"bigatrium shape": (256, 1203, 4),
                                        "past shared memory": (16, 4500, 8)}.items():
        m8s, ent, cbits = worklist_case(cg, t_tiles, cg, ci.GROUP, n_sub, ties=True,
                                        empty_tiles=1, with_cbits=True)
        ent, cbits = ent.to(DEV), cbits.to(DEV)
        tested = torch.zeros((t_tiles, cg), dtype=torch.bool, device=DEV)
        for k, (m8, cap) in enumerate(zip(m8s, worklist_caps(cg))):
            args = (m8.to(DEV), ent, tested.clone(), cap, ci.GROUP, n_sub, cbits, cap < cg)
            got = ci.worklist_pass(*args[:2], tested, *args[3:])
            check_worklist(f"{label} pass {k}", args, got, tested)

    out = {}
    for pass_name, ((m8, ent, before, cap, group, n_sub, cbits, want_gate), got, _) in timing.items():
        tested = before.clone()
        copy_ms = queued_ms(lambda: tested.copy_(before), 50)
        ms = queued_ms(lambda: (tested.copy_(before), kernels.worklist(
            m8, ent, tested, cap, group, n_sub, cbits, want_gate)), 50) - copy_ms
        plain_ms = sync_ms(lambda: (tested.copy_(before), ci.worklist_pass_plain(
            m8, ent, tested, cap, group, n_sub, cbits, want_gate)), 20) - copy_ms
        n_bytes = nbytes(m8, ent, before, cbits) + nbytes(*[x for x in got if x is not None]) \
            + before.numel()
        bound_ms, bound_by = bound({"fp32": (0, 128)}, n_bytes)
        emit("worklist_timing", worklist=pass_name, tiles=m8.shape[0], groups=before.shape[1],
             cap=cap, ms=ms, plain_ms=plain_ms, copy_ms=copy_ms, bytes=n_bytes,
             bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms, nvidia_smi=card_line())
        out[pass_name] = (ms, plain_ms, n_bytes)
    return out["near1"]


def phase_tile256(scene, brutes, rays_sets):
    """256-ray tiles, the shape scenes above ``narrow_tile_chunks`` (4,096
    chunks) take: on the atrium's rays, B1 (4 sub-tiles of 64 rays:
    unbounded, gated, gated and t-bounded) and B2 (the near-1 and residual
    worklists) against their twins, and the cascade at ``ray_tile=256``
    against the brute force; then, with ``TPU_PT_NARROW_TILE_CHUNKS``
    lowered below the atrium's chunk count, 16-spp graphed renders at
    512-ray tiles against 256 in turns (512, 256, 256, 512)."""
    import numpy as np

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    tile, n_sub = 256, 4
    group = ci.GROUP
    c = scene.chunk_woop.shape[0]
    cg = -(-c // group)
    cw = ci._nan_pad(scene.chunk_woop, cg * group).contiguous()
    cmin = ci._nan_pad(scene.chunk_aabb_min, cg * group).contiguous()
    cmax = ci._nan_pad(scene.chunk_aabb_max, cg * group).contiguous()
    for name, (o, d) in rays_sets.items():
        rays = ci.pack_rays(o, d)
        tb = ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min,
                                   scene.chunk_aabb_max, scene.woop_rows, EPS, ray_tile=tile).t
        cbits = ci.super_block_bits(rays, cmin, cmax, EPS, tile)
        for mode, args in {
            "unbounded": (rays, cmin, cmax, None, None, EPS, tile, n_sub, False),
            "gated": (rays, cmin, cmax, None, cbits, EPS, tile, n_sub, False),
            "gated_bounded_sub": (rays, cmin, cmax, tb, cbits, EPS, tile, n_sub, True),
        }.items():
            check_b1(name, f"tile256_{mode}", args)
        m8, ent, _ = ci.tile_chunk_activity(rays, cmin, cmax, None, cbits, EPS, tile, n_sub)
        ga, ge = ci._group_stats(m8 != 0, ent, group)
        packed = ci._pack_group_masks(m8, group)
        r = rays.shape[0]
        t0 = torch.full((r,), math.inf, device=DEV)
        i0 = torch.zeros((r,), dtype=torch.int32, device=DEV)
        for wl_name, cap in (("near1", max(4, cg // 9) * 2 // 4), ("residual", cg)):
            idx, counts, _ = ci._worklist(ga, ge, cap)
            masks = torch.take_along_dim(packed, idx[:, :, None].long(), dim=1)
            args = (rays, t0, i0, cw, idx.contiguous(), counts.contiguous(), masks.contiguous(),
                    EPS, group, n_sub)
            tk, ik = b2_kernel(*args)
            tp, ip = ci.run_items_plain(*args)
            torch.cuda.synchronize()
            equal = bool(torch.equal(tk, tp) and torch.equal(ik, ip))
            compare_hits("tile256_b2", name, tk, ik, tp, ip, worklist=wl_name, ray_tile=tile,
                         n_sub=n_sub, items=int(counts.sum()), bit_equal_to_twin=equal)
            if not equal:
                raise AssertionError(f"B2 at 256-ray tiles differs from its twin ({name}, {wl_name})")
        got = ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min,
                                    scene.chunk_aabb_max, scene.woop_rows, EPS, ray_tile=tile)
        row = check_brute("tile256_cascade", name, scene, o, d, got, brutes[name])
        emit("tile256_cascade", rays=name, ray_tile=tile, hits=int(got.hit.sum()), **row)

    config = RenderConfig()
    rows = {}
    old = os.environ.get("TPU_PT_NARROW_TILE_CHUNKS")
    try:
        for tile_rays in (512, 256, 256, 512):
            if tile_rays == 256:
                os.environ["TPU_PT_NARROW_TILE_CHUNKS"] = str(c - 1)
            elif old is None:
                os.environ.pop("TPU_PT_NARROW_TILE_CHUNKS", None)
            else:
                os.environ["TPU_PT_NARROW_TILE_CHUNKS"] = old
            render_loop(scene, 1, config, "graph")  # captures this tile's graph
            row = render_loop(scene, SPP, config, "graph")
            rows.setdefault(tile_rays, []).append(row)
            emit("tile256_render", ray_tile=tile_rays, chunks=c,
                 narrow_tile_chunks=config.tuning.resolve().narrow_tile_chunks,
                 seconds_render=row["seconds"], iterations=row["iterations"],
                 measured_rays=row["rays"], **{f"launches_{k}": v for k, v in row["launches"].items()},
                 hdr_finite=bool(np.isfinite(row["img"]).all()), nvidia_smi=card_line())
    finally:
        if old is None:
            os.environ.pop("TPU_PT_NARROW_TILE_CHUNKS", None)
        else:
            os.environ["TPU_PT_NARROW_TILE_CHUNKS"] = old
        pt.clear_compiled_loops()
    from tpu_pathtracer_torch.utils.image import quantize_u8

    u8 = {t: quantize_u8(torch.from_numpy(rs[0]["img"])).numpy() for t, rs in rows.items()}
    share, dmean, ok = fp_noise(u8[512], u8[256])
    emit("tile256", seconds_512=[r["seconds"] for r in rows[512]],
         seconds_256=[r["seconds"] for r in rows[256]], u8_off_by_more_than_1=share,
         abs_mean_diff=dmean, repeat_identical={t: bool(np.array_equal(rs[0]["img"], rs[1]["img"]))
                                                for t, rs in rows.items()})
    if not ok or any(r["launches"]["b1"] == 0 or r["launches"]["b2"] == 0 for r in rows[256]):
        raise AssertionError("the 256-ray-tile render disagrees with the 512-ray-tile one")


# Why no kernel has a ``library_ms``: no single PyTorch call computes the
# same function (each is a slab or Woop test fused with a minimum, an any
# or a masked sum, over a worklist that depends on the data).
LIBRARY_NOTE = {
    "b1": "none: a slab test fused with a per-sub-tile entry minimum",
    "b2": "none: a Woop test fused with a first minimum over a per-tile worklist",
    "b3": "none: a masked sum of Woop terms over a per-tile worklist",
    "b4": "none: a slab test fused with a first-minimum argmin",
    "b5": "none: a Woop test fused with a first minimum over the active pairs",
    "b6": "none: a Woop test fused with a first minimum over a per-tile worklist",
    "b7": "none: a slab test fused with an any over each group",
}


# K1 and K2 in the kernel line: (counter, name, replaces, note, why no library_ms).
SHADING_ROWS = (
    ("k1", "flat light-cluster pdf (K1)", "tpu_pathtracer/ops/intersect.py:270",
     "light_pdf_sum_flat, fused by XLA on the TPU: no Pallas kernel",
     "none: a masked sum of Woop terms over the lights of each cluster"),
    ("k2", "hit record and texture fetch (K2)", "tpu_pathtracer/models/pathtracer.py:196",
     "hit_info with ops/texture.py:82 sample_many, fused by XLA on the TPU: no Pallas kernel",
     "none: a row gather fused with normals, bilinear texture taps and a normal map"),
)

# K3 and K4 in the kernel line: (counter, name, replaces, note, why no library_ms).
SHADE_CHAIN_ROWS = (
    ("k3", "bounce sampling chain (K3)", "tpu_pathtracer/models/pathtracer.py:308",
     "bounce_step from the env lookup to the new direction, fused by XLA on the TPU",
     "none: an env tap, the alpha roulette and three direction samplers chosen per ray"),
    ("k4", "bounce BSDF chain (K4)", "tpu_pathtracer/models/pathtracer.py:308",
     "bounce_step from the pdf blend to the next ray, fused by XLA on the TPU",
     "none: two pdfs, the MIS blend, the metallic-roughness BRDF and the kill test"),
)


def kernel_work(b1_args, b2_args, b2_units, b4_args, b5_args, b7_args):
    """{kernel: (pair tests, lane operations per pair, bytes)} at the timing
    shapes, counted from this run's inputs: B1 the (ray, chunk) pairs of
    the column blocks its gate lets through, B2 and B6 the set mask bits x
    64 rays x 128 triangles, B5 the active (tile, chunk) pairs x 512 x 128,
    B4 and B7 every (ray, box) pair.  Bytes: each input read once, each
    output written once."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    rays, cmin, cmax, _, cbits, _, ray_tile, _, _ = b1_args
    r, c = rays.shape[0], cmin.shape[0]
    t_tiles = r // ray_tile
    blk = torch.arange(-(-c // ci.ACT_COLS), device=DEV)
    on = ((cbits[:, blk // 32] >> (blk % 32)) & 1) if cbits is not None else torch.ones_like(blk)
    cols = torch.clamp(c - blk * ci.ACT_COLS, max=ci.ACT_COLS)
    work = {"b1": (int((on * cols).sum()) * ray_tile * (t_tiles if cbits is None else 1),
                   SLAB_OPS, nbytes(rays, cmin, cmax, cbits) + 8 * t_tiles * c)}
    rays, tmin0, tidx0, cw, idx, counts, masks, _, _, n_sub = b2_args
    work["b2"] = work["b6"] = (
        b2_units * (ray_tile // n_sub) * cw.shape[2], WOOP_OPS,
        nbytes(rays, tmin0, tidx0, cw, idx, counts, masks) + 8 * r)
    rays, bmin, bmax, _ = b4_args
    work["b4"] = (r * bmin.shape[0], SLAB_OPS, nbytes(rays, bmin, bmax) + 8 * r)
    rays, tmin0, tidx0, cw, bits, _ = b5_args
    active = sum(int(((bits >> k) & 1).sum()) for k in range(32))
    work["b5"] = (active * ray_tile * cw.shape[2], WOOP_OPS,
                  nbytes(rays, tmin0, tidx0, cw, bits) + 8 * r)
    rays, cmin, cmax, _, group = b7_args
    work["b7"] = (r * cmin.shape[0], SLAB_OPS,
                  nbytes(rays, cmin, cmax) + 4 * r * (cmin.shape[0] // group))
    return work


def run_only(names):
    """The phases named (shading, shade_chain, worklist, engine, homebrew,
    sharded, headline, headline_full) on their own: ``python3 chip_smoke.py engine homebrew``.
    ``headline_full`` runs only when named.  The last line then names the
    phases run; only the full run ends with the contract's line."""
    unknown = set(names) - {"shading", "shade_chain", "worklist", "engine", "homebrew",
                            "sharded", "headline", "headline_full"}
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    from tpu_pathtracer_torch.scene import fixtures

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            import PIL  # noqa: F401
            textured = True
        except ImportError:
            textured = False
        if "worklist" in names:
            _, _, _, scene, rays_sets = make_inputs(tmp)
            phase_worklist(scene, rays_sets)
            del scene, rays_sets
        if {"shading", "shade_chain"} & set(names):
            _, _, _, scene, rays_sets = make_inputs(tmp)
            field = fixtures.make_sphere_field_gltf(os.path.join(tmp, "field", "field.gltf"),
                                                    n_spheres=64, subdiv=3, textured=textured)
            env = fixtures.make_env_hdr(os.path.join(tmp, "field", "env.hdr"))
            if "shading" in names:
                phase_shading(tmp, scene, rays_sets, field, env)
            if "shade_chain" in names:
                phase_shade_chain(tmp, scene, rays_sets, field, env)
            del scene, rays_sets
        path = fixtures.make_atrium_gltf(os.path.join(tmp, "atrium", "atrium.gltf"), detail=2,
                                         textured=textured)
        engine_row = phase_engine(path, tmp) if {"engine", "sharded"} & set(names) else None
        if "homebrew" in names:
            phase_homebrew(tmp)
        if "sharded" in names:
            main_row = phase_render("main", "atrium 512x512@16spp", path, tmp,
                                    ("b1", "b2", "rng", "k1", "k2"))
            phase_sharded(path, tmp, main_row, engine_row)
        if "headline" in names:
            phase_headline(tmp)
        if "headline_full" in names:
            phase_headline_full(tmp)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "phases_only": list(names)}), flush=True)


def main(only=()):
    phase_device()
    phase_build()
    if only:
        return run_only(only)
    rng_times, rng_fits = phase_rng()
    from tpu_pathtracer_torch.models.pathtracer import RenderConfig
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch.scene import fixtures

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path, textured, gen_seconds, scene, rays_sets = make_inputs(tmp)
        if not textured:
            print("PIL is not installed: the atriums are rendered untextured", flush=True)
        b1_err, b1_shapes = phase_b1(scene, rays_sets)
        b2_err, b2_args, b2_units = phase_b2(scene, rays_sets)
        brutes = phase_cascade(scene, rays_sets)
        b4_err, b4_args = phase_b4(scene, rays_sets)
        b5_err, b5_args = phase_b5(scene, rays_sets)
        b6_err, b6_args = phase_b6(scene, rays_sets)
        b7_err, b7_args = phase_b7(scene, rays_sets)
        phase_modes(scene, rays_sets, brutes)
        phase_tile256(scene, brutes, rays_sets)
        k5_ms, k5_plain_ms, k5_bytes = phase_worklist(scene, rays_sets)
        t0 = time.perf_counter()
        field = fixtures.make_sphere_field_gltf(os.path.join(tmp, "field", "field.gltf"),
                                                n_spheres=64, subdiv=3, textured=textured)
        env = fixtures.make_env_hdr(os.path.join(tmp, "field", "env.hdr"))
        field_gen = time.perf_counter() - t0
        errs_k, k2_ulp, times_k, work_k, k1_b3_ms = phase_shading(tmp, scene, rays_sets, field, env)
        chain_k = phase_shade_chain(tmp, scene, rays_sets, field, env)

        # Kernel vs twin time at the main paths' shapes: the initial gated
        # activity pass, the residual item pass, the first-entered-group
        # search, the dense grid on the initial activity, the residual slot
        # pass and the per-ray group bits on sorted atrium secondaries.  B2
        # and B6 run on the same worklist in turns (B2, B6, B6, B2).  B1 is
        # also timed at the gate's 4 columns and as a gated t-bounded
        # recheck, beside a one-element fill (a kernel with nothing to do).
        b1_args = b1_shapes["initial"]
        one = torch.zeros(1, device=DEV)
        b1_ms = {shape: queued_ms(lambda: kernels.activity(*args), 20)
                 for shape, args in b1_shapes.items()}
        emit("b1_timing", **{f"{k}_ms": v for k, v in b1_ms.items()},
             **{f"{k}_columns": args[1].shape[0] for k, args in b1_shapes.items()},
             empty_ms=queued_ms(one.zero_, 20))
        turns = [sync_ms(lambda: b2_kernel(*b2_args), 20),
                 sync_ms(lambda: kernels.slots(*b6_args), 20),
                 sync_ms(lambda: kernels.slots(*b6_args), 20),
                 sync_ms(lambda: b2_kernel(*b2_args), 20)]
        emit("b2_vs_b6", worklist="secondary residual", set_bits=b2_units, b2_ms=[turns[0], turns[3]],
             b6_ms=[turns[1], turns[2]])
        times = {
            "b1": (b1_ms["initial"], sync_ms(lambda: ci.tile_chunk_activity_plain(*b1_args), 5)),
            "b2": ((turns[0] + turns[3]) / 2, sync_ms(lambda: ci.run_items_plain(*b2_args), 3)),
            "b4": (sync_ms(lambda: kernels.nearest(*b4_args), 20),
                   sync_ms(lambda: ci.nearest_box_ids_plain(*b4_args), 5)),
            "b5": (sync_ms(lambda: kernels.dense(*b5_args), 10),
                   sync_ms(lambda: ci.run_dense_plain(*b5_args), 1)),
            "b6": ((turns[1] + turns[2]) / 2, sync_ms(lambda: ci.run_slots_plain(*b6_args), 3)),
            "b7": (sync_ms(lambda: kernels.ray_groups(*b7_args), 20),
                   sync_ms(lambda: ci.ray_group_bools_plain(*b7_args), 5)),
        }
        work = kernel_work(b1_args, b2_args, b2_units, b4_args, b5_args, b7_args)
        del scene, rays_sets, brutes, b1_shapes, b1_args, b2_args, b4_args, b5_args, b6_args, b7_args
        torch.cuda.empty_cache()

        # The lit-banner atrium: B3 on the light pdf of its real bounces.
        lit_path, _, lit_gen, scene, rays_sets = make_inputs(tmp, lit_banners=True)
        if scene.lights.cluster_woop.shape[0] <= 4 or scene.lights.capacity <= 512:
            raise AssertionError("the lit-banner atrium must need the cluster pdf")
        for name, (o, d) in rays_sets.items():  # B1 at the light pdf's shape
            b1_err = max(b1_err, check_b1(name, "light_clusters", (
                ci.pack_rays(o, d), scene.lights.cluster_min.contiguous(),
                scene.lights.cluster_max.contiguous(), None, None, EPS, ci.RAY_TILE, 1, False)))
        b3_err, b3_args = phase_b3(scene, rays_sets)
        times["b3"] = (sync_ms(lambda: kernels.light_pdf(*b3_args), 20),
                       sync_ms(lambda: ci.run_light_pdf_plain(*b3_args), 3))
        rays, cluster_woop, cluster_k, idx, counts, _ = b3_args
        work["b3"] = (int(counts.sum()) * ci.RAY_TILE * cluster_woop.shape[2], PDF_OPS,
                      nbytes(rays, cluster_woop, cluster_k, idx, counts) + 4 * rays.shape[0])
        emit("timing", **{f"{k}_ms": v[0] for k, v in times.items()},
             **{f"{k}_plain_ms": v[1] for k, v in times.items()},
             b1_gate_ms=b1_ms["gate"], b1_recheck_ms=b1_ms["recheck"])
        del scene, rays_sets, b3_args, rays, cluster_woop, cluster_k, idx, counts
        torch.cuda.empty_cache()

        phase_golden(tmp)
        phase_goldens_env_lt(tmp)
        main_row = phase_render("main", "atrium 512x512@16spp", path, tmp,
                                ("b1", "b2", "rng", "k1", "k2", "k3", "k4", "k5"),
                                gen_seconds=gen_seconds)
        lit_row = phase_render("lights_main", "lit-banner atrium 512x512@16spp", lit_path, tmp,
                               ("b1", "b2", "b3", "rng", "k2"), gen_seconds=lit_gen)
        phase_render("env_main", "sphere field + HDR env map + light triangle 512x512@16spp",
                     field, tmp, ("b1", "b2", "k1", "k2"), gen_seconds=field_gen,
                     config=RenderConfig(use_env_map=True, env_map_path=env,
                                         add_light_triangle=True))
        phase_graph(path, lit_path, field, env)
        sort_rows = phase_sort_keys(path, main_row)
        mode_rows = phase_modes_render(path, tmp, main_row)
        engine_row = phase_engine(path, tmp)
        phase_homebrew(tmp)
        phase_cli_txt(tmp)
        phase_renderer(path)
        phase_checkpoint(path, tmp, main_row)
        phase_headline(tmp)
        phase_accumulate()
        phase_sharded(path, tmp, main_row, engine_row)
        phase_golden(tmp, phase="goldens_more", make="make_textured_cornell_gltf",
                     golden="textured_64x64_4096spp.ppm")
        phase_golden(tmp, phase="goldens_more", golden="cornell_96x64_4096spp.ppm",
                     size=(96, 64))
    phase_bench()

    # Each kernel's launches on its own path: B1/B2 the main render, B3 the
    # lit-banner render, B4 the "target" key, B5 the "dense" render, B6 the
    # "twopass" render, B7 the "bins" render.
    launches = {"b1": main_row.get("launches_b1", 0), "b2": main_row.get("launches_b2", 0),
                "b3": lit_row.get("launches_b3", 0), "b4": sort_rows["target"]["b4"],
                "b5": mode_rows["dense"].get("launches_b5", 0),
                "b6": mode_rows["twopass"].get("launches_b6", 0),
                "b7": mode_rows["bins"].get("launches_b7", 0)}
    errs = {"b1": b1_err, "b2": b2_err, "b3": b3_err, "b4": b4_err, "b5": b5_err,
            "b6": b6_err, "b7": b7_err}
    table = [
        ("activity (B1)", "chunk_kernels.cu", "b1", 146),
        ("items (B2)", "chunk_kernels.cu", "b2", 819),
        ("light pdf (B3)", "light_sort_kernels.cu", "b3", 1493),
        ("nearest box (B4)", "light_sort_kernels.cu", "b4", 1673),
        ("dense grid (B5)", "mode_kernels.cu", "b5", 727),
        ("slot grid (B6)", "mode_kernels.cu", "b6", 761),
        ("ray group bits (B7)", "mode_kernels.cu", "b7", 421),
    ]
    rows = []
    for name, src, k, line in table:
        pairs, ops, n_bytes = work[k]
        bound_ms, bound_by = bound({"fp32": (pairs * ops, 128)}, n_bytes)
        rows.append({
            "name": name, "route": "cuda", "source": f"tpu_pathtracer_torch/csrc/{src}",
            "replaces": f"tpu_pathtracer/ops/pallas_intersect.py:{line}",
            "launches": launches[k], "max_abs_err": errs[k], "ms": times[k][0],
            "plain_ms": times[k][1], "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / times[k][0], "library_ms": None,
            "library_note": LIBRARY_NOTE[k],
            "work": {"pairs": pairs, "ops_per_pair": ops, "bytes": n_bytes}})
    ms, plain_ms, rng_err = rng_times["bounce"]
    pipes, n_bytes = rng_work(N_RAYS)
    bound_ms, bound_by = bound(pipes, n_bytes)
    rows.append({
        "name": "threefry draws (not a TPU kernel)", "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/rng_kernels.cu",
        "replaces": "tpu_pathtracer/ops/rng.py:87",
        "replaces_note": "lane_uniforms, fused by XLA on the TPU: no Pallas kernel",
        "launches": main_row.get("launches_rng", 0), "max_abs_err": rng_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "share": bound_ms / ms, "library_ms": None,
        "library_note": "none: no PyTorch call computes threefry-2x32 counter draws",
        "launch_intercept_ms": rng_fits["bounce"][0],
        "ns_per_1k_lanes": rng_fits["bounce"][1] * 1e9,
        "work": {"ops_by_pipe": {k: v for k, (v, _) in pipes.items()}, "bytes": n_bytes}})
    for k, name, replaces, note, library in SHADING_ROWS:
        ops, n_bytes = work_k[k]
        bound_ms, bound_by = bound({"fp32": (ops, 128)}, n_bytes)
        ms, plain_ms = times_k[k]
        rows.append({
            "name": name, "route": "cuda", "source": "tpu_pathtracer_torch/csrc/shade_kernels.cu",
            "replaces": replaces, "replaces_note": note,
            "launches": main_row.get(f"launches_{k}", 0),
            "max_abs_err": errs_k[k], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / ms, "library_ms": None,
            "library_note": library, "work": {"ops": ops, "bytes": n_bytes},
            **({"b3_route_ms": k1_b3_ms} if k == "k1" else {"max_ulp": k2_ulp})})
    for k, name, replaces, note, library in SHADE_CHAIN_ROWS:
        ms, plain_ms, n_bytes = chain_k[k]
        bound_ms, bound_by = bound({"fp32": (0, 128)}, n_bytes)
        rows.append({
            "name": name, "route": "cuda", "source": "tpu_pathtracer_torch/csrc/shade_kernels.cu",
            "replaces": replaces, "replaces_note": note,
            "launches": main_row.get(f"launches_{k}", 0),
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / ms, "library_ms": None,
            "library_note": library, "work": {"bytes": n_bytes}})
    bound_ms, bound_by = bound({"fp32": (0, 128)}, k5_bytes)
    rows.append({
        "name": "cascade pass worklist (K5)", "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/chunk_kernels.cu",
        "replaces": "tpu_pathtracer/ops/pallas_intersect.py:907",
        "replaces_note": "closest_hit_chunks' jnp glue around the Pallas kernels, fused by XLA",
        "launches": main_row.get("launches_k5", 0), "max_abs_err": 0.0, "ms": k5_ms,
        "plain_ms": k5_plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "share": bound_ms / k5_ms, "library_ms": None,
        "library_note": "none: group stats, a per-tile sort, packing and a prefix sum in one pass",
        "work": {"bytes": k5_bytes}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
