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
                   in 193 clusters).

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
                   bounce draws at 4 spp;
  renderer         two ``look_at`` frames of the atrium through ``Renderer``
                   (no re-upload of the scene, no kernel rebuild);

checks the Cornell goldens (plain, environment map PNG and HDR, light
triangle, Sobol bounce draws, Sobol jitter) at 64x64 @ 64 spp and, in phase
goldens_more, the textured Cornell at 64x64 and the plain one at 96x64; and
renders the homebrew ``.txt`` scenes (no kernel: plain torch):

  homebrew         a Whitted scene at RAY_DEPTH 8 and a Monte-Carlo scene,
                   card against CPU at 64x48, then timed at 640x480 (the
                   Monte-Carlo one at 64 spp);
  cli_txt          both through ``python -m tpu_pathtracer_torch`` at
                   160x120 in a process of their own.

Every phase prints one JSON line; any failure raises, so the script exits
non-zero without the final line.  The last two lines before the final one
are the kernel table and the card's ``nvidia-smi`` name and power limit; the
final line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

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


def bound(pairs, ops_per_pair, n_bytes):
    """(bound_ms, bound_by) for ``pairs`` pair tests of ``ops_per_pair`` lane
    operations that move ``n_bytes``."""
    lane_ops_per_s = torch.cuda.get_device_properties(0).multi_processor_count * 128 * CLOCK_HZ
    t_ops = pairs * ops_per_pair / lane_ops_per_s * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card_line(), torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():
    from tpu_pathtracer_torch import kernels

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


def counters():
    """Kernel name -> the wrapper that counts its launches."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    return {"b1": ci.tile_chunk_activity, "b2": ci.run_items, "b3": ci.run_light_pdf,
            "b4": ci.nearest_box_ids, "b5": ci.run_dense, "b6": ci.run_slots,
            "b7": ci.ray_group_bools}


def reset_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in counters().items()}


def make_inputs(tmp, lit_banners=False):
    """The atrium (or the lit-banner atrium) on the card, its first 65,536
    primary rays and one bounce of their sorted, compacted secondaries."""
    import dataclasses

    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.ops.rng import jitter_uniforms
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
    n = N_RAYS
    pids = torch.arange(n, dtype=torch.int32, device=DEV)
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
    return path, textured, t_gen, scene, {"primary": (o, d), "secondary": (o2, d2)}


def check_b1(rays_name, mode, args):
    """One B1 launch against its twin on the same inputs: m8, ent and (when
    asked) sub_ent exactly equal.  Returns the max abs error of ent."""
    from tpu_pathtracer_torch import kernels
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


def phase_b2(scene, rays_sets):
    """B2 kernel vs its twin on real worklists: t and tri bit-equal to the
    twin (ties included) and across two runs.  Returns (max abs error,
    timing args, set mask bits of the timing worklist)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch import kernels

    worst = 0.0
    timing = units = None
    for name, (o, d) in rays_sets.items():
        rays, cw, wls = worklists(scene, o, d)
        r = rays.shape[0]
        t0 = torch.full((r,), math.inf, device=DEV)
        i0 = torch.zeros((r,), dtype=torch.int32, device=DEV)
        for wl_name, (idx, counts, masks) in wls.items():
            args = (rays, t0, i0, cw, idx, counts, masks, EPS, ci.GROUP, 8)
            tk, ik = kernels.items(*args)
            tk2, ik2 = kernels.items(*args)
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
    from tpu_pathtracer_torch import kernels
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
    from tpu_pathtracer_torch import kernels
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
            tb, ib = kernels.items(*args)
            tp, ip = ci.run_slots_plain(*args)
            torch.cuda.synchronize()
            same_b2 = bool(torch.equal(tk, tb) and torch.equal(ik, ib))
            det = bool(torch.equal(tk, tk2) and torch.equal(ik, ik2))
            turns = [sync_ms(lambda: kernels.items(*args), 10),  # B2, B6, B6, B2
                     sync_ms(lambda: kernels.slots(*args), 10),
                     sync_ms(lambda: kernels.slots(*args), 10),
                     sync_ms(lambda: kernels.items(*args), 10)]
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
    from tpu_pathtracer_torch import kernels
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
        reset_launches()
        hit = ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min,
                                    scene.chunk_aabb_max, scene.woop_rows, EPS,
                                    tuning=IntersectTuning(**tuning))
        torch.cuda.synchronize()
        return hit, read_launches()

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
    reset_launches()
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
    launches = read_launches()
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
    row["img"] = img
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


def phase_engine(path, tmp):
    """The scan engine with Sobol jitter and bounce draws: the atrium at
    512x512 @ 4 spp (measured rays are not counted by the scan engine), and
    the Cornell golden with lowdisc="sobol" and with jitter="sobol"."""
    from tpu_pathtracer_torch.models.pathtracer import RenderConfig

    config = RenderConfig(compaction=False, jitter="sobol", lowdisc="sobol")
    row = phase_render("engine", "atrium 512x512@4spp scan engine, Sobol", path, tmp,
                       ("b1", "b2"), config=config, spp=4)
    if row["measured_rays"] is not None:
        raise AssertionError("the scan engine reported measured rays")
    phase_golden(tmp, RenderConfig(lowdisc="sobol"), phase="engine_golden")
    phase_golden(tmp, RenderConfig(jitter="sobol"), phase="engine_golden")


def phase_b4(scene, rays_sets):
    """B4 kernel vs its twin on the atrium's worklist-group boxes: ids
    exactly equal, entry distances equal, and no padding group returned.
    Returns (max abs error of the entry t, timing args)."""
    from tpu_pathtracer_torch import kernels
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
    from tpu_pathtracer_torch import kernels
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
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models.pathtracer import RenderConfig, render
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    scene = parse_gltf_scene(path, W / H)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(W, H)).to(DEV)
    emit("sort_keys", sort_key="hint", **{k: v for k, v in hint.items() if k in (
        "seconds_render", "measured_rays", "pixel_samples_per_s", "measured_mrays_per_s")},
        **{k: v for k, v in hint.items() if k.startswith("launches_")})
    out = {}
    for key in ("target", "cell", "dirhint"):
        stats = {}
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene, spp=SPP, seed=0, config=RenderConfig(sort_key=key), stats=stats)
        secs = time.perf_counter() - t0
        launches = read_launches()
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


def phase_homebrew(tmp):
    """Each homebrew scene rendered by the port on the card and on the CPU
    at 64x48 (the Monte-Carlo scene at 8 spp) must agree to the render
    tests' u8 rule (``fp_noise``: the card's elementwise kernels may round
    a product in another order, which can flip a Russian-roulette coin);
    then each is timed on the card at 640x480, the Monte-Carlo scene at 64
    spp, beside the card's name and power limit."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models.legacy import render_homebrew
    from tpu_pathtracer_torch.scene.homebrew import parse_homebrew_scene
    from tpu_pathtracer_torch.utils.image import quantize_u8

    u8 = lambda hdr: quantize_u8(torch.from_numpy(hdr)).numpy()
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
        render_homebrew(full, seed=1)  # warm-up: the allocator's first blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_homebrew(full, seed=0)
        secs = time.perf_counter() - t0
        emit("homebrew", scene=name, monte_carlo=scene.monte_carlo, ray_depth=scene.ray_depth,
             primitives=int(scene.valid.sum()), check="64x48 card vs cpu",
             hdr_max_abs_diff=float(np.abs(cpu - card).max()), u8_off_by_more_than_1=share,
             abs_mean_diff=dmean, cpu_seconds=round(cpu_s, 3),
             timed=f"{w}x{h}@{scene.samples or 1}spp", seconds_render=secs,
             pixel_samples_per_s=w * h * (scene.samples or 1) / secs,
             hdr_finite=bool(np.isfinite(img).all()), u8_mean=float(u8(img).mean()),
             nvidia_smi=card_line())
        if not ok or not np.isfinite(card).all() or img.shape != (h, w, 3):
            raise AssertionError(f"homebrew {name}: the card disagrees with the CPU")


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


def phase_renderer(path):
    """A ``Renderer`` on the atrium, two ``look_at`` frames at 512x512 @ 16
    spp, each with the launch counters set to 0 just before and read just
    after: B1 and B2 launch in both, the frames differ, the scene's tensors
    keep their device addresses, and no kernel library is built again.
    The second frame is timed."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch import kernels
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
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames.append(r.render(W, H, SPP, seed=0))
            secs.append(time.perf_counter() - t0)
            launches.append(read_launches())
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


def main():
    phase_device()
    phase_build()
    from tpu_pathtracer_torch import kernels
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
        turns = [sync_ms(lambda: kernels.items(*b2_args), 20),
                 sync_ms(lambda: kernels.slots(*b6_args), 20),
                 sync_ms(lambda: kernels.slots(*b6_args), 20),
                 sync_ms(lambda: kernels.items(*b2_args), 20)]
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
        main_row = phase_render("main", "atrium 512x512@16spp", path, tmp, ("b1", "b2"),
                                gen_seconds=gen_seconds)
        lit_row = phase_render("lights_main", "lit-banner atrium 512x512@16spp", lit_path, tmp,
                               ("b1", "b2", "b3"), gen_seconds=lit_gen)
        t0 = time.perf_counter()
        field = fixtures.make_sphere_field_gltf(os.path.join(tmp, "field", "field.gltf"),
                                                n_spheres=64, subdiv=3, textured=textured)
        env = fixtures.make_env_hdr(os.path.join(tmp, "field", "env.hdr"))
        field_gen = time.perf_counter() - t0
        phase_render("env_main", "sphere field + HDR env map + light triangle 512x512@16spp",
                     field, tmp, ("b1", "b2"), gen_seconds=field_gen,
                     config=RenderConfig(use_env_map=True, env_map_path=env,
                                         add_light_triangle=True))
        sort_rows = phase_sort_keys(path, main_row)
        mode_rows = phase_modes_render(path, tmp, main_row)
        phase_engine(path, tmp)
        phase_homebrew(tmp)
        phase_cli_txt(tmp)
        phase_renderer(path)
        phase_golden(tmp, phase="goldens_more", make="make_textured_cornell_gltf",
                     golden="textured_64x64_4096spp.ppm")
        phase_golden(tmp, phase="goldens_more", golden="cornell_96x64_4096spp.ppm",
                     size=(96, 64))

    # Each kernel's launches on its own path: B1/B2 the main render, B3 the
    # lit-banner render, B4 the "target" key, B5 the "dense" render, B6 the
    # "twopass" render, B7 the "bins" render.
    launches = {"b1": main_row["launches_b1"], "b2": main_row["launches_b2"],
                "b3": lit_row["launches_b3"], "b4": sort_rows["target"]["b4"],
                "b5": mode_rows["dense"]["launches_b5"],
                "b6": mode_rows["twopass"]["launches_b6"],
                "b7": mode_rows["bins"]["launches_b7"]}
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
        bound_ms, bound_by = bound(pairs, ops, n_bytes)
        rows.append({
            "name": name, "route": "cuda", "source": f"tpu_pathtracer_torch/csrc/{src}",
            "replaces": f"tpu_pathtracer/ops/pallas_intersect.py:{line}",
            "launches": launches[k], "max_abs_err": errs[k], "ms": times[k][0],
            "plain_ms": times[k][1], "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / times[k][0], "library_ms": None,
            "library_note": LIBRARY_NOTE[k],
            "work": {"pairs": pairs, "ops_per_pair": ops, "bytes": n_bytes}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
