#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``tpu_pathtracer_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``tpu_pathtracer_torch/csrc``, holds each
kernel against its plain-torch twin on the inputs of the real main path
(the enclosed atrium, ~218k triangles, 65,536-ray batches), checks the
chunk cascade against the dense sweep and the Cornell render against the
committed golden, then renders the atrium at 512x512 @ 16 spp through the
port's CLI entry point and checks that both kernels ran on that path.

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
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W = H = 512
SPP = 16
EPS = 1e-4  # RenderConfig.eps, the intersector's min_dst
DEV = "cuda"
N_RAYS = 1 << 16  # RenderConfig.rays_per_batch


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

    info = kernels.build()
    with open(os.path.join(kernels.BUILD_DIR, "nvcc.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    kernels.library()
    emit("build", built=info["built"], nvcc_seconds=round(info["seconds"], 3), ptxas=ptxas)


def make_inputs(tmp):
    """The atrium scene on the card, its first 65,536 primary rays and one
    bounce of their sorted, compacted secondaries."""
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
    path = fixtures.make_atrium_gltf(os.path.join(tmp, "atrium.gltf"), detail=2,
                                     textured=textured)
    t_gen = time.perf_counter() - t0
    config = pt.RenderConfig()
    t0 = time.perf_counter()
    scene = gltf.parse_gltf_scene(path, W / H, config)
    t_parse = time.perf_counter() - t0
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(W, H)).to(DEV)
    emit("inputs", pil=textured, native_packer=gltf.native.load_library() is not None,
         triangles=int(scene.valid.sum()), chunks=scene.chunk_woop.shape[0],
         lights=scene.lights.count, gen_seconds=round(t_gen, 3),
         parse_seconds=round(t_parse, 3))
    n = N_RAYS
    pids = torch.arange(n, dtype=torch.int32, device=DEV)
    o, d = pt.gen_rays(scene.camera, pids, jitter_uniforms(0, 0, pids))
    alive = torch.ones(n, dtype=torch.bool, device=DEV)
    draws = pt.bounce_draws(0, 0, 0, pids)
    o2, d2, _, _, alive2, hint = pt.bounce_step(
        scene, config, o, d, torch.ones_like(o), torch.zeros_like(o), alive, draws
    )
    key = pt._make_sort_key(scene, config)(o2, d2, alive2, hint)
    perm = torch.argsort(key, stable=True)
    o2, d2, alive2 = o2[perm], d2[perm], alive2[perm]
    o2 = torch.where(alive2[:, None], o2, torch.full_like(o2, 1e30))
    return path, textured, t_gen, scene, {"primary": (o, d), "secondary": (o2, d2)}


def phase_b1(scene, rays_sets):
    """B1 kernel vs its twin: unbounded, t-bounded, gated, with sub-tile
    entries.  m8 / ent / sub_ent must be exactly equal (both sides round the
    same IEEE ops in the same order: the kernel is built with --fmad=false)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch import kernels

    cmin, cmax = scene.chunk_aabb_min, scene.chunk_aabb_max
    worst = 0.0
    for name, (o, d) in rays_sets.items():
        rays = ci.pack_rays(o, d)
        tb = ci.closest_hit_chunks(o, d, scene.chunk_woop, cmin, cmax, scene.woop_rows, EPS).t
        cbits = ci.super_block_bits(rays, cmin, cmax, EPS, ci.RAY_TILE)
        for mode, tbest, gate, want in (
            ("unbounded", None, None, False),
            ("bounded", tb, None, False),
            ("gated", None, cbits, False),
            ("gated_bounded_sub", tb, cbits, True),
        ):
            args = (rays, cmin, cmax, tbest, gate, EPS, ci.RAY_TILE, 8, want)
            mk, ek, sk = kernels.activity(*args)
            mp, ep, sp = ci.tile_chunk_activity_plain(*args)
            torch.cuda.synchronize()
            bad_m8 = int((mk != mp).sum())
            bad_ent = int((ek != ep).sum())
            bad_sub = int((sk != sp).sum()) if want else 0
            fin = torch.isfinite(ep)
            err = float((ek[fin] - ep[fin]).abs().max()) if fin.any() else 0.0
            worst = max(worst, err)
            emit("b1", rays=name, mode=mode, active_pairs=int((mp != 0).sum()),
                 m8_mismatch=bad_m8, ent_mismatch=bad_ent, sub_mismatch=bad_sub,
                 max_abs_err=err)
            if bad_m8 or bad_ent or bad_sub:
                raise AssertionError(f"B1 kernel disagrees with its twin ({name}, {mode})")
    return worst


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
    """B2 kernel vs its twin on real worklists: t equal to 1 ulp, tri equal
    except where two triangles give exactly the same t (counted)."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch import kernels

    worst = 0.0
    timing = None
    for name, (o, d) in rays_sets.items():
        rays, cw, wls = worklists(scene, o, d)
        r = rays.shape[0]
        t0 = torch.full((r,), math.inf, device=DEV)
        i0 = torch.zeros((r,), dtype=torch.int32, device=DEV)
        for wl_name, (idx, counts, masks) in wls.items():
            args = (rays, t0, i0, cw, idx, counts, masks, EPS, ci.GROUP, 8)
            tk, ik = kernels.items(*args)
            tp, ip = ci.run_items_plain(*args)
            torch.cuda.synchronize()
            fin = torch.isfinite(tp)
            if not torch.equal(torch.isfinite(tk), fin):
                raise AssertionError(f"B2 hit masks differ ({name}, {wl_name})")
            ulp = (tk[fin].view(torch.int32) - tp[fin].view(torch.int32)).abs()
            err = float((tk[fin] - tp[fin]).abs().max()) if fin.any() else 0.0
            tri_diff = (ik != ip) & fin
            ties = int((tri_diff & (tk == tp)).sum())
            bad_tri = int(tri_diff.sum()) - ties
            worst = max(worst, err)
            emit("b2", rays=name, worklist=wl_name, items=int(counts.sum()),
                 hits=int(fin.sum()), max_ulp=int(ulp.max()) if fin.any() else 0,
                 max_abs_err=err, tri_mismatch=bad_tri, exact_t_ties=ties)
            if (fin.any() and int(ulp.max()) > 1) or bad_tri:
                raise AssertionError(f"B2 kernel disagrees with its twin ({name}, {wl_name})")
            if name == "secondary" and wl_name == "residual":
                timing = args
    return worst, timing


def phase_cascade(scene, rays_sets):
    """closest_hit_chunks through the kernels, over all ~218k triangles,
    against two oracles.

    1. The brute force in the kernels' own arithmetic: the B2 twin run over
       every chunk group of every tile with all sub-tile bits set.  The
       cascade skips only chunks whose AABB no ray of a 64-ray sub-tile
       reaches before its best hit, so t must be exactly equal (a
       differing triangle is then an exact-t tie) except on rays whose own
       slab test, rounded, cannot reach the brute-force winner's chunk
       (a hit on a chunk's AABB face, which the JAX cascade shares).  Each
       differing ray is checked for that and printed; they may be at most
       0.1% of the rays.
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
       side, or such a near-origin hit) are counted and reported."""
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch.ops.intersect import closest_hit

    group = ci.GROUP
    cg = -(-scene.chunk_woop.shape[0] // group)
    cw = ci._nan_pad(scene.chunk_woop, cg * group).contiguous()
    for name, (o, d) in rays_sets.items():
        got = ci.closest_hit_chunks(o, d, scene.chunk_woop, scene.chunk_aabb_min,
                                    scene.chunk_aabb_max, scene.woop_rows, EPS)
        r = o.shape[0]
        t_tiles = r // ci.RAY_TILE
        idx = torch.arange(cg, dtype=torch.int32, device=DEV).expand(t_tiles, cg).contiguous()
        counts = torch.full((t_tiles,), cg, dtype=torch.int32, device=DEV)
        masks = torch.full((t_tiles, cg, 2), -1, dtype=torch.int32, device=DEV)
        t_bf, tri_bf = ci.run_items_plain(
            ci.pack_rays(o, d), torch.full((r,), math.inf, device=DEV),
            torch.zeros((r,), dtype=torch.int32, device=DEV), cw, idx, counts, masks,
            EPS, group, 8,
        )
        bf_hit = torch.isfinite(t_bf)
        differ = (bf_hit != got.hit) | (bf_hit & (got.t != t_bf))
        bf_ties = int(((got.tri != tri_bf) & bf_hit & ~differ).sum())
        # A ray may miss a triangle only where its own slab test cannot
        # reach that triangle's chunk before the ray's cascade hit.
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
            emit("cascade_diff", rays=name, ray=int(ids[k]), t_brute=float(t_bf[ids[k]]),
                 tri_brute=int(tri_bf[ids[k]]), t_cascade=float(got.t[ids[k]]),
                 tri_cascade=int(got.tri[ids[k]]), slab_t_lo=float(t_lo[k]),
                 slab_t_hi=float(t_hi[k]), reachable=bool(reach[k]))

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
        emit("cascade", rays=name, hits=int(both.sum()),
             brute_differ=int(differ.sum()), brute_differ_unexplained=int(reach.sum()),
             brute_tri_ties=bf_ties, dense_hit_agree=agree, dense_tri_agree=tri_eq,
             dense_other_tri=int((both & ~same).sum()), t_tol_ratio=t_rel,
             beta_tol_ratio=b_rel)
        if bool(reach.any()) or int(differ.sum()) > 1e-3 * r:
            raise AssertionError(f"cascade differs from the brute force ({name})")
        if not (agree > 0.995 and tri_eq > 0.99 and t_rel <= 1.0 and b_rel <= 1.0):
            raise AssertionError(f"cascade disagrees with the dense sweep ({name})")


def phase_golden(tmp):
    """Cornell 64x64 @ 64 spp through the port (dense path) against the
    committed 4096-spp golden: rmse < 14, |mean difference| < 3 (u8)."""
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models.pathtracer import render
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
    from tpu_pathtracer_torch.utils.image import quantize_u8, read_ppm

    p = fixtures.make_cornell_gltf(os.path.join(tmp, "cornell", "cornell.gltf"))
    scene = parse_gltf_scene(p, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64)).to(DEV)
    t0 = time.perf_counter()
    img = render(scene, spp=64, seed=0)
    secs = time.perf_counter() - t0
    ours = quantize_u8(torch.from_numpy(img)).numpy().astype(np.float64)
    ref = read_ppm(os.path.join(ROOT, "tests", "golden", "cornell_64x64_4096spp.ppm")).astype(np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    dmean = float(abs(ours.mean() - ref.mean()))
    emit("golden", scene="cornell 64x64@64spp", rmse=rmse, abs_mean_diff=dmean,
         seconds=round(secs, 3))
    if not (rmse < 14.0 and dmean < 3.0):
        raise AssertionError("Cornell golden failed")


def phase_main(path, gen_seconds, tmp):
    """The atrium at 512x512 @ 16 spp through the CLI entry point, with the
    kernel launch counters reset just before and read just after."""
    import numpy as np

    from tpu_pathtracer_torch import cli
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch.utils.image import read_ppm

    captured = {}
    render = cli.render

    def tap(*a, **kw):  # keep the HDR frame for the finiteness check
        captured["hdr"] = render(*a, **kw)
        return captured["hdr"]

    out = os.path.join(tmp, "atrium.ppm")
    err = io.StringIO()
    cli.render = tap
    ci.tile_chunk_activity.launches = 0
    ci.run_items.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["tpu_pathtracer_torch", path, str(W), str(H), str(SPP), out])
        total = time.perf_counter() - t0
    finally:
        cli.render = render
    b1, b2 = ci.tile_chunk_activity.launches, ci.run_items.launches
    if rc != 0:
        raise AssertionError(f"CLI failed (rc {rc}): {err.getvalue()[-2000:]}")
    metrics = json.loads(err.getvalue().strip().splitlines()[-1])
    hdr = captured["hdr"]
    img = read_ppm(out)
    load, rend = metrics["load_seconds"], metrics["render_seconds"]
    emit("main", scene="atrium 512x512@16spp", seconds_scene_generation=gen_seconds,
         seconds_load=load, seconds_render=rend,
         seconds_write=round(total - load - rend, 4), seconds_total=round(total, 4),
         pixel_samples_per_s=W * H * SPP / rend, measured_rays=metrics["measured_rays"],
         measured_mrays_per_s=metrics["measured_rays"] / rend / 1e6,
         launches_b1=b1, launches_b2=b2, ppm_shape=list(img.shape),
         hdr_finite=bool(np.isfinite(hdr).all()), u8_mean=float(img.mean()))
    if b1 == 0 or b2 == 0:
        raise AssertionError(f"main path did not launch both kernels: B1 {b1}, B2 {b2}")
    if img.shape != (H, W, 3) or not np.isfinite(hdr).all() or not img.mean() > 0:
        raise AssertionError("atrium render output is wrong")
    return b1, b2


def main():
    phase_device()
    phase_build()
    from tpu_pathtracer_torch import kernels
    from tpu_pathtracer_torch.ops import chunk_intersect as ci

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path, textured, gen_seconds, scene, rays_sets = make_inputs(tmp)
        if not textured:
            print("PIL is not installed: the atrium is rendered untextured", flush=True)
        b1_err = phase_b1(scene, rays_sets)
        b2_err, b2_args = phase_b2(scene, rays_sets)
        phase_cascade(scene, rays_sets)

        # Kernel vs twin time at the main path's shapes: the initial gated
        # activity pass and the residual item pass on sorted secondaries.
        o, d = rays_sets["secondary"]
        rays = ci.pack_rays(o, d)
        cmin, cmax = scene.chunk_aabb_min, scene.chunk_aabb_max
        cbits = ci.super_block_bits(rays, cmin, cmax, EPS, ci.RAY_TILE)
        b1_args = (rays, cmin, cmax, None, cbits, EPS, ci.RAY_TILE, 8, False)
        times = {
            "b1": (sync_ms(lambda: kernels.activity(*b1_args), 20),
                   sync_ms(lambda: ci.tile_chunk_activity_plain(*b1_args), 5)),
            "b2": (sync_ms(lambda: kernels.items(*b2_args), 20),
                   sync_ms(lambda: ci.run_items_plain(*b2_args), 3)),
        }
        emit("timing", b1_ms=times["b1"][0], b1_plain_ms=times["b1"][1],
             b2_ms=times["b2"][0], b2_plain_ms=times["b2"][1])
        del scene, rays_sets
        torch.cuda.empty_cache()

        phase_golden(tmp)
        b1_n, b2_n = phase_main(path, gen_seconds, tmp)

    src = "tpu_pathtracer_torch/csrc/chunk_kernels.cu"
    print(json.dumps({"kernels": [
        {"name": "activity (B1)", "route": "cuda", "source": src,
         "replaces": "tpu_pathtracer/ops/pallas_intersect.py:146", "launches": b1_n,
         "max_abs_err": b1_err, "ms": times["b1"][0], "plain_ms": times["b1"][1]},
        {"name": "items (B2)", "route": "cuda", "source": src,
         "replaces": "tpu_pathtracer/ops/pallas_intersect.py:819", "launches": b2_n,
         "max_abs_err": b2_err, "ms": times["b2"][0], "plain_ms": times["b2"][1]},
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
