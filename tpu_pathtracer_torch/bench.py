#!/usr/bin/env python3
"""Benchmark of the port: the enclosed atrium at 512x512 @ 16 spp on one
CUDA card (the port of the repository's ``bench.py``).  Run from the
repository root:

    python3 -m tpu_pathtracer_torch.bench

The workload is ``bench.py``'s: the procedural atrium
(``scene.fixtures.make_atrium_gltf(detail=2)``: ~218k textured triangles,
walled and roofed, lit only through its skylights), parsed, resized with
``camera.with_dims`` and rendered by ``models.pathtracer.render`` (the
persistent engine, its loop one CUDA graph on the card) with 65,536-ray
wavefronts, the "hint" sort key and whole-frame spp passes.  One warm-up
render at seed 0 at the bench's spp (it builds the kernels, captures the
graph the timed renders replay and runs the same passes), then
``BENCH_REPS`` timed renders at seed 1, each followed by one of the open
sphere field (``bench.py``'s round-2 scene), in turns.  The reported times
are the median's.

Prints one JSON line last, with ``bench.py``'s keys (``metric``, ``value``
= measured Mrays/s, ``unit``, ``vs_baseline`` = pixel-samples/s over the
reference CPU's 3.5e5 on enclosed Sponza, ``pixel_samples_per_s``,
``mrays_depth8_upper_bound``, ``measured_rays``, ``timing``,
``rep_times_s``, ``field_open_scene_samples_per_s``) and the card's own:
``card`` (``nvidia-smi`` name and power limit), ``reps``,
``render_s_median``, ``render_s_spread`` ((max - min) / median),
``iterations`` and ``loop`` of the engine, ``device_busy_ms_per_iteration``
and ``device_busy_share`` (from one more render under ``torch.profiler``,
after the timed ones; the ten device operations that took the most time in
it are printed on the lines before), ``peak_allocated_bytes``
(``torch.cuda.max_memory_allocated`` over the warm-ups and timed renders)
and ``reserved_bytes`` (the caching allocator's, the cached graphs' pools
included).

Every timed frame of a scene must equal its first bit for bit, with the
same measured rays, finite and of shape (H, W, 3); otherwise, or if a
render fails, the line is ``bench.py``'s failure line (``value`` 0.0) and
the exit code 1.  With no CUDA device it exits 1 with no line, unless
``TPU_PATHTRACER_TORCH_DEVICE=cpu`` asks for the CPU: then the default
shape is 32x32 @ 1 spp, the field is not rendered and the card's fields
are null.

Environment: ``BENCH_SCENE=field`` benches the open field alone;
``BENCH_SIZE`` (W = H), ``BENCH_SPP``, ``BENCH_REPS`` (default 5),
``BENCH_SORT`` (sort key, default "hint"), ``BENCH_RPB`` (rays per
wavefront, default 65,536), ``BENCH_FRAME_POOL=1`` (the whole frame as one
work pool: the drain tail once a pass, not once a 65,536-pixel chunk) and
``BENCH_NO_FIELD`` (no field renders).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from .cli import select_device
from .config import RenderConfig
from .models import pathtracer as pt
from .scene import fixtures
from .scene.gltf import parse_gltf_scene
from .utils.profiling import card_line

WIDTH = HEIGHT = 512
SPP = 16
REPS = 5
CPU_SIZE, CPU_SPP = 32, 1  # an atrium render at this shape takes ~20 s on one CPU core
TOP_OPS = 10
BASELINE_SAMPLES_PER_S = 3.5e5  # reference CPU, enclosed Sponza (BASELINE.md)
BASELINE_MRAYS = 2.8  # top of the reference's derived range (open-field metric)


class GateFailed(RuntimeError):
    """A timed frame or ray count that is wrong or does not repeat."""


def workload(device: torch.device) -> dict:
    """The shape, repeats and ``RenderConfig`` the environment asks for."""
    env = os.environ
    cpu = device.type == "cpu"
    size = int(env["BENCH_SIZE"]) if env.get("BENCH_SIZE") else (CPU_SIZE if cpu else WIDTH)
    spp = int(env["BENCH_SPP"]) if env.get("BENCH_SPP") else (CPU_SPP if cpu else SPP)
    kind = env.get("BENCH_SCENE", "atrium")
    config = RenderConfig(
        rays_per_batch=int(env.get("BENCH_RPB", 1 << 16)),
        sort_key=env.get("BENCH_SORT", "hint"),
        frame_pool=env.get("BENCH_FRAME_POOL", "0") == "1",
    )
    return dict(kind=kind, width=size, height=size, spp=spp, reps=int(env.get("BENCH_REPS", REPS)),
                config=config,
                field=kind != "field" and not cpu and not env.get("BENCH_NO_FIELD"))


def load_scene(kind: str, tmp: str, width: int, height: int, config: RenderConfig, device):
    """(the bench scene ``kind`` at width x height on ``device``, its label)."""
    if kind == "field":
        path = fixtures.make_sphere_field_gltf(os.path.join(tmp, "field.gltf"), n_spheres=64,
                                               subdiv=3, textured=True)
        label = "open-sphere-field"
    else:
        path = fixtures.make_atrium_gltf(os.path.join(tmp, "atrium.gltf"), detail=2)
        label = "enclosed-atrium"
    scene = parse_gltf_scene(path, width / height, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(width, height))
    return scene.to(device), label


def pass_config(config: RenderConfig, spp: int, width: int, height: int,
                ray_depth: int) -> RenderConfig:
    """``config`` with ``bench.py``'s ``spp_per_pass``: whole-bench-spp
    passes, capped at 256 and so that the engine's int32 work-id and bounce
    counters hold a pool's samples times the scene's ray depth."""
    pool_px = width * height if config.frame_pool else config.rays_per_batch
    per_pass = max(1, min(spp, (2**31 - 1) // (pool_px * max(1, int(ray_depth))), 256))
    return dataclasses.replace(config, spp_per_pass=per_pass)


def timed_render(scene, spp: int, config: RenderConfig, seed: int = 1) -> dict:
    """One ``render`` timed on the host clock (it ends in the frame's copy to
    the host), with its measured rays, loop and iterations."""
    stats: dict = {}
    pt.persistent_accum.iterations = 0
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = pt.render(scene, spp=spp, seed=seed, config=config, stats=stats)
    return dict(img=img, seconds=time.perf_counter() - t0, rays=stats.get("measured_rays"),
                loop=stats.get("loop"), iterations=pt.persistent_accum.iterations)


def check_repeats(label: str, runs: list, shape: tuple) -> None:
    """Every frame finite and of ``shape``, bit-identical to the first, with
    the same measured rays: raises ``GateFailed`` otherwise."""
    first = runs[0]["img"]
    for k, run in enumerate(runs):
        img = run["img"]
        if img.shape != shape or not np.isfinite(img).all():
            raise GateFailed(f"{label} repeat {k}: frame of shape {img.shape}, want {shape}, "
                             f"finite={bool(np.isfinite(img).all())}")
        if not np.array_equal(img.view(np.uint32), first.view(np.uint32)):
            raise GateFailed(f"{label} repeat {k}: frame differs from repeat 0")
        if run["rays"] != runs[0]["rays"]:
            raise GateFailed(f"{label} repeat {k}: {run['rays']} measured rays, "
                             f"repeat 0 {runs[0]['rays']}")


def device_busy(scene, spp: int, config: RenderConfig) -> tuple:
    """(device ms by operation {name: (ms, count)}, iterations) of one more
    render at seed 1 under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from .profile_render import _device_times

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = timed_render(scene, spp, config)
    return _device_times(prof), run["iterations"]


def bench(device: torch.device) -> dict:
    """Run the workload on ``device`` and return the JSON line's fields;
    raises ``GateFailed`` when a check fails."""
    w = workload(device)
    width, height, spp, reps = w["width"], w["height"], w["spp"], w["reps"]
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench_scene_") as tmp:
        scene, label = load_scene(w["kind"], tmp, width, height, w["config"], device)
        config = pass_config(w["config"], spp, width, height, scene.ray_depth)
        field = load_scene("field", tmp, width, height, config, device)[0] if w["field"] else None
    n_tris = int(scene.valid.sum())
    print(f"bench scene: {label}, {n_tris} triangles (textured), {width}x{height} @ {spp} spp, "
          f"{reps} repeats on {device}", file=sys.stderr)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for s in (scene, field):
        if s is not None:  # builds the kernels, captures the graph the repeats replay
            before = 0
            if cuda:  # a graph capture empties the allocator's cache: start from an empty one
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            timed_render(s, spp, config, seed=0)
            secs = time.perf_counter() - t0
            grown = (f", {torch.cuda.memory_reserved() - before} bytes more reserved (the loop's "
                     f"buffers, the scene's derived copies, the graph's pool)" if cuda else "")
            print(f"warm-up (kernel build and graph capture included): {secs:.3f}s{grown}",
                  file=sys.stderr)
    runs, field_runs = [], []
    for _ in range(reps):
        runs.append(timed_render(scene, spp, config))
        if field is not None:
            field_runs.append(timed_render(field, spp, config))
    peak = torch.cuda.max_memory_allocated() if cuda else None
    reserved = torch.cuda.memory_reserved() if cuda else None
    shape = (height, width, 3)
    check_repeats(label, runs, shape)
    if field is not None:
        check_repeats("open-sphere-field", field_runs, shape)

    times = [r["seconds"] for r in runs]
    dt = statistics.median(times)
    measured_rays = runs[0]["rays"]
    iterations = runs[0]["iterations"]
    busy_ms = busy_share = None
    if cuda:
        dev, busy_iterations = device_busy(scene, spp, config)
        busy_ms = sum(ms for ms, _ in dev.values()) / busy_iterations
        busy_share = busy_ms / (dt * 1e3 / iterations)
        print(f"top {TOP_OPS} device operations of the profiled render (ms per iteration, "
              f"launches per iteration, name):")
        for name, (ms, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]:
            print(f"  {ms / busy_iterations:9.4f} {n / busy_iterations:7.2f}  {name[:120]}")
        sys.stdout.flush()

    samples = width * height * spp
    samples_per_s = samples / dt
    mrays_upper = samples * scene.ray_depth / dt / 1e6
    mrays_measured = measured_rays / dt / 1e6 if measured_rays else mrays_upper
    vs = (samples_per_s / BASELINE_SAMPLES_PER_S if label == "enclosed-atrium"
          else mrays_upper / BASELINE_MRAYS)  # bench.py's round-2 convention for the field
    field_sps = samples / statistics.median(r["seconds"] for r in field_runs) if field_runs else None
    print(f"render: median {dt:.4f}s of {reps}, {samples_per_s:.0f} pixel-samples/s, "
          f"{mrays_measured:.2f} measured Mrays/s", file=sys.stderr)
    return {
        "metric": (
            f"{label}-{n_tris // 1000}k-tris measured Mrays/s "
            f"({width}x{height}@{spp}spp, depth {scene.ray_depth}, {device.type}); "
            f"vs_baseline = pixel-samples/s over the reference CPU's 3.5e5 on enclosed Sponza"
        ),
        "value": mrays_measured,
        "unit": "Mrays/s",
        "vs_baseline": vs,
        "pixel_samples_per_s": samples_per_s,
        "mrays_depth8_upper_bound": mrays_upper,
        "measured_rays": measured_rays,
        "timing": f"median_of_{reps}" + ("_alternating" if field_runs else ""),
        "rep_times_s": times,
        "field_open_scene_samples_per_s": field_sps,
        "card": card_line() if cuda else None,
        "reps": reps,
        "render_s_median": dt,
        "render_s_spread": (max(times) - min(times)) / dt,
        "iterations": iterations,
        "loop": runs[0]["loop"],
        "device_busy_ms_per_iteration": busy_ms,
        "device_busy_share": busy_share,
        "peak_allocated_bytes": peak,
        "reserved_bytes": reserved,
    }


def main() -> int:
    try:
        device = select_device()
    except (RuntimeError, ValueError) as err:
        print(f"bench: {err}", file=sys.stderr)
        return 1
    try:
        line = bench(device)
    except Exception as err:  # noqa: BLE001 -- a failed bench still prints its line
        traceback.print_exc()
        print(f"bench render failed: {err}", file=sys.stderr)
        label = "open-sphere-field" if os.environ.get("BENCH_SCENE") == "field" else "enclosed-atrium"
        print(json.dumps({"metric": f"{label} Mrays/s (RENDER FAILED)", "value": 0.0,
                          "unit": "Mrays/s", "vs_baseline": 0.0}), flush=True)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
