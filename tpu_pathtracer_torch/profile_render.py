#!/usr/bin/env python3
"""Where the time of a render goes on one CUDA card, eager loop against graph.

Run from the repository root on a machine with one CUDA card:

    python3 -m tpu_pathtracer_torch.profile_render [case ...]

(every case of ``CASES`` and ``KERNEL_CASES`` when none is named).  Each
case is a scene made by ``scene/fixtures.py`` as ``chip_smoke.py`` makes
it, rendered at 512x512 by ``models.pathtracer.render`` after one warm-up
render at 1 spp with each loop.  A case of ``CASES``:

- timed: at 16 spp with the persistent engine's per-iteration "eager" loop
  and its CUDA graph, in turns (eager, graph, graph, eager): seconds,
  iterations run, and ms per useful iteration (the eager loop's count);
- stages: at 4 spp with the graph, under ``torch.profiler``: each
  replay's device operations (those of its ``cudaGraphLaunch``'s
  correlation id, by start) given one by one to the nodes of its graph's
  stage map (``utils.profiling.stage_map``, recorded at the capture), as
  operations and device ms per iteration by stage path, with the replays
  whose operation count equals the map's node count;
- busy: the device's busy ms per iteration (the sum of its kernel and
  memory-operation times: the render runs on one stream) of the eager and
  the graph loop at 4 spp under ``torch.profiler``, against the timed
  renders' ms per iteration; the kernels that take the most device time;
  and each hand-written kernel by its place among an iteration's launches;
- in_graph: each hand-written kernel's launches per iteration and mean
  device microseconds per launch inside the graph's replays (the graph
  profile above).

A case of ``KERNEL_CASES`` (the atrium under the sort key or intersector
mode whose kernel no case above runs: B4 "target", B5 "dense", B7 "bins")
only profiles its loop at 4 spp for ``in_graph`` and the device's busy ms
and operations per iteration ("bins" keeps the eager loop, so its figures
are per launch in that loop).

Prints one JSON line per case, then the card's ``nvidia-smi`` name, power
limit, SM clock and power draw.
"""

import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

W = H = 512
SPP, PROFILE_SPP = 16, 4
CASES = ("atrium", "atrium_twopass", "lit_atrium", "env_field")
KERNEL_CASES = ("atrium_target", "atrium_dense", "atrium_bins")
# The hand-written kernels, by the name their launches carry on the device.
KERNELS = {
    "activity_kernel": "B1", "items_kernel": "B2", "light_pdf_kernel": "B3",
    "nearest_kernel": "B4", "dense_kernel": "B5", "slots_kernel": "B6",
    "ray_group_kernel": "B7", "uniforms_kernel": "threefry",
    "light_pdf_flat_kernel": "K1", "shade_gather_kernel": "K2",
    "shade_sample_kernel": "K3", "shade_finish_kernel": "K4", "worklist_kernel": "K5",
}


def _scene_and_config(case, tmp):
    from .config import IntersectTuning, RenderConfig
    from .scene import fixtures, gltf

    try:
        import PIL  # noqa: F401
        textured = True
    except ImportError:
        textured = False
    config = RenderConfig()
    modes = {"atrium_twopass": RenderConfig(tuning=IntersectTuning(mode="twopass")),
             "atrium_target": RenderConfig(sort_key="target"),
             "atrium_dense": RenderConfig(tuning=IntersectTuning(mode="dense")),
             "atrium_bins": RenderConfig(tuning=IntersectTuning(mode="bins"))}
    if case == "atrium" or case in modes:
        path = fixtures.make_atrium_gltf(os.path.join(tmp, case, "a.gltf"), detail=2,
                                         textured=textured)
        config = modes.get(case, config)
    elif case == "lit_atrium":
        path = fixtures.make_lit_banner_atrium_gltf(os.path.join(tmp, case, "a.gltf"), detail=2,
                                                    textured=textured)
    elif case == "env_field":
        path = fixtures.make_sphere_field_gltf(os.path.join(tmp, case, "f.gltf"), n_spheres=64,
                                               subdiv=3, textured=textured)
        env = fixtures.make_env_hdr(os.path.join(tmp, case, "env.hdr"))
        config = RenderConfig(use_env_map=True, env_map_path=env, add_light_triangle=True)
    else:
        raise ValueError(f"unknown case {case!r}: expected one of "
                         f"{', '.join(CASES + KERNEL_CASES)}")
    scene = gltf.parse_gltf_scene(path, W / H, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(W, H)).to("cuda")
    return scene, config, textured


def _render(scene, config, spp, loop):
    """(seconds, iterations run, launches by kernel) of one render."""
    from . import kernels
    from .models import pathtracer as pt

    kernels.launches.clear()
    pt.persistent_accum.iterations = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.render(scene, spp=spp, seed=0, config=config, eager=loop == "eager")
    seconds = time.perf_counter() - t0
    return seconds, pt.persistent_accum.iterations, dict(kernels.launches)


def _device_times(prof):
    """{kernel or memory operation: (device ms, count)} from a profile."""
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            ms = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0)) / 1e3
            if ms > 0:
                out[ev.key] = (ms, ev.count)
    return out


def _stage_split(prof, iterations):
    """({stage path: [device operations per iteration, their device ms per
    iteration]}, [replays matched, replays seen]) of the graph replays in a
    profile: a replay's device operations (those of its ``cudaGraphLaunch``'s
    correlation id), in order of start, are the nodes of the stage map of
    the engine call's graph around the launch; a replay whose operation
    count differs from the map's node count is left out."""
    from .utils import profiling

    maps = {m.graph: m for m in profiling.stage_maps()}
    calls = [s for s in profiling.spans() if s.name == "engine_call" and "graph" in s.counts]
    ops, launches = {}, []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            ops.setdefault(ev.correlation_id(), []).append((ev.start_ns(), ev.duration_ns()))
        elif ev.name() == "cudaGraphLaunch":
            launches.append((ev.start_ns(), ev.correlation_id()))
    out, matched = {}, 0
    for t, cid in launches:
        call = next((c for c in calls if c.start_ns <= t <= (c.end_ns or t)), None)
        smap = maps.get(call.counts["graph"]) if call else None
        replay = sorted(ops.get(cid, ()))
        if smap is None or len(replay) != smap.nodes:
            continue
        matched += 1
        for path, first, last in smap.rows:
            row = out.setdefault(path, [0, 0.0])
            row[0] += last - first + 1
            row[1] += sum(d for _, d in replay[first:last + 1]) / 1e6
    return ({path: [n / iterations, ms / iterations] for path, (n, ms) in out.items()},
            [matched, len(launches)])


def _per_pass(prof, iterations):
    """Mean device ms of each hand-written kernel by its place among an
    iteration's launches.  With the default ladder the Woop kernel (B2 or
    B6) runs near pass 1, near pass 2 and the residual; B1 runs the
    super-block gate, the initial pass and the recheck after each near pass
    (then the light clusters' boxes on a many-light scene); the threefry
    kernel runs the bounce draws, then the jitter of the lanes it
    regenerates."""
    out = {}
    for key in KERNELS:
        evs = sorted((e for e in prof.events()
                      if key in e.name and str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % iterations == 0:
            m = len(evs) // iterations
            ms = [e.time_range.elapsed_us() / 1e3 for e in evs]
            out[key] = [sum(ms[k::m]) / iterations for k in range(m)]
    return out


def _in_graph(dev, iterations):
    """{kernel: launches per iteration, mean device us per launch} of each
    hand-written kernel in a profile's ``_device_times``, a template
    instance apart from the others (the threefry kernel's ``<10>`` bounce
    draws and ``<2>`` camera jitter)."""
    out = {}
    for key, label in KERNELS.items():
        for name, (ms, n) in sorted(dev.items()):
            if key in name:
                instance = name.split(key, 1)[1].split("(", 1)[0]
                row = out.setdefault(f"{label} {key}{instance}", [0.0, 0])
                row[0], row[1] = row[0] + ms, row[1] + n
    return {k: {"launches_per_iteration": n / iterations, "us_per_launch": ms * 1e3 / n}
            for k, (ms, n) in out.items()}


def _profiled(scene, config, spp, loop):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seconds, iterations, _ = _render(scene, config, spp, loop)
    return prof, seconds, iterations


def profile_case(case, tmp, spp=SPP, profile_spp=PROFILE_SPP):
    scene, config, textured = _scene_and_config(case, tmp)
    for loop in ("eager", "graph"):  # builds the kernels, captures the graph
        _render(scene, config, 1, loop)
    timed = {"eager": [], "graph": []}
    launches = {}
    for loop in ("eager", "graph", "graph", "eager"):
        seconds, iterations, launches[loop] = _render(scene, config, spp, loop)
        timed[loop].append((seconds, iterations))
    useful = timed["eager"][0][1]

    _profiled(scene, config, 1, "graph")  # the profiler's first cycle
    profiles = {loop: _profiled(scene, config, profile_spp, loop) for loop in ("eager", "graph")}
    graph_prof, _, graph_iterations = profiles["graph"]
    split, replays = _stage_split(graph_prof, graph_iterations)
    stages = {"iterations": graph_iterations, "replays_matched_of_seen": replays,
              "by_stage": split}
    busy = {}
    for loop in ("eager", "graph"):
        prof, _, iterations = profiles[loop]
        dev = _device_times(prof)
        ms = sum(m for m, _ in dev.values())
        timed_it = sum(s for s, _ in timed[loop]) * 1e3 / sum(i for _, i in timed[loop])
        busy[loop] = {
            "iterations": iterations, "kernels_seen": len(dev),
            "busy_ms_per_iteration": ms / iterations if dev else None,
            "device_ops_per_iteration": sum(c for _, c in dev.values()) / iterations if dev else None,
            "timed_ms_per_iteration": timed_it,
            "busy_share_of_timed": ms / iterations / timed_it if dev else None,
        }
        if loop == "eager":
            top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:12]
            by_pass = _per_pass(prof, iterations)
        else:
            in_graph = _in_graph(dev, iterations)
            graph_by_pass = _per_pass(prof, iterations)
    eager_busy = busy["eager"]["busy_ms_per_iteration"]
    return {
        "case": case, "textured": textured, "spp": spp, "useful_iterations": useful,
        "timed": {loop: [{"seconds": s, "iterations": i, "ms_per_useful_iteration": s * 1e3 / useful}
                         for s, i in runs] for loop, runs in timed.items()},
        "launches": launches,
        "stages": stages,
        "busy": busy,
        "kernel_ms_by_pass": by_pass,
        "in_graph": in_graph,
        "kernel_ms_by_pass_in_graph": graph_by_pass,
        "top": [{"name": k[:120], "ms_per_iteration": ms / busy["eager"]["iterations"],
                 "share_of_busy": ms / (eager_busy * busy["eager"]["iterations"]),
                 "count": c, "ms_per_call": ms / c} for k, (ms, c) in top],
    }


def kernel_case(case, tmp, profile_spp=PROFILE_SPP):
    """``in_graph`` alone: the case's loop (the graph, or the eager loop
    under "bins") profiled at ``profile_spp`` after a warm-up."""
    scene, config, textured = _scene_and_config(case, tmp)
    loop = "eager" if config.tuning.mode == "bins" else "graph"
    _render(scene, config, 1, loop)
    prof, seconds, iterations = _profiled(scene, config, profile_spp, loop)
    dev = _device_times(prof)
    return {"case": case, "textured": textured, "loop": loop, "spp": profile_spp,
            "iterations": iterations, "seconds": seconds,
            "busy_ms_per_iteration": sum(ms for ms, _ in dev.values()) / iterations,
            "device_ops_per_iteration": sum(c for _, c in dev.values()) / iterations,
            "in_graph": _in_graph(dev, iterations)}


def main(argv=()):
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: no CUDA device")
    from .cli import select_device
    from .kernels import build
    from .models.pathtracer import clear_compiled_loops
    from .utils.profiling import card_line

    select_device()
    build()
    with tempfile.TemporaryDirectory() as tmp:
        for case in argv or CASES + KERNEL_CASES:
            run = kernel_case if case in KERNEL_CASES else profile_case
            print(json.dumps(run(case, tmp)), flush=True)
            clear_compiled_loops()
            torch.cuda.empty_cache()
    print(card_line(("name", "power.limit", "clocks.sm", "power.draw")), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
