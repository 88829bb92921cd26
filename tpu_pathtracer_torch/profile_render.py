#!/usr/bin/env python3
"""Where the time of a render goes on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 -m tpu_pathtracer_torch.profile_render

Each case is a scene made by ``scene/fixtures.py`` as ``chip_smoke.py``
makes it, rendered at 512x512 by ``models.pathtracer.render`` after one
warm-up render at 1 spp, three times:

- timed: at 16 spp with nothing added: seconds, iterations of the
  wavefront loop (``bounce_step`` calls) and launches of kernels B1-B7;
- synced: at 16 spp with ``torch.cuda.synchronize()`` around the sort
  key, the intersector (``closest_hit_chunks``) and the many-light pdf
  (``light_pdf_sum_chunks``): host milliseconds per iteration of each, and
  of the rest of the iteration;
- profiled: at 4 spp under ``torch.profiler`` (CPU and CUDA):
  the device's busy milliseconds per iteration (the sum of its kernel and
  memory-operation times: the render runs on one stream) against the wall
  of this render and of the timed one, the kernels that take the most
  device time, and the activity kernel (B1) and the intersector's Woop
  kernel (B2 or B6) by their place among an iteration's launches.

Prints one JSON line per case, then the card's ``nvidia-smi`` name, power
limit, SM clock and power draw.
"""

import dataclasses
import json
import os
import subprocess
import tempfile
import time

import torch

W = H = 512
SPP, PROFILE_SPP = 16, 4
CASES = ("atrium", "atrium_twopass", "lit_atrium", "env_field")


def _scene_and_config(case, tmp):
    from .config import IntersectTuning, RenderConfig
    from .scene import fixtures, gltf

    try:
        import PIL  # noqa: F401
        textured = True
    except ImportError:
        textured = False
    config = RenderConfig()
    if case in ("atrium", "atrium_twopass"):
        path = fixtures.make_atrium_gltf(os.path.join(tmp, case, "a.gltf"), detail=2,
                                         textured=textured)
        if case == "atrium_twopass":
            config = RenderConfig(tuning=IntersectTuning(mode="twopass"))
    elif case == "lit_atrium":
        path = fixtures.make_lit_banner_atrium_gltf(os.path.join(tmp, case, "a.gltf"), detail=2,
                                                    textured=textured)
    elif case == "env_field":
        path = fixtures.make_sphere_field_gltf(os.path.join(tmp, case, "f.gltf"), n_spheres=64,
                                               subdiv=3, textured=textured)
        env = fixtures.make_env_hdr(os.path.join(tmp, case, "env.hdr"))
        config = RenderConfig(use_env_map=True, env_map_path=env, add_light_triangle=True)
    else:
        raise ValueError(f"unknown case {case!r}: expected one of {', '.join(CASES)}")
    scene = gltf.parse_gltf_scene(path, W / H, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(W, H)).to("cuda")
    return scene, config, textured


def _wrappers():
    from .ops import chunk_intersect as ci

    return {"b1": ci.tile_chunk_activity, "b2": ci.run_items, "b3": ci.run_light_pdf,
            "b4": ci.nearest_box_ids, "b5": ci.run_dense, "b6": ci.run_slots,
            "b7": ci.ray_group_bools}


class _Patched:
    """Counts ``bounce_step`` calls and, when ``sync`` is set, accumulates the
    synchronised host time of the sort key, the intersector and the
    many-light pdf.  Restores the module's functions on exit."""

    def __init__(self, sync):
        from .models import pathtracer as pt

        self.pt, self.sync = pt, sync
        self.iterations = 0
        self.ms = {"sort_key": 0.0, "intersector": 0.0, "light_pdf": 0.0}

    def _timed(self, name, fn):
        def run(*a, **kw):
            if not self.sync:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def __enter__(self):
        pt = self.pt
        self.saved = {k: getattr(pt, k) for k in
                      ("bounce_step", "closest_hit_chunks", "light_pdf_sum_chunks", "_make_sort_key")}
        step, make_key = self.saved["bounce_step"], self.saved["_make_sort_key"]

        def bounce_step(*a, **kw):
            self.iterations += 1
            return step(*a, **kw)

        pt.bounce_step = bounce_step
        pt.closest_hit_chunks = self._timed("intersector", self.saved["closest_hit_chunks"])
        pt.light_pdf_sum_chunks = self._timed("light_pdf", self.saved["light_pdf_sum_chunks"])
        pt._make_sort_key = lambda *a, **kw: self._timed("sort_key", make_key(*a, **kw))
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.pt, k, v)


def _render(scene, config, spp, sync=False):
    from .models import pathtracer as pt

    for fn in _wrappers().values():
        fn.launches = 0
    with _Patched(sync) as patch:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.render(scene, spp=spp, seed=0, config=config)
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _wrappers().items()}
    return seconds, patch, launches


def _device_times(prof):
    """{kernel or memory operation: (device ms, count)} from a profile."""
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            ms = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0)) / 1e3
            if ms > 0:
                out[ev.key] = (ms, ev.count)
    return out


def _per_pass(prof, iterations):
    """Mean device ms of B1 (``activity_kernel``) and of the intersector's
    Woop kernel (B2 ``items_kernel`` or B6 ``slots_kernel``) by their place
    among an iteration's launches.  With the default ladder the Woop kernel
    runs near pass 1, near pass 2 and the residual; B1 runs the super-block
    gate, the initial pass and the recheck after each near pass (then the
    light clusters' boxes on a many-light scene)."""
    out = {}
    for key in ("activity_kernel", "items_kernel", "slots_kernel"):
        evs = sorted((e for e in prof.events()
                      if key in e.name and str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % iterations == 0:
            m = len(evs) // iterations
            ms = [e.time_range.elapsed_us() / 1e3 for e in evs]
            out[key] = [sum(ms[k::m]) / iterations for k in range(m)]
    return out


def profile_case(case, tmp, spp=SPP, profile_spp=PROFILE_SPP):
    from torch.profiler import ProfilerActivity, profile

    scene, config, textured = _scene_and_config(case, tmp)
    _render(scene, config, 1)  # warm-up: builds and loads the kernels
    seconds, patch, launches = _render(scene, config, spp)
    iters = patch.iterations
    s_sync, synced, _ = _render(scene, config, spp, sync=True)
    per_it = {k: v / synced.iterations for k, v in synced.ms.items()}
    wall_sync = s_sync * 1e3 / synced.iterations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s_prof, profiled, _ = _render(scene, config, profile_spp)
    dev = _device_times(prof)
    busy = sum(ms for ms, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:12]
    n = profiled.iterations
    return {
        "case": case, "textured": textured, "spp": spp,
        "seconds_render": seconds, "iterations": iters, "ms_per_iteration": seconds * 1e3 / iters,
        "launches": launches,
        "synced": {"seconds_render": s_sync, "ms_per_iteration": wall_sync,
                   **{f"{k}_ms_per_iteration": v for k, v in per_it.items()},
                   "rest_ms_per_iteration": wall_sync - sum(per_it.values())},
        "profiled": {
            "spp": profile_spp, "iterations": n, "seconds_render": s_prof,
            "wall_ms_per_iteration": s_prof * 1e3 / n,
            "device_busy_ms_per_iteration": busy / n if dev else None,
            "device_busy_share": busy / (s_prof * 1e3) if dev else None,
            # The profiler slows the host: busy per iteration over the
            # timed render's wall per iteration is the share without it.
            "device_busy_share_of_timed": busy / n / (seconds * 1e3 / iters) if dev else None,
            "device_ops_per_iteration": sum(c for _, c in dev.values()) / n if dev else None,
            "kernel_ms_by_pass": _per_pass(prof, n),
            "top": [{"name": k[:120], "ms_per_iteration": ms / n, "share_of_busy": ms / busy,
                     "count": c, "ms_per_call": ms / c} for k, (ms, c) in top],
        },
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: no CUDA device")
    from .cli import select_device
    from .kernels import build

    select_device()
    build()
    with tempfile.TemporaryDirectory() as tmp:
        for case in CASES:
            print(json.dumps(profile_case(case, tmp)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
