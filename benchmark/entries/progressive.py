"""Progressive passes: the reference's frame rendered toward its sample
count in checkpointed passes, as a user runs the headline render.

Traffic parameters: ``width``, ``height``, ``spp`` (the frame's samples per
pixel), ``spp_per_pass`` (a checkpoint after each), ``check_pixels`` (the
pixels the reference checks, drawn from the seed).

Entry: ``tpu_pathtracer_torch.parallel.checkpoint.render_with_checkpoints``.
Its first pass is set-up (it builds the kernels in a fresh checkout and
captures the graph); the window opens at its end and closes at the first
pass boundary ``seconds`` later.  ``pixel_samples_per_s`` is the
pixel-samples of the window's passes over the time from the window's start
to the end of its last pass; a pass ends in its checkpoint, written after
its host copies.  With ``trace`` the window's first pass is profiled, and
the passes after the profiler has read out its trace, untraced and for
``seconds`` more, give the wall per iteration that the device's busy time
per iteration is held against.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from benchmark import correctness, scenes
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer


class _WindowClosed(Exception):
    pass


def check_pixels(traffic: dict, seed: int) -> np.ndarray:
    """The pixels the reference checks, drawn from the seed."""
    n = int(traffic["width"]) * int(traffic["height"])
    return np.sort(np.random.default_rng(seed).choice(n, size=int(traffic["check_pixels"]),
                                                      replace=False))


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.parallel.checkpoint import render_with_checkpoints
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    traffic, config = cell["traffic"], cell["config"]
    w, h = int(traffic["width"]), int(traffic["height"])
    out_dir = scenes.scene_dir(cell["name"])
    files = scenes.generate(config, out_dir)
    fields = scenes.render_fields(config, files)
    cfg = RenderConfig(**fields)
    scene = parse_gltf_scene(files["gltf"], w / h, cfg)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(w, h)).to(device)
    t_loaded = time.perf_counter()
    ckpt = os.path.join(out_dir, "progressive.npz")

    marks = []  # (host time, samples done, iterations) at each pass's end
    prof = None
    untraced_from = None  # with trace: the host time the profiler had stopped by

    def progress(done: int, _total: int) -> None:
        nonlocal prof, untraced_from
        marks.append((time.perf_counter(), done, pt.persistent_accum.iterations))
        if trace and len(marks) == 1:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        elif prof is not None and len(marks) == 2:
            prof.stop()  # reads out the trace: tens of seconds of host time
            untraced_from = time.perf_counter()
        if marks[-1][0] - (untraced_from or marks[0][0]) >= seconds:
            raise _WindowClosed

    try:
        render_with_checkpoints(scene, spp=int(traffic["spp"]), seed=seed, config=cfg,
                                checkpoint_path=ckpt, checkpoint_every=int(traffic["spp_per_pass"]),
                                resume=False, progress=progress)
    except _WindowClosed:
        pass
    if len(marks) < 2:
        raise RuntimeError("the window holds no pass: the frame's samples ran out in set-up")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del scene
    pt.clear_compiled_loops()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    (t_open, s_open, it_open), (t_close, s_close, it_close) = marks[0], marks[-1]
    samples = (s_close - s_open) * w * h
    ctx = dict(entry="progressive", iterations=it_close - it_open, pixel_samples=samples,
               passes=len(marks) - 1)
    if prof is not None:
        ctx["trace"] = dict(wall_s=marks[1][0] - marks[0][0], iterations=marks[1][2] - it_open,
                            prof=prof)
        ctx["untraced"] = dict(wall_s=t_close - untraced_from, iterations=it_close - marks[1][2])

    # The program's output: the checkpoint its loop wrote after the last pass.
    with np.load(ckpt) as z:
        accum, done = z["accum"], int(z["samples_done"])
    pixels = check_pixels(traffic, seed)
    t_ref = time.perf_counter()
    ref = ref_scene.load_scene(files["gltf"], w, h, fields).to(device)
    sums = tracer.pixel_sums(ref, fields, seed, pixels, s_close)
    print(f"progressive: loaded {t_loaded - t0:.3f} s after start, warm-up pass "
          f"{t_open - t_loaded:.3f} s, window {t_close - t_open:.3f} s in {len(marks) - 1} "
          f"passes ({', '.join(f'{b[0] - a[0]:.3f}' for a, b in zip(marks, marks[1:]))} s), reference {time.perf_counter() - t_ref:.3f} s for {pixels.shape[0]} pixels "
          f"x {s_close} samples", file=sys.stderr)
    numbers = {"pixels_off_share": correctness.off_share(accum[pixels], sums, s_close),
               "samples_done_gap": abs(done - s_close)}
    return dict(
        end_to_end={"pixel_samples_per_s": samples / (t_close - t_open), "setup_s": t_open - t0},
        ctx=ctx, numbers=numbers, attempted=len(marks) - 1, failed=0, memory_peak_bytes=peak,
    )
