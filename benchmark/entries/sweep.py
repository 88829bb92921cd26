"""A render sweep: whole frames rendered back to back, each as the command
line renders a scene file (load, render, tone-map, write the image), as a
user times a batch of scenes one after another.

Traffic parameters: ``width``, ``height``, ``spp`` (each render's samples
per pixel), ``warmup_renders`` (set-up: the first builds the kernels in a
fresh checkout and captures the graph), ``check_renders`` and
``check_pixels`` (the renders of the window and, in each, the pixels the
reference checks, drawn from the seed), ``trace_tiles`` and
``trace_every`` (with ``trace``, the engine calls of the window's first
render that are profiled: every ``trace_every``-th from the first, each in
a profiler run of its own, ``trace_tiles`` of them; a render's calls go
chunk by chunk and pass by pass, so with ``trace_every`` its passes per
chunk they are each chunk's first pass, spread over the whole frame; the
renders after that one, untraced and for ``seconds`` more, give the wall
per iteration that the device's busy time per iteration is held against).

Entry: ``tpu_pathtracer_torch.cli.render_scene_file`` on the generated
scene, then the image written as the command line writes it.  The window
opens after the warm-up and closes at the first render's end ``seconds``
later; ``pixel_samples_per_s`` is the pixel-samples of the window's
renders over the time from the window's start to the end of its last
render.  Render i renders with seed ``seed + i`` (mod 2^32).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from benchmark import correctness, scenes
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer


def render_seed(seed: int, i: int) -> int:
    return (seed + i) & 0xFFFFFFFF


def render_pixels(traffic: dict, seed: int, i: int) -> np.ndarray:
    """The pixels of render ``i`` that the reference may check."""
    n = int(traffic["width"]) * int(traffic["height"])
    return np.random.default_rng([seed, i]).choice(n, size=int(traffic["check_pixels"]),
                                                   replace=False)


def check_renders(traffic: dict, seed: int, n_renders: int) -> np.ndarray:
    """The renders of the window the reference checks, drawn from the seed."""
    k = min(int(traffic["check_renders"]), n_renders)
    return np.sort(np.random.default_rng(seed).choice(n_renders, size=k, replace=False))


class _TileTrace:
    """A ``timer`` for ``render``: profiles every ``every``-th engine call
    ("dispatch" phase) from the first, ``tiles`` of them, each in a profiler
    run of its own, and adds up their wall and the persistent loop's
    iterations in them.  Every other phase passes through untouched."""

    def __init__(self, tiles: int, every: int, counter):
        self.tiles, self.every, self.counter = tiles, every, counter
        self.seen, self.prof, self.wall_s, self.iterations = 0, [], 0.0, 0

    @contextlib.contextmanager
    def phase(self, name: str):
        on = name == "dispatch" and self.seen % self.every == 0 and len(self.prof) < self.tiles
        if on:
            self.prof.append(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]))
            self.prof[-1].start()
            t, it = time.perf_counter(), self.counter()
        yield
        if name == "dispatch":
            self.seen += 1
        if on:
            self.wall_s += time.perf_counter() - t
            self.iterations += self.counter() - it
            self.prof[-1].stop()  # reads out the trace: host time, outside the wall above


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    from tpu_pathtracer_torch import cli
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.utils.image import quantize_u8, write_ppm

    traffic, config = cell["traffic"], cell["config"]
    w, h, spp = int(traffic["width"]), int(traffic["height"]), int(traffic["spp"])
    out_dir = scenes.scene_dir(cell["name"])
    files = scenes.generate(config, out_dir)
    fields = scenes.render_fields(config, files)
    cfg = RenderConfig(**fields)
    image = os.path.join(out_dir, "render.ppm")
    if device.type == "cuda":
        cli.select_device()  # the command line's device settings (no TF32)
    count = lambda: pt.persistent_accum.iterations  # noqa: E731

    def render(i: int, timer=None):
        hdr, metrics = cli.render_scene_file(files["gltf"], w, h, spp, config=cfg,
                                             seed=render_seed(seed, i), progress=False,
                                             timer=timer, device=device)
        write_ppm(image, quantize_u8(torch.from_numpy(hdr)).numpy())
        return hdr, metrics

    t_made = time.perf_counter()
    for i in range(-int(traffic["warmup_renders"]), 0):
        render(i)

    n_trace = int(traffic["trace_tiles"]) if trace else 0
    tracer_timer = _TileTrace(n_trace, int(traffic["trace_every"]), count) if n_trace else None
    ends, kept, load_s = [], [], []
    it_open = count()
    t_open = t_window = time.perf_counter()
    it_window = it_open
    while True:
        i = len(ends)
        hdr, metrics = render(i, tracer_timer if i == 0 else None)
        ends.append(time.perf_counter())
        load_s.append(metrics.load_seconds)
        pix = render_pixels(traffic, seed, i)
        kept.append((pix, hdr.reshape(-1, 3)[pix].astype(np.float64) * spp))
        if i == 0 and tracer_timer is not None:
            if len(tracer_timer.prof) < n_trace:
                raise RuntimeError(f"a render holds {tracer_timer.seen} engine calls, too few "
                                   f"for trace_tiles = {n_trace} every {tracer_timer.every}")
            t_window, it_window = ends[-1], count()  # the untraced renders' window
        if ends[-1] - t_window >= seconds and (not n_trace or i >= 1):
            break
    iterations = count() - it_open
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    pt.clear_compiled_loops()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    samples = len(ends) * w * h * spp
    ctx = dict(entry="sweep", iterations=iterations, pixel_samples=samples, renders=len(ends),
               load_s=load_s)
    if tracer_timer is not None:
        ctx["trace"] = dict(wall_s=tracer_timer.wall_s, iterations=tracer_timer.iterations,
                            prof=tracer_timer.prof)
        ctx["untraced"] = dict(wall_s=ends[-1] - t_window, iterations=it_open + iterations
                               - it_window)

    t_ref = time.perf_counter()
    ref = ref_scene.load_scene(files["gltf"], w, h, fields).to(device)
    prog, refs = [], []
    for i in check_renders(traffic, seed, len(ends)):
        pix, values = kept[i]
        prog.append(values)
        refs.append(tracer.pixel_sums(ref, fields, render_seed(seed, int(i)), pix, spp))
    print(f"sweep: scene written {t_made - t0:.3f} s after start, warm-up "
          f"{t_open - t_made:.3f} s, {len(ends)} renders in {ends[-1] - t_open:.3f} s "
          f"({', '.join(f'{b - a:.3f}' for a, b in zip([t_open] + ends, ends))} s; loads "
          f"{', '.join(f'{s:.3f}' for s in load_s)} s), reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    numbers = {"pixels_off_share": correctness.off_share(np.concatenate(prog),
                                                         np.concatenate(refs), spp)}
    return dict(
        end_to_end={"pixel_samples_per_s": samples / (ends[-1] - t_open), "setup_s": t_open - t0},
        ctx=ctx, numbers=numbers, attempted=len(ends), failed=0, memory_peak_bytes=peak,
    )
