"""Re-renders of one loaded scene: one user moves the camera and renders
the frame again, as the ``Renderer`` is documented for (README: ``look_at``
then ``render(512, 512, spp=64)``), and looks at each frame before asking
for the next (a closed loop with one client).

Traffic parameters: ``width``, ``height``, ``spp``, ``warmup_frames``,
``orbit`` (``benchmark/traffic/orbit.py``), ``check_frames`` and
``check_pixels`` (the frames and, in each, the pixels the reference checks,
drawn from the seed), ``trace_frames`` (with ``trace``, the window's first
frames, profiled; the frames after the profiler has read out its trace,
untraced and for ``seconds`` more, give the wall per iteration that the
device's busy time per iteration is held against).

Entry: ``tpu_pathtracer_torch.renderer.Renderer``: ``look_at`` then
``render``, frames back to back.  A frame is timed on the host clock from
the ``look_at`` call to its host array; ``frame_ms_p50`` is the median of
every frame of the window.  Frame i renders with seed ``seed
+ i`` (mod 2^32).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import correctness, profiling, scenes
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer
from benchmark.traffic import orbit


def frame_seed(seed: int, i: int) -> int:
    return (seed + i) & 0xFFFFFFFF


def frame_pixels(traffic: dict, seed: int, i: int) -> np.ndarray:
    """The pixels of frame ``i`` that the reference may check."""
    n = int(traffic["width"]) * int(traffic["height"])
    return np.random.default_rng([seed, i]).integers(0, n, size=int(traffic["check_pixels"]))


def check_frames(traffic: dict, seed: int, n_frames: int) -> np.ndarray:
    """The frames of the window the reference checks, drawn from the seed."""
    k = min(int(traffic["check_frames"]), n_frames)
    return np.sort(np.random.default_rng(seed).choice(n_frames, size=k, replace=False))


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.renderer import Renderer

    traffic, config = cell["traffic"], cell["config"]
    w, h, spp = int(traffic["width"]), int(traffic["height"]), int(traffic["spp"])
    files = scenes.generate(config, scenes.scene_dir(cell["name"]))
    fields = scenes.render_fields(config, files)
    viewer = Renderer(files["gltf"], RenderConfig(**fields), aspect_ratio=w / h, device=device)
    pose = orbit.walk(traffic["orbit"], seed)

    def frame(i: int) -> np.ndarray:
        eye, target, fov = pose(i)
        viewer.look_at(eye, target, fov_x=fov)
        return viewer.render(w, h, spp, seed=frame_seed(seed, i))

    t_loaded = time.perf_counter()
    for i in range(-int(traffic["warmup_frames"]), 0):
        frame(i)

    times, kept = [], []
    prof = None
    n_trace = int(traffic["trace_frames"]) if trace else 0
    it_open = pt.persistent_accum.iterations
    t_open = t_window = time.perf_counter()
    while True:
        i = len(times)
        if i == 0 and n_trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        t = time.perf_counter()
        img = frame(i)
        t_end = time.perf_counter()
        times.append(t_end - t)
        pix = frame_pixels(traffic, seed, i)
        kept.append((pix, img.reshape(-1, 3)[pix].astype(np.float64) * spp))
        if prof is not None and i + 1 == n_trace:
            prof.stop()  # reads out the trace: seconds of host time
            trace_wall, it_traced = t_end - t_open, pt.persistent_accum.iterations - it_open
            t_end = t_window = time.perf_counter()  # the untraced frames' window starts here
        if t_end - t_window >= seconds and i + 1 >= n_trace:
            break
    iterations = pt.persistent_accum.iterations - it_open
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del viewer
    pt.clear_compiled_loops()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ctx = dict(entry="rerender", iterations=iterations, frames=len(times))
    if prof is not None:
        ctx["trace"] = dict(wall_s=trace_wall, iterations=it_traced, prof=prof)
        ctx["untraced"] = dict(wall_s=sum(times[n_trace:]), iterations=iterations - it_traced)

    t_ref = time.perf_counter()
    ref = ref_scene.load_scene(files["gltf"], w, h, fields).to(device)
    prog, refs = [], []
    for i in check_frames(traffic, seed, len(times)):
        eye, target, fov = pose(int(i))
        ref.camera = ref_scene.look_at_camera(eye, target, fov, w, h).to(device)
        pix, values = kept[i]
        prog.append(values)
        refs.append(tracer.pixel_sums(ref, fields, frame_seed(seed, int(i)), pix, spp))
    print(f"rerender: loaded {t_loaded - t0:.3f} s after start, warm-up {t_open - t_loaded:.3f} s, "
          f"{len(times)} frames in {sum(times):.3f} s, reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    numbers = {"pixels_off_share": correctness.off_share(np.concatenate(prog),
                                                         np.concatenate(refs), spp)}
    return dict(
        end_to_end={"frame_ms_p50": profiling.percentile(times, 50) * 1e3,
                    "setup_s": t_open - t0},
        ctx=ctx, numbers=numbers, attempted=len(times), failed=0, memory_peak_bytes=peak,
    )
