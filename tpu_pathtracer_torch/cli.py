"""Command line with the reference's argv contract (port of
``tpu_pathtracer/cli.py``):

    python -m tpu_pathtracer_torch <scene.gltf|.glb|.txt> <width> <height> <samples> <out.ppm>

Loads the scene (glTF, or a homebrew ``.txt`` scene rendered by the Whitted
or the Monte-Carlo integrator of ``models/legacy.py``), renders it,
tone-maps and writes a P6 PPM (PNG by extension), and prints the per-phase
seconds (``{"phases_seconds": ...}``) and the ``RenderMetrics`` JSON on
stderr.  Exits 1 with a message on stderr for too few arguments or a
runtime error.

The device is CUDA; with no CUDA device the command exits 1 unless
``TPU_PATHTRACER_TORCH_DEVICE=cpu`` opts in to rendering on the CPU.  The
environment reaches the rest of ``RenderConfig``: ``TPU_PATHTRACER_JITTER``
/ ``TPU_PATHTRACER_LOWDISC`` (``sobol``) and the intersector's ``TPU_PT_*``
knobs (``TPU_PT_INTERSECT`` items | twopass | dense | bins,
``TPU_PT_CHEAP_RECHECK`` 0 | 1 | 2, ``TPU_PT_BINS_CAP``).
``TPU_PATHTRACER_TRACE_DIR=<dir>`` writes a ``torch.profiler`` trace of the
load and render to ``<dir>/trace.json``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import torch

from .config import DEFAULT_CONFIG, RenderConfig
from .models.legacy import render_homebrew
from .models.pathtracer import render
from .scene.gltf import parse_gltf_scene
from .scene.homebrew import parse_homebrew_scene
from .utils.image import image_shape_or_raise, quantize_u8, write_ppm
from .utils.metrics import RenderMetrics
from .utils.profiling import PhaseTimer, device_trace, span


def _strtol(s: str) -> int:
    """std::strtol semantics: skip leading whitespace, parse the leading
    integer, 0 if none (src/main.cpp:23-25)."""
    i = 0
    while i < len(s) and s[i] in " \t\n\v\f\r":
        i += 1
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    return int(s[:j]) if j > i else 0


def select_device() -> torch.device:
    """CUDA, or the CPU when TPU_PATHTRACER_TORCH_DEVICE=cpu asks for it."""
    want = os.environ.get("TPU_PATHTRACER_TORCH_DEVICE", "cuda")
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"TPU_PATHTRACER_TORCH_DEVICE={want!r}: expected cuda | cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: set TPU_PATHTRACER_TORCH_DEVICE=cpu to render on the CPU"
        )
    # The dense sweep and the epilogues are float32 products: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def render_scene_file(
    scene_path: str,
    width: int,
    height: int,
    samples: int,
    config: RenderConfig = DEFAULT_CONFIG,
    seed: int = 0,
    progress: bool = True,
    timer=None,
    device: Optional[torch.device] = None,
):
    """Load + render any supported scene file -> (HDR numpy image,
    RenderMetrics), on ``device`` (None: ``select_device()``).  As in the
    JAX CLI, ``TPU_PATHTRACER_JITTER`` and ``TPU_PATHTRACER_LOWDISC``
    override ``config.jitter`` and ``config.lowdisc`` (the 5-argument
    contract has no flag slots; the intersector's knobs come through
    ``TPU_PT_*``).  A homebrew scene renders at ``samples`` spp when it is
    a Monte-Carlo scene and ``samples`` > 0, else at its own SAMPLES.
    ``load_seconds`` is the ``load`` span of the log (parse and upload)."""
    for env, field in (("TPU_PATHTRACER_JITTER", "jitter"), ("TPU_PATHTRACER_LOWDISC", "lowdisc")):
        value = os.environ.get(env)
        if value:
            config = dataclasses.replace(config, **{field: value})
    device = select_device() if device is None else device
    image_shape_or_raise(width, height)
    gltf = scene_path.endswith(".gltf") or scene_path.endswith(".glb")
    with span("load") as load:  # ``load_seconds``
        if gltf:
            scene = parse_gltf_scene(scene_path, width / height, config)
            scene = dataclasses.replace(
                scene, camera=scene.camera.with_dims(width, height), samples=samples
            ).to(device)
        else:
            scene = parse_homebrew_scene(scene_path)
            scene = dataclasses.replace(scene, camera=scene.camera.with_dims(width, height))
            if samples > 0 and scene.monte_carlo:
                scene = dataclasses.replace(scene, samples=samples)
            scene = scene.to(device)
    t1 = time.perf_counter()
    run_stats: dict = {}
    if gltf:
        hdr = render(scene, spp=samples, seed=seed, config=config, progress=progress,
                     timer=timer, stats=run_stats)
    else:
        hdr = render_homebrew(scene, seed=seed, config=config)
    t_render = time.perf_counter() - t1
    metrics = RenderMetrics(
        width=width,
        height=height,
        samples=samples,
        ray_depth=scene.ray_depth,
        load_seconds=load.seconds,
        render_seconds=t_render,
        measured_rays=run_stats.get("measured_rays"),
    )
    return hdr, metrics


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 6:
        print(f"Too few arguments: expected 6, got {len(argv) - 1}", file=sys.stderr)
        return 1
    try:
        width = _strtol(argv[2])
        height = _strtol(argv[3])
        samples = _strtol(argv[4])
        device = select_device()
        timer = PhaseTimer()
        with device_trace(os.environ.get("TPU_PATHTRACER_TRACE_DIR")):
            with timer.phase("load_render"):
                hdr, metrics = render_scene_file(argv[1], width, height, samples, timer=timer,
                                                 device=device)
        out_path = argv[5]
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)  # create_directories, main.cpp:41
        with timer.phase("tonemap_write"):
            pixels = quantize_u8(torch.from_numpy(hdr)).numpy()
            if out_path.lower().endswith(".png"):
                from PIL import Image  # capability superset, as in the JAX CLI

                Image.fromarray(pixels).save(out_path)
            else:
                write_ppm(out_path, pixels)
        timer.report()
        print(metrics.to_json(), file=sys.stderr)
        return 0
    except (RuntimeError, OSError, ValueError) as err:
        print(str(err), file=sys.stderr)
        return 1
