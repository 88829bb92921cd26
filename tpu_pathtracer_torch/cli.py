"""Command line with the reference's argv contract (port of the glTF branch of
``tpu_pathtracer/cli.py:26-192``):

    python -m tpu_pathtracer_torch <scene.gltf|.glb> <width> <height> <samples> <out.ppm>

Loads the scene, renders it with the persistent wavefront, tone-maps and
writes a P6 PPM, and prints the ``RenderMetrics`` JSON on stderr.  Exits 1
with a message on stderr for too few arguments or a runtime error.

The device is CUDA; with no CUDA device the command exits 1 unless
``TPU_PATHTRACER_TORCH_DEVICE=cpu`` opts in to rendering on the CPU.  The
environment reaches the rest of ``RenderConfig``: ``TPU_PATHTRACER_JITTER``
/ ``TPU_PATHTRACER_LOWDISC`` (``sobol``) and the intersector's ``TPU_PT_*``
knobs (``TPU_PT_INTERSECT`` items | twopass | dense | bins,
``TPU_PT_CHEAP_RECHECK`` 0 | 1 | 2, ``TPU_PT_BINS_CAP``).
Homebrew ``.txt`` scenes are a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import torch

from tpu_pathtracer.config import DEFAULT_CONFIG, RenderConfig
from tpu_pathtracer.utils.metrics import RenderMetrics

from .models.pathtracer import render
from .scene.gltf import parse_gltf_scene
from .utils.image import image_shape_or_raise, quantize_u8, write_ppm


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
    device: torch.device,
    config: RenderConfig = DEFAULT_CONFIG,
):
    """Load + render a glTF scene file with seed 0 -> (HDR numpy image,
    RenderMetrics).  As in the JAX CLI, ``TPU_PATHTRACER_JITTER`` and
    ``TPU_PATHTRACER_LOWDISC`` override ``config.jitter`` and
    ``config.lowdisc`` (the 5-argument contract has no flag slots; the
    intersector's knobs come through ``TPU_PT_*``)."""
    for env, field in (("TPU_PATHTRACER_JITTER", "jitter"), ("TPU_PATHTRACER_LOWDISC", "lowdisc")):
        value = os.environ.get(env)
        if value:
            config = dataclasses.replace(config, **{field: value})
    if not (scene_path.endswith(".gltf") or scene_path.endswith(".glb")):
        if not os.path.exists(scene_path):
            raise FileNotFoundError(2, "No such file or directory", scene_path)
        raise NotImplementedError(
            f"{scene_path}: homebrew .txt scenes are not ported (ROADMAP: next "
            "slices, the CLI for homebrew and legacy)"
        )
    image_shape_or_raise(width, height)
    t0 = time.perf_counter()
    scene = parse_gltf_scene(scene_path, width / height, config)
    scene = dataclasses.replace(
        scene, camera=scene.camera.with_dims(width, height), samples=samples
    ).to(device)
    t_load = time.perf_counter() - t0
    t1 = time.perf_counter()
    run_stats: dict = {}
    hdr = render(scene, spp=samples, seed=0, config=config, progress=True,
                 stats=run_stats)
    t_render = time.perf_counter() - t1
    metrics = RenderMetrics(
        width=width,
        height=height,
        samples=samples,
        ray_depth=scene.ray_depth,
        load_seconds=t_load,
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
        hdr, metrics = render_scene_file(argv[1], width, height, samples, device)
        out_path = argv[5]
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)  # create_directories, main.cpp:41
        pixels = quantize_u8(torch.from_numpy(hdr)).numpy()
        if out_path.lower().endswith(".png"):
            from PIL import Image  # capability superset, as in the JAX CLI

            Image.fromarray(pixels).save(out_path)
        else:
            write_ppm(out_path, pixels)
        print(metrics.to_json(), file=sys.stderr)
        return 0
    except (RuntimeError, OSError, ValueError) as err:
        print(str(err), file=sys.stderr)
        return 1
