#!/usr/bin/env python3
"""The headline workload on one CUDA card: the enclosed atrium at 1000x1000
@ 1000 spp, checkpointed and supervised (the port of the repository's
``scripts/run_headline.py``).  Run from the repository root:

    python -m tpu_pathtracer_torch.run_headline

The scene is ``scene.fixtures.make_atrium_gltf(detail=2)`` (~218k textured
triangles, walled and roofed, lit only through its skylights), rendered by
``parallel.checkpoint.render_with_checkpoints`` at seed 0 with 65,536-ray
wavefronts, saving the accumulator every ``HEADLINE_CKPT_EVERY`` samples.
A run resumes from a checkpoint of the same scene, config, size and seed,
sample for sample (the draws are a function of pixel, sample and depth),
and either package resumes the other's file.  A progress line
(``spp_done``, ``spp_total``, ``elapsed_s``) follows each saved pass; at
the end the P6 image is written and one JSON line (``workload``,
``wall_s_this_run``, ``spp_rendered_this_run``, ``samples_per_s``,
``resumed_from_spp``, ``out``, ``card``: the ``nvidia-smi`` name and power
limit, or "cpu") is appended to the ledger and printed last.

With ``HEADLINE_SUPERVISE`` set, the process supervises the render in a
child process instead: a child that exits non-zero is started again, and
one whose checkpoint has not changed for ``HEADLINE_STALL_S`` seconds is
killed and started again, each new child resuming from the checkpoint, up
to ``HEADLINE_MAX_RESTARTS`` times; then it gives up with exit code 1.
Each event is a JSON line with the key ``supervisor``.

Environment (the JAX script's variables, with its defaults except the
paths): ``HEADLINE_SPP`` (1000), ``HEADLINE_SIZE`` (1000, W = H),
``HEADLINE_CKPT`` (``build/headline/headline_ck.npz``),
``HEADLINE_CKPT_EVERY`` (50), ``HEADLINE_SPP_PER_PASS`` (16),
``BENCH_RPB`` (65,536 rays per wavefront), ``HEADLINE_OUT``
(``build/headline/atrium_1000x1000_1000spp.ppm``), ``HEADLINE_LEDGER``
(``build/headline/headline.jsonl``), ``HEADLINE_SUPERVISE``,
``HEADLINE_STALL_S`` (1200) and ``HEADLINE_MAX_RESTARTS`` (20).  The
default paths are under the repository's git-ignored ``build/``.  With no
CUDA device the command exits 1, unless ``TPU_PATHTRACER_TORCH_DEVICE=cpu``
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

from .cli import select_device
from .config import RenderConfig
from .parallel.checkpoint import RenderState, render_with_checkpoints, scene_fingerprint
from .scene import fixtures
from .scene.gltf import parse_gltf_scene
from .utils.image import quantize_u8, write_ppm
from .utils.profiling import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "headline")
# The supervisor's pause between two looks at the checkpoint, and before
# starting a child again.
POLL_S = 20.0
RESTART_PAUSE_S = 30.0


def settings() -> dict:
    """The run the environment asks for (see the module's docstring)."""
    env = os.environ
    return dict(
        spp=int(env.get("HEADLINE_SPP", "1000")),
        size=int(env.get("HEADLINE_SIZE", "1000")),
        ckpt=env.get("HEADLINE_CKPT", os.path.join(OUT_DIR, "headline_ck.npz")),
        every=int(env.get("HEADLINE_CKPT_EVERY", "50")),
        out=env.get("HEADLINE_OUT", os.path.join(OUT_DIR, "atrium_1000x1000_1000spp.ppm")),
        ledger=env.get("HEADLINE_LEDGER", os.path.join(OUT_DIR, "headline.jsonl")),
        config=RenderConfig(
            rays_per_batch=int(env.get("BENCH_RPB", 1 << 16)),
            spp_per_pass=int(env.get("HEADLINE_SPP_PER_PASS", "16")),
        ),
    )


def resume_offset(path: str, size: int, spp: int, fingerprint: int) -> Optional[int]:
    """The samples a checkpoint at ``path`` already holds for this run, read
    before rendering with the checks ``render_with_checkpoints`` makes:
    size, seed 0 and a fingerprint of 0 (a legacy file) or ``fingerprint``;
    clamped to ``spp``.  0 for no file or another run's file; None for a
    file that cannot be read."""
    if not os.path.exists(path):
        return 0
    try:
        st = RenderState.load(path)
    except Exception:  # noqa: BLE001 -- any unreadable file
        return None
    if (st.width, st.height, st.seed) == (size, size, 0) and st.fingerprint in (0, fingerprint):
        return min(st.samples_done, spp)
    return 0


def main() -> int:
    try:
        device = select_device()
    except (RuntimeError, ValueError) as err:
        print(f"run_headline: {err}", file=sys.stderr)
        return 1
    s = settings()
    spp, size, ck, config = s["spp"], s["size"], s["ckpt"], s["config"]
    with tempfile.TemporaryDirectory(prefix="headline_") as tmp:
        path = fixtures.make_atrium_gltf(os.path.join(tmp, "atrium.gltf"), detail=2)
        scene = parse_gltf_scene(path, 1.0, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(size, size))
    n_tris = int(scene.valid.sum())
    print(f"headline: {n_tris} tris, {size}x{size} @ {spp} spp on {device}", flush=True)

    # Read before rendering: the first progress line comes after the first
    # pass, already folded in.  A file that cannot be read is started over.
    offset = resume_offset(ck, size, spp, scene_fingerprint(scene, config))
    resumed_from = offset or 0
    scene = scene.to(device)
    t0 = time.time()

    def progress(done, total):
        print(json.dumps({"spp_done": done, "spp_total": total,
                          "elapsed_s": round(time.time() - t0, 1)}), flush=True)

    img = render_with_checkpoints(scene, spp=spp, seed=0, config=config, checkpoint_path=ck,
                                  checkpoint_every=s["every"], resume=offset is not None,
                                  progress=progress)
    dt = time.time() - t0
    fresh_spp = spp - resumed_from
    out = s["out"]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    write_ppm(out, quantize_u8(torch.from_numpy(img)).numpy())
    ledger = {
        "workload": f"enclosed-atrium {n_tris} tris {size}x{size}@{spp}spp",
        "wall_s_this_run": dt,
        "spp_rendered_this_run": fresh_spp,
        "samples_per_s": size * size * fresh_spp / dt if fresh_spp else None,
        "resumed_from_spp": resumed_from,
        "out": out,
        "card": card_line() if device.type == "cuda" else "cpu",
    }
    os.makedirs(os.path.dirname(os.path.abspath(s["ledger"])), exist_ok=True)
    with open(s["ledger"], "a") as f:
        f.write(json.dumps(ledger) + "\n")
    print(json.dumps(ledger), flush=True)
    return 0


def supervise(command: Optional[Sequence[str]] = None, poll_s: float = POLL_S,
              pause_s: float = RESTART_PAUSE_S) -> int:
    """Run ``command`` (default: this module's render) as a child process,
    start it again when it exits non-zero or its checkpoint stalls for
    ``HEADLINE_STALL_S`` seconds, and return 0 once a child exits 0, or 1
    after ``HEADLINE_MAX_RESTARTS`` restarts.  Looks at the checkpoint's
    mtime every ``poll_s`` seconds and waits ``pause_s`` before a restart."""
    stall_s = float(os.environ.get("HEADLINE_STALL_S", "1200"))
    max_restarts = int(os.environ.get("HEADLINE_MAX_RESTARTS", "20"))
    ck = settings()["ckpt"]
    command = list(command or [sys.executable, "-m", "tpu_pathtracer_torch.run_headline"])
    env = dict(os.environ)
    env.pop("HEADLINE_SUPERVISE", None)

    def ck_mtime():
        try:
            return os.path.getmtime(ck)
        except OSError:
            return 0.0

    for attempt in range(max_restarts + 1):
        child = subprocess.Popen(command, env=env)
        last = max(ck_mtime(), time.time())
        while True:
            rc = child.poll()
            if rc is not None:
                if rc == 0:
                    return 0
                print(json.dumps({"supervisor": "child_exit", "rc": rc, "attempt": attempt}),
                      flush=True)
                break  # started again below: it resumes from the checkpoint
            m = ck_mtime()
            if m > last:
                last = m
            elif time.time() - last > stall_s:
                print(json.dumps({"supervisor": "stall_kill",
                                  "stalled_s": round(time.time() - last), "attempt": attempt}),
                      flush=True)
                child.kill()
                child.wait()
                break
            try:  # a look every poll_s, or at once when the child exits
                child.wait(timeout=poll_s)
            except subprocess.TimeoutExpired:
                pass
        time.sleep(pause_s)
    print(json.dumps({"supervisor": "gave_up", "restarts": max_restarts}), flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(supervise() if os.environ.get("HEADLINE_SUPERVISE") else main())
