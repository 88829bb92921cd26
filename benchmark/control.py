"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
(float32 with TF32 off): the dense sweep's product with TF32 inputs.  It
is judged as a run's output is, on the pixels and samples a run checks,
and has to come out off by far more than the program does.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--samples N] [--frames N]

``--samples`` is the samples per pixel a progressive run's window reaches
(the first pass and the window's); ``--frames`` the frames or renders a
rerender or sweep run's window holds.  One JSON line per seed: the compared number of the control
and, as a check of the harness, of the float32 reference against itself.
Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def readings(cell: dict, seed: int, device, samples: int, frames: int) -> dict:
    from benchmark import correctness, scenes
    from benchmark.entries import progressive, rerender, sweep
    from benchmark.reference import scene as ref_scene
    from benchmark.reference import tracer
    from benchmark.traffic import orbit

    traffic, config = cell["traffic"], cell["config"]
    w, h = int(traffic["width"]), int(traffic["height"])
    files = scenes.generate(config, scenes.scene_dir(cell["name"] + ".control"))
    fields = scenes.render_fields(config, files)
    ref = ref_scene.load_scene(files["gltf"], w, h, fields).to(device)
    # (seed, pixels, samples, camera pose or None) of each frame checked
    if traffic["entry"] == "progressive":
        jobs = [(seed, progressive.check_pixels(traffic, seed), samples, None)]
    elif traffic["entry"] == "sweep":
        jobs = [(sweep.render_seed(seed, int(i)), sweep.render_pixels(traffic, seed, int(i)),
                 int(traffic["spp"]), None)
                for i in sweep.check_renders(traffic, seed, frames)]
    else:
        pose = orbit.walk(traffic["orbit"], seed)
        jobs = [(rerender.frame_seed(seed, int(i)), rerender.frame_pixels(traffic, seed, int(i)),
                 int(traffic["spp"]), pose(int(i)))
                for i in rerender.check_frames(traffic, seed, frames)]
    sums = {"float32": [], "tf32": []}
    for frame_seed, pixels, n, view in jobs:
        if view is not None:
            ref.camera = ref_scene.look_at_camera(*view, w, h).to(device)
        for precision in sums:
            sums[precision].append(tracer.pixel_sums(ref, fields, frame_seed, pixels, n,
                                                     precision=precision))
    n = jobs[0][2]
    f32, tf32 = np.concatenate(sums["float32"]), np.concatenate(sums["tf32"])
    return dict(cell=cell["name"], seed=seed, samples=n,
                control_pixels_off_share=correctness.off_share(tf32, f32, n),
                reference_vs_itself=correctness.off_share(f32, f32, n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--frames", type=int, default=300)
    args = ap.parse_args(argv)
    import torch

    from benchmark import manifest

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, torch.device("cuda", 0), args.samples,
                                  args.frames)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
