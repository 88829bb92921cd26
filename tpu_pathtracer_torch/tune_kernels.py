#!/usr/bin/env python3
"""Try variants of a CUDA kernel beside the tree's own, on one CUDA card.

Run from the repository root (``chip_smoke.py`` makes the inputs):

    python3 -m tpu_pathtracer_torch.tune_kernels variants b6 \\
        '{"w8": [["kSlotWarps = 12", "kSlotWarps = 8"]]}'
    python3 -m tpu_pathtracer_torch.tune_kernels sass mode_kernels slots_kernel

``variants <b1|b2|b6> <json>``: each variant is a list of [regex,
replacement] pairs applied to a copy of ``csrc/`` (sources and headers)
under ``build/tpu_pathtracer_torch/variants/<name>/``; the kernel's library
is built from the copy (all variants at once), loaded with ``ctypes`` and
launched by the tree's own launcher.  On 65,536 atrium rays, at B1's three
render shapes or B2's / B6's four worklists, each variant must equal the
tree's kernel bit for bit, and the tree, the variants and the tree again
are timed by ``chip_smoke.queued_ms`` (device milliseconds of the whole
launcher call, its tensor glue included).  One JSON line per shape, and
ptxas' register line per variant.

``sass <library> <kernel>``: the SASS instruction counts of the kernel and
of its hot loop (the loop, closed by a backward branch, with the most
floating-point instructions per instruction), from ``cuobjdump``.
"""

import collections
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

KERNELS = {  # kernel -> (library, launcher in kernels.py, ptxas entry name)
    "b1": ("chunk_kernels", "activity", "activity_kernel"),
    "b2": ("chunk_kernels", "items", "items_kernel"),
    "b6": ("mode_kernels", "slots", "slots_kernel"),
}


def build_variants(library, entry, variants):
    """{name: ctypes library} built from substituted copies of csrc/."""
    from . import kernels

    procs = {}
    for name, subs in variants.items():
        out_dir = os.path.join(kernels.BUILD_DIR, "variants", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(kernels._CSRC, out_dir)
        hits = [0] * len(subs)
        for fn in os.listdir(out_dir):
            path = os.path.join(out_dir, fn)
            with open(path) as f:
                text = f.read()
            for k, (pattern, replacement) in enumerate(subs):
                text, n = re.subn(pattern, replacement, text)
                hits[k] += n
            with open(path, "w") as f:
                f.write(text)
        if not all(hits):
            raise SystemExit(f"variant {name}: a pattern matched nothing ({hits})")
        so = os.path.join(out_dir, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, os.path.join(out_dir, library + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        regs = [" | ".join(x.strip() for x in lines[k + 2:k + 4]) for k, ln in enumerate(lines)
                if "Compiling entry" in ln and entry + "E" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in kernels.LIBRARIES[library].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def run_variants(kernel, variants, reps=20):
    import chip_smoke as cs
    from . import kernels
    from .ops import chunk_intersect as ci

    library, launcher, entry = KERNELS[kernel]
    cs.phase_device()
    kernels.build()
    tree = kernels.library(library)
    libs = build_variants(library, entry, variants)
    launch = getattr(kernels, launcher)

    def with_library(lib, args):
        kernels._libraries()[library] = lib
        try:
            return launch(*args)
        finally:
            kernels._libraries()[library] = tree

    with tempfile.TemporaryDirectory() as tmp:
        _, _, _, scene, rays_sets = cs.make_inputs(tmp)
        shapes = {}
        if kernel == "b1":
            shapes = cs.phase_b1(scene, rays_sets)[1]
        else:
            for name, (o, d) in rays_sets.items():
                rays, cw, lists = cs.worklists(scene, o, d)
                r = rays.shape[0]
                t0 = torch.full((r,), math.inf, device="cuda")
                i0 = torch.zeros((r,), dtype=torch.int32, device="cuda")
                for wl, (idx, counts, masks) in lists.items():
                    shapes[f"{name}/{wl}"] = (rays, t0, i0, cw, idx, counts, masks, cs.EPS,
                                              ci.GROUP, 8)
        for shape, args in shapes.items():
            want = launch(*args)
            row = {"kernel": kernel, "shape": shape,
                   "tree_ms": [cs.queued_ms(lambda: launch(*args), reps)]}
            for name, lib in libs.items():
                got = with_library(lib, args)
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
                row[name + "_ms"] = cs.queued_ms(lambda: with_library(lib, args), reps)
                row[name + "_equal"] = equal
            row["tree_ms"].append(cs.queued_ms(lambda: launch(*args), reps))
            print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)


def sass_counts(library, kernel):
    from . import kernels

    kernels.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so = os.path.join(kernels.BUILD_DIR, f"lib{library}.so")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0]
        if kernel + "E" not in name:
            continue
        ops = []  # (address, opcode)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);", part):
            ops.append((int(m.group(1), 16), m.group(2), m.group(3)))
        index = {a: k for k, (a, _, _) in enumerate(ops)}
        loops = []
        for k, (addr, op, rest) in enumerate(ops):
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) < addr and int(target.group(1), 16) in index:
                loops.append((index[int(target.group(1), 16)], k))

        def classes(lo, hi):
            return collections.Counter(op.split(".")[0] for _, op, _ in ops[lo:hi + 1])

        def fp_share(span):
            c = classes(*span)
            return sum(c[k] for k in ("FMUL", "FADD", "FFMA", "FMNMX")) / (span[1] - span[0] + 1)

        row = {"kernel": name[:80], "instructions": len(ops),
               "classes": dict(classes(0, len(ops) - 1).most_common(12))}
        if loops:
            hot = max(loops, key=fp_share)
            row["hot_loop"] = {"instructions": hot[1] - hot[0] + 1,
                               "classes": dict(classes(*hot).most_common())}
        print(json.dumps(row), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("tune_kernels: no CUDA device")
    if len(argv) == 3 and argv[0] == "variants" and argv[1] in KERNELS:
        run_variants(argv[1], json.loads(argv[2]))
    elif len(argv) == 3 and argv[0] == "sass":
        sass_counts(argv[1], argv[2])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
