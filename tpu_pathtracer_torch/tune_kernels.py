#!/usr/bin/env python3
"""Try variants of a CUDA kernel beside the tree's own, on one CUDA card.

Run from the repository root (``chip_smoke.py`` makes the inputs):

    python3 -m tpu_pathtracer_torch.tune_kernels variants b6 \\
        '{"w8": [["kSlotWarps = 12", "kSlotWarps = 8"]]}'
    python3 -m tpu_pathtracer_torch.tune_kernels variants rng \\
        '{"parent": "build/parent/tpu_pathtracer_torch/csrc"}'
    python3 -m tpu_pathtracer_torch.tune_kernels sass mode_kernels slots_kernel

``variants <b1|b2|b6|rng> <json>``: each variant is a list of [regex,
replacement] pairs applied to a copy of ``csrc/`` (sources and headers)
under ``build/tpu_pathtracer_torch/variants/<name>/``, or the path of
another ``csrc/`` directory (an older tree's, with the same C entry points)
copied as it is; the kernel's library is built from the copy (all variants
at once), loaded with ``ctypes`` and launched by the tree's own launcher.
On 65,536 atrium rays, at B1's three render shapes or B2's / B6's four
worklists, or on the threefry kernel's forms and lane counts
(``chip_smoke.rng_forms``), each variant must equal the tree's kernel bit
for bit, and the tree, the variants and the tree again are timed by
``chip_smoke.queued_ms`` (device milliseconds of the whole launcher call,
its tensor glue included).  One JSON line per shape, and ptxas' register
line per variant.

``sass <library or .so path> <kernel>``: for each instance of the kernel
(a variant's library by its path), the SASS
instruction counts, the instructions by pipe (``PIPES``), and those of its
hot loop (the loop, closed by a backward branch, with the most
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
    "rng": ("rng_kernels", "uniforms", "uniforms_kernel"),
}
# The pipe of an SM scheduler that runs each integer or float32 opcode:
# ALU and FMA take 16 lanes a clock each (FADD / FMUL / FFMA also on the
# FMA pipe's second half, 32 a clock).  VIADD, Hopper's add of a constant,
# is counted with IADD3.
PIPES = {
    "alu": ("IADD3", "VIADD", "LOP3", "SHF", "ISETP", "LEA", "SEL", "IMNMX", "FMNMX", "FSETP",
            "FSEL", "PLOP3", "PRMT"),
    "fma": ("IMAD", "FADD", "FMUL", "FFMA"),
}


def build_variants(library, entry, variants):
    """{name: ctypes library} built from substituted copies of csrc/."""
    from . import kernels

    procs = {}
    for name, subs in variants.items():
        out_dir = os.path.join(kernels.BUILD_DIR, "variants", name)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(subs if isinstance(subs, str) else kernels._CSRC, out_dir)
        subs = [] if isinstance(subs, str) else subs
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
        if subs and not all(hits):
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
                if "Compiling entry" in ln and re.search(entry + "[EI]", ln)]
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
        shapes = {}
        if kernel == "rng":
            for n in cs.RNG_RAGGED + cs.RNG_LANES:
                for form, (args, sb, pb) in cs.rng_forms(n).items():
                    if n == cs.N_RAYS or form in ("bounce", "jitter"):
                        shapes[f"{form}/{n}"] = (*args, sb, pb)
        elif kernel == "b1":
            shapes = cs.phase_b1(*cs.make_inputs(tmp)[3:])[1]
        else:
            _, _, _, scene, rays_sets = cs.make_inputs(tmp)
            for name, (o, d) in rays_sets.items():
                rays, cw, lists = cs.worklists(scene, o, d)
                r = rays.shape[0]
                t0 = torch.full((r,), math.inf, device="cuda")
                i0 = torch.zeros((r,), dtype=torch.int32, device="cuda")
                for wl, (idx, counts, masks) in lists.items():
                    shapes[f"{name}/{wl}"] = (rays, t0, i0, cw, idx, counts, masks, cs.EPS,
                                              ci.GROUP, 8)
        rows = {}
        for shape, args in shapes.items():
            want = launch(*args)
            row = {"kernel": kernel, "shape": shape,
                   "tree_ms": [cs.queued_ms(lambda: launch(*args), reps)]}
            for name, lib in libs.items():
                got = with_library(lib, args)
                torch.cuda.synchronize()
                pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
                equal = all(torch.equal(a, b) for a, b in pairs if a is not None)
                row[name + "_ms"] = cs.queued_ms(lambda: with_library(lib, args), reps)
                row[name + "_equal"] = equal
            row["tree_ms"].append(cs.queued_ms(lambda: launch(*args), reps))
            rows[shape] = row
            print(json.dumps(row), flush=True)
    if kernel == "rng":  # a launch's fixed cost and its cost a lane, as chip_smoke.phase_rng
        for form in ("bounce", "jitter"):
            fit = {"kernel": kernel, "form": form, "lanes": cs.RNG_LANES}
            for name in ("tree", *libs):
                ms = [rows[f"{form}/{n}"][name + "_ms"] for n in cs.RNG_LANES]
                ms = [sum(t) / len(t) if isinstance(t, list) else t for t in ms]
                a, b = cs.fit_line(cs.RNG_LANES, ms)
                fit[name] = {"intercept_ms": a, "ns_per_1k_lanes": b * 1e9}
            print(json.dumps(fit), flush=True)
    print(cs.card_line(), flush=True)


def sass_counts(library, kernel):
    from . import kernels

    kernels.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so = library if library.endswith(".so") else os.path.join(kernels.BUILD_DIR, f"lib{library}.so")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0]
        if not re.search(kernel + "[EI]", name):
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

        every = classes(0, len(ops) - 1)
        row = {"kernel": name[:80], "instructions": len(ops),
               "classes": dict(every.most_common(16)),
               "pipes": {pipe: sum(every[op] for op in ops_) for pipe, ops_ in PIPES.items()}}
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
