"""The benchmark of ``tpu_pathtracer_torch`` on NVIDIA GPUs.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run of one cell of ``BENCHMARK.json``:
the configuration's scene is generated from ``benchmark/scenes/`` into
``$TMPDIR/benchmark/<cell>``, loaded by the program's own loader and
driven by the traffic file's entry (``benchmark/entries/``) for
``--seconds`` after a warm-up of the cell's own shape; then the program's
output is checked against the plain reference (``benchmark/reference/``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which are also the last lines of standard error.

The run fails (exit code 2, no result) when no CUDA card is present or fewer
than the cell asks for, and (exit code 3) when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathtracer")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``tpu_pathtracer_torch`` is the program)."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def per_layer(cell: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something to
    read in."""
    out = {}
    for m in cell["per_layer"]:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell`` on ``device`` (the chip check is the caller's):
    the result line's object, ``checks`` last."""
    import torch

    from benchmark import correctness, profiling

    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    res = manifest.entry(cell["traffic"]["entry"])(cell, seed, seconds, trace, device, t0)
    ctx = res["ctx"]
    out = dict(correct=False, attempted=res["attempted"], failed=res["failed"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=int(cell["workload"]["chips"]), memory_peak_bytes=res["memory_peak_bytes"])
    if trace:
        if "trace" in ctx:
            summary = profiling.summary(ctx["trace"]["prof"], ctx["trace"]["wall_s"])
            ctx["trace"]["summary"] = summary
            dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            out["breakdown"] = summary["breakdown"]
        out["metrics"] = per_layer(cell, ctx)
    else:
        out["metrics"] = {m["name"]: {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
                          for m in cell["end_to_end"]}
    out["device"] = dev
    ok, checks = correctness.judge(res["numbers"], cell["limits"])
    out["correct"] = ok
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)

    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    from benchmark import correctness

    correctness.report(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
