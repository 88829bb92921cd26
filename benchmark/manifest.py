"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the files it names.  Everything that belongs to one configuration, traffic
mix, cell or per-layer metric sits in a file of its own, found by its name:

    benchmark/configs/<config>.json        the configuration (``file``)
    benchmark/scenes/<module>.py           a configuration's own scene generators
                                           (``scene.module``, ``env.module``)
    benchmark/traffic/<traffic>.json       the traffic mix's parameters
    benchmark/entries/<entry>.py           the entry a traffic file names
    benchmark/limits/<cell>.json           the limits of the cell's comparison
    benchmark/metrics/<metric>.py          a per-layer metric's reader
    benchmark/kernel_names/<layer>.*.txt   hand-written kernel names

so a later change adds a configuration, a mix or a metric as new files and
new manifest entries, and edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """Everything a run of cell ``name`` reads: the manifest's entries of the
    cell and its configuration, the configuration's and traffic's files,
    the cell's limits, and its metrics by kind."""
    bench = bench or load()
    work = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], work["config"], "configuration")

    def listed(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return dict(
        name=name,
        workload=work,
        config_entry=conf,
        config=_json(ROOT, conf["file"]),
        traffic=_json(HERE, "traffic", work["traffic"] + ".json"),
        limits=_json(HERE, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)],
    )


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str) -> Callable:
    """The entry ``benchmark/entries/<name>.py``'s ``run``."""
    return _module(os.path.join(HERE, "entries", name + ".py"), "benchmark_entry_" + name).run


def reader(metric: str) -> Callable:
    """The per-layer metric's reader ``benchmark/metrics/<metric>.py``'s
    ``read(ctx)``: its value, or None where the run gives it nothing to read."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return _module(path, "benchmark_metric_" + metric.replace(".", "_")).read


def kernel_names(prefix: str = "") -> List[str]:
    """The hand-written kernels' names in ``benchmark/kernel_names/`` (one per
    line, ``#`` comments), from the files whose name starts with
    ``prefix`` ("" = every file)."""
    out = []
    d = os.path.join(HERE, "kernel_names")
    for fn in sorted(os.listdir(d)):
        if fn.startswith(prefix) and fn.endswith(".txt"):
            with open(os.path.join(d, fn)) as f:
                out += [ln.split("#", 1)[0].strip() for ln in f if ln.split("#", 1)[0].strip()]
    return out
