"""The benchmark's scenes: a configuration names its generators and their
arguments, and a run writes the files afresh under ``TMPDIR``.

A generator is looked up in ``benchmark/scenes/<module>.py``, where
``module`` is the configuration's optional ``scene.module`` (or
``env.module`` for the environment map), ``fixtures`` by default; so a
configuration that needs a scene of its own brings its generators in a
file of its own."""

from __future__ import annotations

import importlib
import os
import re
import shutil
import tempfile
from typing import Callable

HERE = os.path.dirname(os.path.abspath(__file__))
MODULE = re.compile(r"[a-z_][a-z0-9_]*\Z")


def scene_dir(name: str) -> str:
    """``$TMPDIR/benchmark/<name>``: a fixed path under the run's own
    temporary directory."""
    return os.path.join(tempfile.gettempdir(), "benchmark", name)


def generator(spec: dict) -> Callable:
    """The generator ``spec["generator"]`` of the scene module
    ``spec.get("module", "fixtures")``; ValueError, naming the module, its
    file and the generator, where the name is malformed, the file is
    missing or the module has no such function."""
    module, name = spec.get("module", "fixtures"), spec["generator"]
    path = os.path.join(HERE, f"{module}.py")
    if not isinstance(module, str) or not MODULE.match(module) or not os.path.isfile(path):
        raise ValueError(f"scene module {module!r} ({path}) for generator {name!r}: the module "
                         f"has to match [a-z_][a-z0-9_]* and its file has to exist")
    fn = getattr(importlib.import_module(f".{module}", __name__), name, None)
    if not callable(fn):
        raise ValueError(f"scene module {module!r} ({path}) has no generator {name!r}")
    return fn


def generate(config: dict, out_dir: str) -> dict:
    """Write the configuration's scene (and environment map, if any) into
    ``out_dir``, emptied first.  Returns {"gltf": path, "env": path or
    None}."""
    spec = config["scene"]
    make_scene = generator(spec)
    make_env = generator(config["env"]) if config.get("env") else None
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    gltf = make_scene(os.path.join(out_dir, spec["file"]), **spec.get("args", {}))
    env = make_env(os.path.join(out_dir, config["env"]["file"])) if make_env else None
    return {"gltf": gltf, "env": env}


def render_fields(config: dict, files: dict) -> dict:
    """The configuration's ``RenderConfig`` fields, the environment map's
    path filled in from the generated files."""
    fields = dict(config["render"])
    if fields.get("use_env_map"):
        fields["env_map_path"] = files["env"]
    if "light_triangle_relative_pos" in fields:
        fields["light_triangle_relative_pos"] = tuple(
            tuple(float(x) for x in row) for row in fields["light_triangle_relative_pos"])
    return fields
