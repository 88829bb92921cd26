"""The benchmark's scenes: a configuration names its generators and their
arguments, and a run writes the files afresh under ``TMPDIR``."""

from __future__ import annotations

import os
import shutil
import tempfile

from . import fixtures


def scene_dir(name: str) -> str:
    """``$TMPDIR/benchmark/<name>``: a fixed path under the run's own
    temporary directory."""
    return os.path.join(tempfile.gettempdir(), "benchmark", name)


def generate(config: dict, out_dir: str) -> dict:
    """Write the configuration's scene (and environment map, if any) into
    ``out_dir``, emptied first.  Returns {"gltf": path, "env": path or
    None}."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spec = config["scene"]
    gltf = getattr(fixtures, spec["generator"])(os.path.join(out_dir, spec["file"]),
                                                **spec.get("args", {}))
    env = None
    if config.get("env"):
        env = getattr(fixtures, config["env"]["generator"])(os.path.join(out_dir,
                                                                          config["env"]["file"]))
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
