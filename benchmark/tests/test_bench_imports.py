"""Nothing that the harness or the reference loads is JAX, jaxlib, flax or
the JAX package (top-level module names compared whole:
``tpu_pathtracer_torch``, the program, begins with ``tpu_pathtracer``), and
the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_pathtracer"}


def _sources(sub=""):
    root = os.path.join(manifest.HERE, sub)
    for r, _, fs in os.walk(root):
        if os.sep + "tests" in r[len(manifest.HERE):]:
            continue
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(r, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources()))
def test_bench_source_imports_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")))
def test_bench_reference_imports_nothing_of_the_program(path):
    assert "tpu_pathtracer_torch" not in set(_imports(path))


def _fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": manifest.ROOT})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_bench_harness_loads_no_jax():
    mods = _fresh(
        "import sys, benchmark.run, benchmark.control\n"
        "from benchmark import manifest\n"
        "from benchmark.entries import progressive, rerender, sweep\n"
        "from tpu_pathtracer_torch import cli\n"
        "from tpu_pathtracer_torch.parallel.checkpoint import render_with_checkpoints\n"
        "from tpu_pathtracer_torch.renderer import Renderer\n"
        "from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene\n"
        "from tpu_pathtracer_torch.models import pathtracer\n"
        "[manifest.reader(m['name']) for m in manifest.load()['per_layer']]\n"
        "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    assert "tpu_pathtracer_torch" in mods
    assert not mods & FORBIDDEN


def test_bench_reference_loads_nothing_of_the_program(tmp_path):
    mods = _fresh(
        "import sys, numpy as np, torch\n"
        "from benchmark.scenes import fixtures\n"
        "from benchmark.reference import scene, tracer\n"
        f"p = fixtures.make_sphere_field_gltf({str(tmp_path / 'f.gltf')!r}, n_spheres=2, subdiv=1)\n"
        "r = dict(eps=1e-4, vndf_factor=1/3, min_roughness=0.04, use_textures=True)\n"
        "s = scene.load_scene(p, 4, 4, r)\n"
        "tracer.pixel_sums(s, r, 7, np.arange(4), 2)\n"
        "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    assert "benchmark" in mods
    assert not mods & (FORBIDDEN | {"tpu_pathtracer_torch"})
