"""The port imports neither jax nor anything of the JAX package
(``tpu_pathtracer``): checked in a fresh interpreter (this test process
already imported both through tests/conftest.py), and statically, by an AST
scan of every module of the port and of ``chip_smoke.py``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tpu_pathtracer_torch")

MODULES = [
    "tpu_pathtracer_torch",
    "tpu_pathtracer_torch.cli",
    "tpu_pathtracer_torch.bridge",
    "tpu_pathtracer_torch.config",
    "tpu_pathtracer_torch.kernels",
    "tpu_pathtracer_torch.models.pathtracer",
    "tpu_pathtracer_torch.ops.chunk_intersect",
    "tpu_pathtracer_torch.scene.accel",
    "tpu_pathtracer_torch.scene.fixtures",
    "tpu_pathtracer_torch.scene.gltf",
    "tpu_pathtracer_torch.scene.native",
    "tpu_pathtracer_torch.utils.hdr",
    "tpu_pathtracer_torch.utils.image",
    "tpu_pathtracer_torch.utils.metrics",
]


def _forbidden(name: str) -> bool:
    """jax, jaxlib, or the JAX package (``tpu_pathtracer`` and its
    submodules; the port's own ``tpu_pathtracer_torch`` is fine)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tpu_pathtracer")


def test_torch_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_pathtracer'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_torch_port_sources_import_nothing_of_jax(path):
    """No ``import``/``from`` of jax or of the JAX package anywhere in the
    file, at any depth (a function-level import would escape the
    fresh-interpreter check until the function runs).  Relative imports stay
    inside the port."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
