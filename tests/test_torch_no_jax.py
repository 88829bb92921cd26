"""The port never imports jax.  Checked in a fresh interpreter: this test
process already imported jax through tests/conftest.py."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "tpu_pathtracer_torch",
    "tpu_pathtracer_torch.cli",
    "tpu_pathtracer_torch.bridge",
    "tpu_pathtracer_torch.kernels",
    "tpu_pathtracer_torch.models.pathtracer",
    "tpu_pathtracer_torch.ops.chunk_intersect",
    "tpu_pathtracer_torch.scene.fixtures",
    "tpu_pathtracer_torch.scene.gltf",
    "tpu_pathtracer_torch.utils.image",
]


def test_torch_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
