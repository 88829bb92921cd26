"""tpu_pathtracer_torch — the PyTorch + CUDA port of ``tpu_pathtracer``.

A second package beside the JAX/Pallas one, which stays the reference: the
same glTF and homebrew ``.txt`` scene loaders, the same persistent-wavefront
Monte-Carlo estimator with the same counter-based (seed, pixel, sample,
depth) draws, the legacy Whitted and Monte-Carlo integrators of the
homebrew format, and the same ACES + gamma + P6 PPM output, on PyTorch
tensors.  The seven Pallas kernels of the large-scene intersector are
hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with a plain
torch twin that is its CPU path.

The package imports ``torch`` and never ``jax`` nor anything of
``tpu_pathtracer``: every host module it needs is its own copy.

Entry points: ``python -m tpu_pathtracer_torch <scene> <W> <H> <spp>
<out.ppm>`` (``cli.py``), ``Renderer`` (a resident scene rendering many
frames) and ``render_scene_file``.
"""

from .config import DEFAULT_CONFIG, RenderConfig

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level API: ``import tpu_pathtracer_torch`` loads no model code.
    if name == "Renderer":
        from .renderer import Renderer

        return Renderer
    if name == "render_scene_file":
        from .cli import render_scene_file

        return render_scene_file
    raise AttributeError(name)


__all__ = ["RenderConfig", "DEFAULT_CONFIG", "Renderer", "render_scene_file"]
