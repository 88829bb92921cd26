"""tpu_pathtracer_torch — the PyTorch + CUDA port of ``tpu_pathtracer``.

A second package beside the JAX/Pallas one, which stays the reference: the
same glTF loader, the same persistent-wavefront Monte-Carlo estimator with
the same counter-based (seed, pixel, sample, depth) draws, the same ACES +
gamma + P6 PPM output — on PyTorch tensors, with the two Pallas kernels of
the large-scene intersector rewritten as hand-written CUDA kernels for
Hopper (``csrc/chunk_kernels.cu``).

The package imports ``torch`` and never ``jax``; from the JAX package it
reuses only the jax-free host modules (``config``, ``scene.accel``,
``scene.native``, ``utils.hdr``, ``utils.metrics``, ``utils.testscenes``).

Entry point: ``python -m tpu_pathtracer_torch <scene.gltf> <W> <H> <spp>
<out.ppm>`` (see ``cli.py``).
"""

__version__ = "0.1.0"
