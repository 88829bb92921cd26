"""Procedural glTF fixtures the port is run and measured on.

The generators are the JAX package's jax-free ones
(``tpu_pathtracer/utils/testscenes.py``), re-exported so that scripts that
run the port (``chip_smoke.py``) reach them through this package alone.
"""

from tpu_pathtracer.utils.testscenes import (  # noqa: F401
    make_atrium_gltf,
    make_cornell_gltf,
)
