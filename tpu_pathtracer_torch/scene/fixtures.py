"""Procedural glTF fixtures the port is run and measured on.

The generators are the JAX package's jax-free ones
(``tpu_pathtracer/utils/testscenes.py``), re-exported so that scripts that
run the port (``chip_smoke.py``) reach them through this package alone, plus
``make_lit_banner_atrium_gltf``, the atrium made a many-light scene.
"""

import json

from tpu_pathtracer.utils.testscenes import (  # noqa: F401
    make_atrium_gltf,
    make_cornell_gltf,
    make_env_hdr,
    make_env_image,
    make_sphere_field_gltf,
)

GREEN_DRAPE = 6  # index of the green drape material in make_atrium_gltf's file
GREEN_DRAPE_COLOR = [0.08, 0.35, 0.1, 1]
BANNER_EMISSION = (0.3, 1.0, 0.4)
BANNER_STRENGTH = 4.0


def make_lit_banner_atrium_gltf(path: str, detail: int = 2, textured: bool = True) -> str:
    """The enclosed atrium with its green drapes (the banners) emissive:
    every banner triangle becomes a light (~24,600 lights at detail 2, in
    more than 190 clusters of 128), beside the six skylight triangles.  The
    geometry is ``make_atrium_gltf``'s; only the written material changes."""
    make_atrium_gltf(path, detail=detail, textured=textured)
    with open(path) as f:
        root = json.load(f)
    mat = root["materials"][GREEN_DRAPE]
    if mat["pbrMetallicRoughness"]["baseColorFactor"] != GREEN_DRAPE_COLOR:
        raise ValueError(f"{path}: material {GREEN_DRAPE} is not the green drape")
    mat["emissiveFactor"] = list(BANNER_EMISSION)
    mat.setdefault("extensions", {})["KHR_materials_emissive_strength"] = {
        "emissiveStrength": BANNER_STRENGTH
    }
    with open(path, "w") as f:
        json.dump(root, f)
    return path
