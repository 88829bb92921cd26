"""The lit-banner atrium: a frozen copy of the port's
``make_lit_banner_atrium_gltf`` (``tpu_pathtracer_torch/scene/fixtures.py``),
the configuration ``litbanner``'s scene.

It writes ``fixtures.make_atrium_gltf``'s atrium and makes its green drapes
(the banners) emissive, so every banner triangle is a light: 24,576 banner
triangles and the 6 skylight triangles at detail 2.  The buffer and the
textures are the atrium's; only the glTF's material 6 changes.  The file is
byte-identical to the port's generator's at the commit that added it
(``benchmark/tests/test_bench_scene_modules.py`` holds its digest).
"""

from __future__ import annotations

import json

from .fixtures import make_atrium_gltf

GREEN_DRAPE = 6  # index of the green drape material in make_atrium_gltf's file
GREEN_DRAPE_COLOR = [0.08, 0.35, 0.1, 1]
BANNER_EMISSION = (0.3, 1.0, 0.4)
BANNER_STRENGTH = 4.0


def make_lit_banner_atrium_gltf(path: str, detail: int = 2, textured: bool = True) -> str:
    """The enclosed atrium (seed 0, skylights at strength 60) with its green
    drapes emissive at (0.3, 1.0, 0.4) x 4.0."""
    make_atrium_gltf(path, detail=detail, seed=0, light_strength=60.0, textured=textured)
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
