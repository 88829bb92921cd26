"""The benchmark's frozen scene generators write the files that the
program's generators (``tpu_pathtracer_torch/scene/fixtures.py``) wrote at
the commit that defined the benchmark: the glTF, its buffer and the HDR sky
byte for byte, and the PNG textures pixel for pixel (a PNG's bytes depend
on the encoder's version)."""

import hashlib
import os

import numpy as np
import pytest

from benchmark.scenes import fixtures

# sha256 of each file (a PNG: of its decoded RGBA pixels) as the program's
# generators wrote it.
BYTES = {
    "a/atrium.bin": "f111bf5fbe55d926e1990813a2423827d5ab52b85e741c25c2c4f503a448c8fb",
    "a/atrium.gltf": "579e8947e04b0b5c22a5ccffc24437546c865596b115f5898fdabee4bdb91434",
    "f/env.hdr": "eb5b57e9432591c30b8433b57b51ff96ff00b56c09e1230b2c2bf723134381df",
    "f/field.bin": "18ab6f3143598eaf4d88a50bef2f44e4c04fbca8ebbe8989a1231b676730c705",
    "f/field.gltf": "bf7140b41660a6b96861f7c95ebd797f5dab19818dce79a33fa409b87a353a34",
}
PIXELS = {
    "a/at_floor.png": "d2e8043930a6612fafe7a6415a5921faba7fe80dd681d2c7f2aab0311279b286",
    "a/at_marble.png": "e794968deed9ea1c3cc17a5d89ba6b3eb1188438eacf0ca9b79fe307b414b906",
    "a/at_mr.png": "844bebcb9fe19f3dfc43fa3a1088145f7e929f808db7780666580acebc2f3fa9",
    "a/at_nrm.png": "ad824a2c14cbb57f0d978f3cdff183dcfc8dbe2161f58f4c3486a5fb3cb9fb87",
    "a/at_wall.png": "3751cce54dffe125669f3c12f3febf35c06b904d60410299ef1d77c2d52791f3",
    "f/bc0.png": "f747eaf9437f103bbcb4fd21175832076427df5727eaf0bc9716f811d0e85662",
    "f/bc1.png": "7ac4aa02ca3f812b65510824bcb7dfef3b82a01ccdd00699d123cd92525256b5",
    "f/bc2.png": "6437c402e16b3b8d832a5b836660fc6aed6cfac80b2eaa62bb4084a2db5d1cc7",
    "f/bc3.png": "72dffcd076d32ad6dc99c04a11d4671b90f4836bd947c93cf2b935ec08b6e4d5",
    "f/mr.png": "f3c233dc55bbf4dcf7ef41e6dd84024d73909a5a39bc347551aade43212570ee",
    "f/nrm.png": "8d792ff2337c3f7d6bc09f66d0604eda052ab5cad555ebf4b85b143d6b153da5",
}


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        a = np.asarray(im.convert("RGBA"))
    return hashlib.sha256(a.tobytes() + str(a.shape).encode()).hexdigest()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    fixtures.make_atrium_gltf(str(d / "a" / "atrium.gltf"), detail=2, seed=0, light_strength=60.0,
                              textured=True)
    fixtures.make_sphere_field_gltf(str(d / "f" / "field.gltf"), n_spheres=64, subdiv=3, seed=0,
                                    light_strength=30.0, textured=True)
    fixtures.make_env_hdr(str(d / "f" / "env.hdr"))
    return d


@pytest.mark.parametrize("name", sorted(BYTES))
def test_bench_scene_file_bytes(written, name):
    with open(os.path.join(written, name), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == BYTES[name]


@pytest.mark.parametrize("name", sorted(PIXELS))
def test_bench_scene_texture_pixels(written, name):
    assert _pixels(os.path.join(written, name)) == PIXELS[name]


def test_bench_scene_files_all_known(written):
    names = {os.path.relpath(os.path.join(r, f), written)
             for r, _, fs in os.walk(written) for f in fs}
    assert names == set(BYTES) | set(PIXELS)
