"""A configuration may name the scene module that holds its generators
(``scene.module``, ``env.module``; ``fixtures`` by default): the
configurations without one resolve the generators they always did, a bad
module or generator name is refused by name, and ``lit_banner`` writes the
lit-banner atrium byte for byte as the program's generator
(``tpu_pathtracer_torch/scene/fixtures.make_lit_banner_atrium_gltf``) wrote
it at the commit that added the configuration ``litbanner``."""

import copy
import hashlib
import os
import re
import sys

import pytest

from benchmark import manifest, scenes
from benchmark.scenes import fixtures, lit_banner
from benchmark.tests.test_bench_scenes import BYTES, PIXELS, _pixels

LIT_GLTF = "9351b98f78d6280be8e6bc2bffcdd4000f7eb1f3fa7b925512d32c64420f1804"


def _config(name):
    return copy.deepcopy(manifest.cell(name)["config"])


@pytest.mark.parametrize("cell,scene,env", [
    ("atrium.progressive", fixtures.make_atrium_gltf, None),
    ("envfield.sweep", fixtures.make_sphere_field_gltf, fixtures.make_env_hdr),
    ("litbanner.progressive", lit_banner.make_lit_banner_atrium_gltf, None),
])
def test_bench_generate_resolves_the_configured_generators(cell, scene, env, tmp_path,
                                                           monkeypatch):
    """``generate`` calls the configuration's generators with its arguments;
    ``atrium`` and ``envfield``, which name no module, take ``fixtures``'."""
    config = _config(cell)
    assert scenes.generator(config["scene"]) is scene
    assert (scenes.generator(config["env"]) if config["env"] else None) is env
    calls = []

    def stub(fn):
        def record(path, **kwargs):
            calls.append((fn.__name__, os.path.basename(path), kwargs))
            return path
        return record

    for fn in (scene, env):
        if fn:
            monkeypatch.setattr(sys.modules[fn.__module__], fn.__name__, stub(fn))
    files = scenes.generate(config, str(tmp_path / "out"))
    want = [(scene.__name__, config["scene"]["file"], config["scene"]["args"])]
    if env:
        want.append((env.__name__, config["env"]["file"], {}))
    assert calls == want
    assert files == {"gltf": str(tmp_path / "out" / config["scene"]["file"]),
                     "env": str(tmp_path / "out" / config["env"]["file"]) if env else None}


@pytest.mark.parametrize("where,module,generator,named", [
    ("scene", "no_such_module", "make_atrium_gltf", "no_such_module"),
    ("scene", "Lit_Banner", "make_lit_banner_atrium_gltf", "Lit_Banner"),
    ("scene", "../scenes/fixtures", "make_atrium_gltf", "../scenes/fixtures"),
    ("scene", "fixtures.py", "make_atrium_gltf", "fixtures.py"),
    ("scene", 7, "make_atrium_gltf", "7"),
    ("scene", "fixtures", "make_no_such_scene", "make_no_such_scene"),
    ("scene", "lit_banner", "GREEN_DRAPE", "GREEN_DRAPE"),
    ("env", "no_such_module", "make_env_hdr", "no_such_module"),
    ("env", "fixtures", "make_no_such_env", "make_no_such_env"),
])
def test_bench_generate_refuses_a_bad_module_or_generator(where, module, generator, named,
                                                          tmp_path):
    config = _config("envfield.sweep")
    config[where].update(module=module, generator=generator)
    with pytest.raises(ValueError, match=re.escape(named)):
        scenes.generate(config, str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()  # refused before anything is written


@pytest.fixture(scope="module")
def lit_written(tmp_path_factory):
    d = tmp_path_factory.mktemp("lit")
    lit_banner.make_lit_banner_atrium_gltf(str(d / "atrium.gltf"), detail=2, textured=True)
    return d


def test_bench_lit_banner_gltf_bytes(lit_written):
    with open(lit_written / "atrium.gltf", "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == LIT_GLTF


def test_bench_lit_banner_buffer_and_textures_are_the_atrium_s(lit_written):
    with open(lit_written / "atrium.bin", "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == BYTES["a/atrium.bin"]
    pngs = sorted(n for n in os.listdir(lit_written) if n.endswith(".png"))
    assert pngs == sorted(os.path.basename(k) for k in PIXELS if k.startswith("a/"))
    for name in pngs:
        assert _pixels(str(lit_written / name)) == PIXELS["a/" + name]
