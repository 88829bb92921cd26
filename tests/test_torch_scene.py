"""The port's jax-free glTF loader vs the JAX package's, array by array, and
the numpy bridge between the two scene types."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpu_pathtracer import config as jax_cfg
from tpu_pathtracer.scene import native as jnative
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils.testscenes import (
    make_cornell_gltf,
    make_env_hdr,
    make_env_image,
    make_sphere_field_gltf,
    make_textured_cornell_gltf,
)
from tpu_pathtracer_torch.bridge import scene_from_arrays
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.scene import native as tnative
from tpu_pathtracer_torch.scene import types as ttypes
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene as torch_parse

torch.set_num_threads(1)

FIXTURES = {
    "cornell": make_cornell_gltf,
    "textured_cornell": make_textured_cornell_gltf,
    # 3 spheres x 1,280 + floor and light: 3,844 triangles, 31 chunks.
    "sphere_field": lambda p: make_sphere_field_gltf(p, n_spheres=3, subdiv=3, textured=True),
}


# The JAX package's packer library (git-ignored, built at its first use).
JAX_LIBRARY = os.path.join(jnative._repo_root(), "native", "libaccel_pack.so")


def same_host_path(monkeypatch) -> str:
    """Put the JAX package and the port on the same host build path for one
    test; returns it ("native" or "numpy").

    Each package loads a scene through its native packer when the library
    loads, else through numpy, and the two paths give equal arrays only path
    for path: the native SAH order breaks ties in another order and the
    native Woop solve rounds some values differently.  The JAX package
    remembers a failed load for the rest of the process, and builds its
    library in place, so a process that loads the file while another is
    still writing it builds every JAX scene through numpy from then on.
    Such a load is retried once; if either package's library is still
    unavailable, both take numpy (``TPU_PATHTRACER_NO_NATIVE``)."""
    if os.environ.get("TPU_PATHTRACER_NO_NATIVE"):
        return "numpy"
    if jnative.load_library() is None and os.path.exists(JAX_LIBRARY):
        monkeypatch.setattr(jnative, "_TRIED", False)
        monkeypatch.setattr(jnative, "_LIB", None)
        jnative.load_library(build_if_missing=False)
    if jnative.load_library() is None or tnative.load_library() is None:
        monkeypatch.setenv("TPU_PATHTRACER_NO_NATIVE", "1")
        return "numpy"
    return "native"


def jax_config(config):
    """The JAX package's RenderConfig with the field values of the port's
    ``config`` (the same keywords, IntersectTuning included), for the JAX
    side of a comparison; the port takes its own config."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    fields["tuning"] = jax_cfg.IntersectTuning(**dataclasses.asdict(config.tuning))
    return jax_cfg.RenderConfig(**fields)


def jax_scene_arrays(scene):
    """The JAX scene pytree flattened to numpy under dotted field paths,
    plus its static fields (the bridge's input format)."""
    out, statics = {}, {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(v, prefix + f.name + ".")
            elif f.metadata.get("static"):
                statics[f.name] = v
            elif v is not None:
                out[prefix + f.name] = np.asarray(v)

    walk(scene, "")
    return out, statics


def scene_arrays(scene):
    """The port scene's tensors as numpy under the same dotted keys (plus
    its two integer scalars as 0-d int32 arrays)."""
    out = {}

    def walk(obj, prefix):
        for name, v in vars(obj).items():
            key = prefix + name
            if isinstance(v, torch.Tensor):
                out[key] = v.numpy()
            elif isinstance(v, (ttypes.Camera, ttypes.TextureAtlas, ttypes.LightSet)):
                walk(v, key + ".")
            elif key in ("env_tex", "lights.count"):
                out[key] = np.asarray(v, dtype=np.int32)

    walk(scene, "")
    return out


def _load_both(tmp_path, name, w=24, h=16):
    path = FIXTURES[name](str(tmp_path / name / "scene.gltf"))
    js = jax_parse(path, w / h)
    ts = torch_parse(path, w / h)
    return js, ts


def _assert_loaders_bit_equal(tmp_path, name):
    """Every array the port holds equals the JAX loader's, bit for bit
    (NaN padding included), and so do the static fields."""
    js, ts = _load_both(tmp_path, name)
    want, statics = jax_scene_arrays(js)
    got = scene_arrays(ts)
    assert set(got) <= set(want), set(got) - set(want)
    assert "atlas.quad" in got and "chunk_woop" in got
    for key, arr in got.items():
        ref = want[key]
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, key
        np.testing.assert_array_equal(arr, ref, err_msg=key)
    assert ts.ray_depth == statics["ray_depth"] and ts.has_env == statics["has_env"]
    assert ts.tex_slots == statics["tex_slots"]
    if name == "sphere_field":
        assert ts.capacity > 1024


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_torch_loader_bit_equal(tmp_path, monkeypatch, name):
    """Every array the port holds equals the JAX loader's, bit for bit
    (NaN padding included), and so do the static fields."""
    same_host_path(monkeypatch)
    _assert_loaders_bit_equal(tmp_path, name)


@pytest.mark.parametrize("name", ["cornell", "sphere_field"])
@pytest.mark.parametrize("library", ["raced", "unavailable"])
def test_torch_loader_bit_equal_after_failed_jax_load(tmp_path, monkeypatch, library, name):
    """The JAX package's library failed to load earlier in this process, as
    when another process was still writing it (``_TRIED`` set, ``_LIB``
    None): through ``same_host_path`` the loaders still agree bit for bit,
    natively after the retry finds the library ("raced"), through numpy
    when it stays unavailable."""
    loaded = jnative.load_library() is not None and tnative.load_library() is not None
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB", None)
    if library == "unavailable":
        monkeypatch.setattr(jnative, "load_library", lambda build_if_missing=True: None)
    path = same_host_path(monkeypatch)
    if library == "unavailable":
        assert path == "numpy"
    elif loaded:  # the file loaded before, so the retry finds it whole
        assert path == "native"
    _assert_loaders_bit_equal(tmp_path, name)


def test_torch_bridge_round_trip(tmp_path, monkeypatch):
    """JAX scene -> numpy -> scene_from_arrays equals the port's own load of
    the same file, array by array."""
    same_host_path(monkeypatch)
    js, ts = _load_both(tmp_path, "textured_cornell")
    js = dataclasses.replace(js, camera=js.camera.with_dims(24, 16))
    arrays, statics = jax_scene_arrays(js)
    bridged = scene_from_arrays(arrays, {**statics, "width": 24, "height": 16})
    assert (bridged.camera.width, bridged.camera.height) == (24, 16)
    assert bridged.tex_slots == ts.tex_slots and bridged.lights.count == ts.lights.count
    mine, back = scene_arrays(ts), scene_arrays(bridged)
    assert set(mine) == set(back)
    for key in mine:
        np.testing.assert_array_equal(back[key], mine[key], err_msg=key)
        assert back[key].dtype == mine[key].dtype, key


@pytest.mark.parametrize(
    "field", ["use_env_map", "use_env_map_hdr", "add_light_triangle", "env_map_and_light_triangle"]
)
def test_torch_loader_rejects_unported_options(tmp_path, monkeypatch, field):
    """The loader's lighting options: the environment map (PNG, or Radiance
    HDR through the package's codec) added to the atlas, and the extra
    camera-space light triangle, load bit-equal to the JAX loader, array by
    array."""
    change = {}
    if field != "add_light_triangle":
        png = field != "use_env_map_hdr"
        make = make_env_image if png else make_env_hdr
        change = {"use_env_map": True,
                  "env_map_path": make(str(tmp_path / ("env.png" if png else "env.hdr")))}
    if field in ("add_light_triangle", "env_map_and_light_triangle"):
        change["add_light_triangle"] = True
    config = dataclasses.replace(RenderConfig(), **change)
    same_host_path(monkeypatch)
    path = make_cornell_gltf(str(tmp_path / "c" / "c.gltf"))
    js, ts = jax_parse(path, 1.0, jax_config(config)), torch_parse(path, 1.0, config)
    want, statics = jax_scene_arrays(js)
    got = scene_arrays(ts)
    assert set(got) <= set(want), set(got) - set(want)
    for key, arr in got.items():
        assert arr.dtype == want[key].dtype and arr.shape == want[key].shape, key
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
    assert ts.has_env == statics["has_env"] == config.use_env_map
    assert ts.env_tex == int(want["env_tex"]) and ts.tex_slots == statics["tex_slots"]
    assert ts.lights.count == 2 + config.add_light_triangle
