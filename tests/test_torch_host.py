"""The port's own host modules against the JAX package's originals: the
configuration dataclasses and their environment overrides, the fixture
generators (byte-identical files), the spatial build (native packer and
numpy paths), the Radiance HDR codec and the render metrics."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

from tpu_pathtracer import config as jcfg
from tpu_pathtracer.scene import accel as jaccel
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils import fuzz as jfuzz
from tpu_pathtracer.utils import hdr as jhdr
from tpu_pathtracer.utils import metrics as jmetrics
from tpu_pathtracer.utils import testscenes
from tpu_pathtracer_torch import config as tcfg
from tpu_pathtracer_torch.scene import accel as taccel
from tpu_pathtracer_torch.scene import fixtures, native
from tpu_pathtracer_torch.scene.gltf import build_woop
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene as torch_parse
from tpu_pathtracer_torch.utils import fuzz as tfuzz
from tpu_pathtracer_torch.utils import hdr as thdr
from tpu_pathtracer_torch.utils import metrics as tmetrics
from test_torch_scene import same_host_path


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["IntersectTuning", "RenderConfig"])
def test_torch_config_fields_match_jax(name):
    """Same field names, in the same order, with the same defaults."""
    want, got = _fields(getattr(jcfg, name)), _fields(getattr(tcfg, name))
    if name == "RenderConfig":  # the tuning defaults are compared as IntersectTuning
        want = [(k, v if k != "tuning" else _fields(type(v))) for k, v in want]
        got = [(k, v if k != "tuning" else _fields(type(v))) for k, v in got]
    assert got == want
    assert tcfg._TUNING_ENV == jcfg._TUNING_ENV
    assert dataclasses.asdict(tcfg.DEFAULT_CONFIG) == dataclasses.asdict(jcfg.DEFAULT_CONFIG)


@pytest.mark.parametrize("env", [
    {},
    {"TPU_PT_INTERSECT": "twopass", "TPU_PT_CHEAP_RECHECK": "2"},
    {"TPU_PT_NEAR": "1,3,9", "TPU_PT_BINS_CAP": "3", "TPU_PT_SUB": "32"},
    {"TPU_PT_BUILD": "morton", "TPU_PT_CHUNK_TRIS": "64", "TPU_PT_QUAD_MAX": "0"},
], ids=["none", "mode_cheap", "ladder_bins_sub", "build"])
def test_torch_tuning_resolve_matches_jax(env, monkeypatch):
    """``resolve()`` applies the same TPU_PT_* overrides, parsed the same
    way, on top of the same non-default config values."""
    for key in jcfg._TUNING_ENV.values():
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    base = dict(mode="dense", pass1_min=7, gate_recheck=0)
    want = dataclasses.asdict(jcfg.IntersectTuning(**base).resolve())
    got = dataclasses.asdict(tcfg.IntersectTuning(**base).resolve())
    assert got == want
    for key, value in env.items():
        field = next(f for f, e in tcfg._TUNING_ENV.items() if e == key)
        assert str(got[field]) == value


def _same_tree(a, b):
    """Every file of directory ``a`` and ``b`` byte-identical (same names)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("name,kwargs", [
    ("make_cornell_gltf", {}),
    ("make_cornell_gltf", {"light_strength": 7.5}),
    ("make_sphere_field_gltf", {"n_spheres": 5, "subdiv": 2, "seed": 3}),
    ("make_sphere_field_gltf", {"n_spheres": 3, "subdiv": 2, "textured": True}),
    ("make_atrium_gltf", {"detail": 1, "textured": False}),
    ("make_atrium_gltf", {"detail": 1, "textured": True}),
    ("make_textured_cornell_gltf", {}),
], ids=["cornell", "cornell_light", "field", "field_textured", "atrium", "atrium_textured",
        "textured_cornell"])
def test_torch_fixture_files_match_jax(tmp_path, name, kwargs):
    """Each glTF generator writes byte-identical .gltf, .bin and textures."""
    want = getattr(testscenes, name)(str(tmp_path / "jax" / "s.gltf"), **kwargs)
    got = getattr(fixtures, name)(str(tmp_path / "port" / "s.gltf"), **kwargs)
    assert os.path.basename(got) == os.path.basename(want)
    _same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("name,suffix", [("make_env_image", "png"), ("make_env_hdr", "hdr")])
def test_torch_env_fixtures_match_jax(tmp_path, name, suffix):
    want = getattr(testscenes, name)(str(tmp_path / f"jax.{suffix}"))
    got = getattr(fixtures, name)(str(tmp_path / f"port.{suffix}"))
    assert filecmp.cmp(want, got, shallow=False)


def _soup(seed, n=700):
    """A triangle soup with a padding tail (invalid rows at 1e30), as the
    loader hands it to the build."""
    rs = np.random.default_rng(seed)
    cap = -(-n // 128) * 128 + 128
    verts = np.full((cap, 3, 3), 1e30, np.float32)
    c = rs.uniform(-10, 10, (n, 1, 3))
    verts[:n] = (c + rs.normal(scale=0.4, size=(n, 3, 3))).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return verts, valid


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_torch_accel_matches_jax(use_native, monkeypatch):
    """The spatial build's five functions return equal arrays to the JAX
    package's, through the native packer and through numpy (both packages
    on the same path: ``same_host_path``)."""
    if use_native:
        monkeypatch.delenv("TPU_PATHTRACER_NO_NATIVE", raising=False)
        assert native.load_library() is not None
        same_host_path(monkeypatch)
    else:
        monkeypatch.setenv("TPU_PATHTRACER_NO_NATIVE", "1")
    assert taccel.LEAF_SIZE == jaccel.LEAF_SIZE
    for seed in (0, 1):
        verts, valid = _soup(seed)
        for fn in ("morton_order", "sah_chunk_order"):
            np.testing.assert_array_equal(getattr(taccel, fn)(verts, valid),
                                          getattr(jaccel, fn)(verts, valid), err_msg=fn)
        perm = taccel.sah_chunk_order(verts, valid)
        lmin, lmax = taccel.build_leaves(verts[perm], valid[perm])
        want = jaccel.build_leaves(verts[perm], valid[perm])
        np.testing.assert_array_equal(lmin, want[0])
        np.testing.assert_array_equal(lmax, want[1])
        for per in (8, 3):  # 3 leaves per chunk pads the last chunk
            got = taccel.chunk_aabbs(lmin, lmax, per)
            want = jaccel.chunk_aabbs(lmin, lmax, per)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert np.isnan(got[0]).any()  # the padding tail's chunks


def test_torch_native_packer_matches_numpy(monkeypatch):
    """The port's native packer against its own numpy paths: Morton order,
    Woop matrix (NaN rows of invalid triangles included) and leaf boxes
    equal; the SAH order a permutation of the same valid rows."""
    verts, valid = _soup(5)
    native_out = (taccel.morton_order(verts, valid), build_woop(verts, valid),
                  taccel.build_leaves(verts, valid), taccel.sah_chunk_order(verts, valid))
    monkeypatch.setenv("TPU_PATHTRACER_NO_NATIVE", "1")
    numpy_out = (taccel.morton_order(verts, valid), build_woop(verts, valid),
                 taccel.build_leaves(verts, valid), taccel.sah_chunk_order(verts, valid))
    np.testing.assert_array_equal(native_out[0], numpy_out[0])
    np.testing.assert_allclose(native_out[1], numpy_out[1], rtol=2e-5, atol=1e-5)
    assert np.array_equal(np.isnan(native_out[1]), np.isnan(numpy_out[1]))
    np.testing.assert_array_equal(native_out[2][0], numpy_out[2][0])
    np.testing.assert_array_equal(native_out[2][1], numpy_out[2][1])
    n = int(valid.sum())
    assert sorted(native_out[3][:n]) == sorted(numpy_out[3][:n]) == list(range(n))


def test_torch_native_packer_builds_in_build_dir():
    """The packer library lives in the git-ignored build directory beside
    the CUDA kernels, with a stamp of its source hash, and not in the JAX
    package's ``native/``."""
    assert native.build()
    assert os.path.dirname(native.LIBRARY).endswith(os.path.join("build", "tpu_pathtracer_torch"))
    assert os.path.exists(native.LIBRARY + ".sha256")
    assert native.SOURCE.endswith(os.path.join("tpu_pathtracer_torch", "csrc", "accel_pack.cpp"))


def test_torch_hdr_codec_matches_jax(tmp_path):
    """``load_hdr_rgba_ldr`` and ``read_hdr`` give equal arrays on the sky
    fixture and on a written random image; ``write_hdr`` equal bytes."""
    rs = np.random.default_rng(3)
    rgb = (rs.random((9, 17, 3)) * np.array([0.5, 3.0, 40.0])).astype(np.float32)
    paths = [thdr.write_hdr(str(tmp_path / "port.hdr"), rgb),
             jhdr.write_hdr(str(tmp_path / "jax.hdr"), rgb),
             fixtures.make_env_hdr(str(tmp_path / "sky.hdr"))]
    assert filecmp.cmp(paths[0], paths[1], shallow=False)
    for p in paths:
        for fn in ("load_hdr_rgba_ldr", "read_hdr"):
            got, want = getattr(thdr, fn)(p), getattr(jhdr, fn)(p)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("measured", [None, 123_456_789])
def test_torch_render_metrics_json_matches_jax(measured):
    kw = dict(width=640, height=480, samples=16, ray_depth=8, load_seconds=1.23456,
              render_seconds=9.87654, measured_rays=measured)
    got = json.loads(tmetrics.RenderMetrics(**kw).to_json())
    want = json.loads(jmetrics.RenderMetrics(**kw).to_json())
    assert list(got) == list(want) and got == want


# The seeds of tests/test_fuzz_parity.py, and the maximal asset.
FUZZ = [("make_fuzz_gltf", {"seed": s}) for s in (11, 23, 47, 104, 111, 117)] + [
    ("make_maximal_gltf", {"seed": 5})]
FUZZ_IDS = [f"fuzz{kw['seed']}" for _, kw in FUZZ[:-1]] + ["maximal"]


@pytest.mark.parametrize("name,kwargs", FUZZ, ids=FUZZ_IDS)
def test_torch_fuzz_files_match_jax(tmp_path, name, kwargs):
    """Each fuzz scene and the maximal asset: byte-identical .gltf, .bin and
    PNG / JPEG textures."""
    want = getattr(jfuzz, name)(str(tmp_path / "jax" / "s.gltf"), **kwargs)
    got = getattr(tfuzz, name)(str(tmp_path / "port" / "s.gltf"), **kwargs)
    assert os.path.basename(got) == os.path.basename(want)
    _same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("name,kwargs", FUZZ, ids=FUZZ_IDS)
def test_torch_loader_matches_jax_on_fuzz_scenes(tmp_path, monkeypatch, name, kwargs):
    """The port's glTF loader on each fuzz scene and on the maximal asset
    (strips, instanced and nested nodes, raw matrices, u8/u16/u32 indices,
    JPEG and PNG textures, every texture slot): every array it holds equals
    the JAX loader's, bit for bit, and so do the static fields."""
    from test_torch_scene import jax_scene_arrays, scene_arrays

    same_host_path(monkeypatch)
    path = getattr(tfuzz, name)(str(tmp_path / "s.gltf"), **kwargs)
    js, ts = jax_parse(path, 1.5), torch_parse(path, 1.5)
    want, statics = jax_scene_arrays(js)
    got = scene_arrays(ts)
    assert set(got) <= set(want), set(got) - set(want)
    for key, arr in got.items():
        assert arr.dtype == want[key].dtype and arr.shape == want[key].shape, key
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
    assert ts.ray_depth == statics["ray_depth"] and ts.tex_slots == statics["tex_slots"]
    if name == "make_maximal_gltf":
        assert ts.atlas.offset.shape[0] >= 66 and ts.tex_slots == (True,) * 4
        assert int(ts.valid.sum()) == 5 * 2 + 2 + 8 * 3 + 8 * 2 + 24 * 6
