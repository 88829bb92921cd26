"""The port's homebrew path on the CPU: the ``.txt`` parser, the analytic
primitive intersector, the folded-key draws, and the Whitted and
Monte-Carlo integrators, each against the JAX package on the same inline
scenes, plus the analytic oracles of ``tests/test_legacy_oracle.py`` and
inline stand-ins for the reference's sample scenes (not in the repo)."""

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.models import legacy as jlegacy
from tpu_pathtracer.models.pathtracer import per_pixel_uniforms as jax_per_pixel_uniforms
from tpu_pathtracer.ops import primitives as jprim
from tpu_pathtracer.scene.homebrew import parse_homebrew_scene as jax_parse
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models import legacy
from tpu_pathtracer_torch.ops import primitives, rng
from tpu_pathtracer_torch.scene import types as T
from tpu_pathtracer_torch.scene.homebrew import parse_homebrew_scene
from tpu_pathtracer_torch.utils.image import quantize_u8

torch.set_num_threads(1)

_CAMERA = """
CAMERA_POSITION 0 1 4
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.2
"""

# Every primitive kind (rotated and moved), every material kind, both light
# kinds (the point light attenuated), and an unknown keyword.
_PRIMS = """
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.6 0.8 0.6
NEW_PRIMITIVE
ELLIPSOID 0.6 0.9 0.6
POSITION -1 0.9 0
ROTATION 0 0.3826834 0 0.9238795
COLOR 1 0.3 0.3
DIELECTRIC
IOR 1.5
NEW_PRIMITIVE
BOX 0.4 0.4 0.4
POSITION 1 0.4 -0.5
ROTATION 0.2 0.3 0.1 0.9273618
COLOR 0.9 0.9 0.3
METALLIC
NEW_PRIMITIVE
TRIANGLE -2 0 -2 2 0 -2 0 3 -2
{tri}
NEW_PRIMITIVE
ELLIPSOID 0.3 0.3 0.3
POSITION 0.2 0.3 1
COLOR 0.8 0.8 0.8
DIELECTRIC
IOR 1.33
FOO 1 2 3
"""

_LIGHTS = """
AMBIENT_LIGHT 0.1 0.1 0.1
NEW_LIGHT
LIGHT_POSITION 1 4 2
LIGHT_INTENSITY 6 6 6
LIGHT_ATTENUATION 1 0.1 0.05
NEW_LIGHT
LIGHT_DIRECTION 0.3 1 0.2
LIGHT_INTENSITY 0.5 0.5 0.4
"""

SCENES = {
    # Whitted (no SAMPLES), lit: reflections, refractions, shadows.
    "whitted": "DIMENSIONS 16 16\nRAY_DEPTH 4\nBG_COLOR 0.1 0.2 0.4\n" + _LIGHTS + _CAMERA
    + _PRIMS.format(tri="COLOR 0.3 0.3 1"),
    # Whitted without lights: stage-1 flat colors.
    "flat": "DIMENSIONS 16 12\nBG_COLOR 0 0 0.5\n" + _CAMERA + _PRIMS.format(tri="COLOR 0 1 0"),
    # Monte-Carlo: the triangle is the emitter.
    "mc": "DIMENSIONS 16 16\nRAY_DEPTH 4\nSAMPLES 8\nBG_COLOR 0.3 0.3 0.35\n" + _CAMERA
    + _PRIMS.format(tri="COLOR 0 0 0\nEMISSION 4 3 2"),
}


def _write(tmp_path, name, text):
    path = tmp_path / f"{name}.txt"
    path.write_text(textwrap.dedent(text))
    return str(path)


def _parse_both(tmp_path, name):
    path = _write(tmp_path, name, SCENES[name])
    return jax_parse(path), parse_homebrew_scene(path)


def _u8(hdr):
    return quantize_u8(torch.from_numpy(np.ascontiguousarray(hdr))).numpy().astype(int)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """{scene: (JAX HDR, port HDR)} of the Whitted and Monte-Carlo scenes at
    16x16 (the JAX renders are compiled once per module)."""
    tmp = tmp_path_factory.mktemp("legacy")
    out = {}
    for name in ("whitted", "mc"):
        js, ts = _parse_both(tmp, name)
        out[name] = (jlegacy.render_homebrew(js, seed=3), legacy.render_homebrew(ts, seed=3))
    return out


# --- parser -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENES))
def test_torch_homebrew_parse_matches_jax(tmp_path, name, capsys):
    """Field by field, exactly: arrays (values, dtypes, padding), camera,
    ray depth, samples, lit; the unknown keyword warned about as in JAX."""
    js, ts = _parse_both(tmp_path, name)
    assert capsys.readouterr().err.count("WARN: unknown scene keyword 'FOO'") == 2
    for f in dataclasses.fields(js):
        want, got = getattr(js, f.name), getattr(ts, f.name)
        if f.name == "camera":
            for g in ("position", "right", "up", "forward", "fov_x"):
                a, b = np.asarray(getattr(want, g)), getattr(got, g).numpy()
                assert a.dtype == b.dtype and np.array_equal(a, b), g
            assert (got.width, got.height) == (want.width, want.height)
        elif isinstance(got, torch.Tensor):
            a, b = np.asarray(want), got.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert got == want, f.name
    assert ts.capacity == 8 and int(ts.valid.sum()) == 5
    assert ts.monte_carlo == (name == "mc") and ts.lit == (name == "whitted")


def test_torch_homebrew_defaults_and_padding(tmp_path):
    """An empty scene: the reference's defaults (640x480, depth 1, Whitted,
    unlit), 8 primitive slots and one empty slot per light kind."""
    path = _write(tmp_path, "empty", "\n")
    want, got = jax_parse(path), parse_homebrew_scene(path)
    assert (got.camera.width, got.camera.height, got.ray_depth) == (640, 480, 1)
    assert not got.monte_carlo and not got.lit and got.capacity == 8
    for key in ("dir_light_dir", "point_light_atten", "point_light_valid", "rotation", "ior"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(want, key)))


def test_torch_homebrew_scene_to_device_keeps_python_fields(tmp_path):
    _, ts = _parse_both(tmp_path, "mc")
    moved = ts.to("cpu")
    assert moved.samples == 8 and moved.ray_depth == 4 and moved.lit is False
    assert moved.camera.position.device.type == "cpu" and moved.device.type == "cpu"


# --- primitives ----------------------------------------------------------------


def _one_prim_scene(tmp_path, block):
    path = _write(tmp_path, "one", "NEW_PRIMITIVE\n" + block)
    return jax_parse(path), parse_homebrew_scene(path)


_ONE = {
    "plane": "PLANE 0.2 1 0.1\nPOSITION 0 -0.5 0",
    "ellipsoid": "ELLIPSOID 0.8 0.5 1.1\nPOSITION 0.1 0 0.2\nROTATION 0 0.3826834 0 0.9238795",
    "box": "BOX 0.6 0.4 0.9\nPOSITION 0 0.1 0\nROTATION 0.2 0.3 0.1 0.9273618",
    "triangle": "TRIANGLE -1 -1 0 1 -1 0.2 0 1 -0.3\nROTATION 0.1 0 0.2 0.9746794",
}


@pytest.mark.parametrize("kind", sorted(_ONE) + ["all"])
def test_torch_primitive_closest_hit_matches_jax(tmp_path, kind):
    """Seeded random rays (origins inside and outside the solids) against one
    primitive of each kind, and against the five-primitive scene: hit mask,
    primitive, inside flag equal; t to 2e-5 relative; normals to 1e-4."""
    if kind == "all":
        js, ts = _parse_both(tmp_path, "whitted")
    else:
        js, ts = _one_prim_scene(tmp_path, _ONE[kind])
    rs = np.random.default_rng(7)
    n = 4096
    o = rs.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[: n // 4] *= 0.1  # near the primitives' centres: rays start inside
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jprim.closest_hit(jnp.asarray(o), jnp.asarray(d), js, 1e-4)
    got = primitives.closest_hit(torch.from_numpy(o), torch.from_numpy(d), ts, 1e-4)
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.05
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.prim.numpy()[hit], np.asarray(want.prim)[hit])
    np.testing.assert_array_equal(got.inside.numpy()[hit], np.asarray(want.inside)[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit], atol=1e-4)
    if kind in ("ellipsoid", "box"):
        assert got.inside.numpy()[hit].any()


def test_torch_primitive_closest_hit_slices(monkeypatch, tmp_path):
    """Rays in slices of PAIR_BUDGET // P give the unsliced result exactly."""
    _, ts = _parse_both(tmp_path, "whitted")
    rs = np.random.default_rng(1)
    o = torch.from_numpy(rs.uniform(-2, 2, (1000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rs.normal(size=(1000, 3)).astype(np.float32)),
                                      dim=1)
    whole = primitives.closest_hit(o, d, ts, 1e-4)
    monkeypatch.setattr(primitives, "PAIR_BUDGET", 8 * 96)  # 96 rays a slice
    sliced = primitives.closest_hit(o, d, ts, 1e-4)
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)


# --- draws ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 2**33 + 7])
def test_torch_fold_in_bit_equal(seed):
    """fold_in on key words equals jax.random.fold_in, along the homebrew
    key chain: sample keys, their jitter keys and bounce keys."""
    key = jax.random.key(seed)
    words = rng.key_words(seed)
    for n in (0, 1, 5, 31, 0x7FFFFFFF):
        k = jax.random.fold_in(key, n)
        got = rng.fold_in(*words, n)
        assert got == tuple(int(x) for x in jax.random.key_data(k))
        for m in (0, 3, 0x7FFFFFFF):
            want = jax.random.key_data(jax.random.fold_in(k, m))
            assert rng.fold_in(*got, m) == tuple(int(x) for x in want)


@pytest.mark.parametrize("n_draws", [2, 4, 5])
def test_torch_per_pixel_uniforms_bit_equal(n_draws):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(9), 4), 2)
    words = tuple(int(x) for x in jax.random.key_data(key))
    pixels = np.random.default_rng(2).integers(0, 2**20, 777).astype(np.int32)
    want = np.asarray(jax_per_pixel_uniforms(key, jnp.asarray(pixels), n_draws))
    got = rng.per_pixel_uniforms(*words, torch.from_numpy(pixels), n_draws).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_torch_lane_uniforms_key_form_is_seed_form():
    pixels = torch.arange(100, dtype=torch.int32)
    for seed in (0, 11):
        a = rng.lane_uniforms(seed, 3, 2, pixels, 6)
        b = rng.lane_uniforms_key(*rng.key_words(seed), 3, 2, pixels, 6)
        assert torch.equal(a, b)


def test_torch_schlick_refract_bit_equal():
    """The Fresnel term and the refraction, with x ** 5 written as XLA
    evaluates it, round as the JAX functions do."""
    rs = np.random.default_rng(4)
    cos_i = rs.uniform(0, 1, 5000).astype(np.float32)
    ior = rs.uniform(1.0, 2.5, 5000).astype(np.float32)
    want = np.asarray(jlegacy._schlick(jnp.asarray(cos_i), jnp.asarray(ior)))
    got = legacy._schlick(torch.from_numpy(cos_i), torch.from_numpy(ior)).numpy()
    np.testing.assert_array_equal(got, want)
    d = rs.normal(size=(5000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = np.tile(np.array([[0, 1, 0]], np.float32), (5000, 1))
    ci = np.maximum(0, -(d * n).sum(1)).astype(np.float32)
    eta = (1 / ior).astype(np.float32)
    wd, wt = jlegacy._refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta), jnp.asarray(ci))
    gd, gt = legacy._refract(*(torch.from_numpy(x) for x in (d, n, eta, ci)))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6, atol=1e-6)


# --- renders against the JAX package ---------------------------------------------


def test_torch_whitted_render_matches_jax(renders):
    """Whitted at 16x16, depth 4 (reflection, refraction, total internal
    reflection, shadows of both light kinds): to 1e-4 absolute in HDR, the
    u8 images equal."""
    want, got = renders["whitted"]
    assert got.shape == (16, 16, 3) and np.isfinite(got).all() and got.max() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_u8(got), _u8(want))


def test_torch_mc_render_matches_jax(renders):
    """Monte-Carlo at 16x16, 8 spp, depth 4, the same draws: the u8 images
    agree to the render tests' fp-noise rule (at most 0.5% of channels off
    by more than 1; a dielectric coin compares a draw against a float
    rounded in another order, so one coin may flip), means within 0.1."""
    want, got = renders["mc"]
    assert np.isfinite(got).all() and got.max() > 0.5
    diff = np.abs(_u8(want) - _u8(got))
    assert (diff > 1).mean() <= 0.005
    assert abs(_u8(want).mean() - _u8(got).mean()) < 0.1


def test_torch_homebrew_chunks_and_padding(tmp_path, renders):
    """Pixel chunks of 100 lanes (a padded tail of 56) give the one-chunk
    frame exactly, for both integrators; depth 0 returns the background."""
    for name in ("whitted", "mc"):
        _, ts = _parse_both(tmp_path, name)
        got = legacy.render_homebrew(ts, seed=3, config=RenderConfig(rays_per_batch=100))
        np.testing.assert_array_equal(got, renders[name][1])
    bg = legacy.render_homebrew(dataclasses.replace(ts, ray_depth=0))
    np.testing.assert_array_equal(bg, np.broadcast_to(ts.bg_color.numpy(), (16, 16, 3)))


# --- analytic oracles (tests/test_legacy_oracle.py on the port) -----------------

_MC_HEADER = """
DIMENSIONS 16 16
RAY_DEPTH 6
SAMPLES {samples}
BG_COLOR {bg}
CAMERA_POSITION 0 0 0
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.0
"""


def _render_center(tmp_path, extra, samples=8, bg="1 1 1"):
    # A triangle spanning x, y in [-8, 8] at z = -4 fills the 1.0-rad view.
    text = (_MC_HEADER.format(samples=samples, bg=bg)
            + "NEW_PRIMITIVE\nTRIANGLE -8 -8 -4 8 -8 -4 0 16 -4\n" + extra)
    img = legacy.render_homebrew(parse_homebrew_scene(_write(tmp_path, "oracle", text)), seed=0)
    return img[4:12, 4:12]  # central pixels, all on the triangle


@pytest.mark.parametrize("material,samples,want", [
    ("COLOR 0.25 0.5 0.75\n", 8, [0.25, 0.5, 0.75]),  # diffuse: L = albedo
    ("COLOR 0.6 0.3 0.9\nMETALLIC\n", 2, [0.6, 0.3, 0.9]),  # mirror: L = tint
    ("COLOR 1 1 1\nDIELECTRIC\nIOR 1.5\n", 4, [1.0, 1.0, 1.0]),  # Schlick split conserves
], ids=["diffuse", "metallic", "dielectric"])
def test_torch_mc_white_furnace(tmp_path, material, samples, want):
    """One convex primitive under a uniform white background: every path
    escapes to the background, so each pixel is exact (zero variance)."""
    px = _render_center(tmp_path, material, samples)
    np.testing.assert_allclose(px, np.broadcast_to(want, px.shape), rtol=0, atol=1e-5)


def test_torch_mc_emission_exact(tmp_path):
    px = _render_center(tmp_path, "COLOR 0 0 0\nEMISSION 2 0.5 0.125\n", samples=2, bg="0 0 0")
    np.testing.assert_allclose(px, np.broadcast_to([2.0, 0.5, 0.125], px.shape), rtol=0, atol=1e-5)


def test_torch_whitted_plane_lights_closed_form(tmp_path):
    """Ambient + attenuated point light + directional light on a diffuse
    plane against the closed form at the exact hit points."""
    ambient = np.array([0.05, 0.1, 0.15])
    color = np.array([0.5, 0.25, 1.0])
    lpos = np.array([0.0, 3.0, -5.0])
    lint = np.array([4.0, 3.0, 2.0])
    att = np.array([1.0, 0.5, 0.25])
    dint = np.array([0.125, 0.25, 0.5])
    text = f"""
        DIMENSIONS 8 8
        RAY_DEPTH 1
        BG_COLOR 0 0 0
        AMBIENT_LIGHT {ambient[0]} {ambient[1]} {ambient[2]}
        CAMERA_POSITION 0 2 0
        CAMERA_RIGHT 1 0 0
        CAMERA_UP 0 0 -1
        CAMERA_FORWARD 0 -1 0
        CAMERA_FOV_X 0.8
        NEW_LIGHT
        LIGHT_POSITION {lpos[0]} {lpos[1]} {lpos[2]}
        LIGHT_INTENSITY {lint[0]} {lint[1]} {lint[2]}
        LIGHT_ATTENUATION {att[0]} {att[1]} {att[2]}
        NEW_LIGHT
        LIGHT_DIRECTION 0 1 0
        LIGHT_INTENSITY {dint[0]} {dint[1]} {dint[2]}
        NEW_PRIMITIVE
        PLANE 0 1 0
        COLOR {color[0]} {color[1]} {color[2]}
        """
    img = legacy.render_homebrew(parse_homebrew_scene(_write(tmp_path, "plane", text)), seed=0)
    w = h = 8
    tx = np.tan(0.8 / 2)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    cx = (2 * (xs + 0.5) / w - 1) * tx
    cy = (2 * (ys + 0.5) / h - 1) * tx
    dirs = cx[..., None] * np.array([1.0, 0, 0]) - cy[..., None] * np.array([0.0, 0, -1.0]) \
        + np.array([0.0, -1.0, 0])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    eye = np.array([0.0, 2.0, 0.0])
    hitp = eye + (-eye[1] / dirs[..., 1])[..., None] * dirs
    lvec = lpos - hitp
    dist = np.linalg.norm(lvec, axis=-1)
    lam = np.maximum(0.0, (lvec / dist[..., None]) @ np.array([0.0, 1.0, 0.0]))
    irr = ambient + lint * (lam / (att[0] + att[1] * dist + att[2] * dist**2))[..., None] + dint
    np.testing.assert_allclose(img, (color * irr).astype(np.float32), rtol=2e-4, atol=2e-5)


def test_torch_whitted_occluded_plane(tmp_path):
    """A box between the plane and the point light leaves only ambient."""
    text = """
        DIMENSIONS 4 4
        RAY_DEPTH 1
        BG_COLOR 0 0 0
        AMBIENT_LIGHT 0.25 0.25 0.25
        CAMERA_POSITION 0 2 0
        CAMERA_RIGHT 1 0 0
        CAMERA_UP 0 0 -1
        CAMERA_FORWARD 0 -1 0
        CAMERA_FOV_X 0.2
        NEW_LIGHT
        LIGHT_POSITION 0 5 0
        LIGHT_INTENSITY 10 10 10
        LIGHT_ATTENUATION 1 0 0
        NEW_PRIMITIVE
        PLANE 0 1 0
        COLOR 1 1 1
        NEW_PRIMITIVE
        BOX 2 0.1 2
        POSITION 0 3.5 0
        COLOR 1 0 0
        """
    img = legacy.render_homebrew(parse_homebrew_scene(_write(tmp_path, "shadow", text)), seed=0)
    np.testing.assert_allclose(img, 0.25, rtol=0, atol=1e-5)


# --- stand-ins for the reference's sample scenes (tests/test_legacy.py and the
# homebrew loader tests of tests/test_scene_loaders.py) --------------------------

# scene-000's shape: flat-colored plane, ellipsoid and box over a blue sky.
_SCENE000 = """
DIMENSIONS 640 480
BG_COLOR 0 0 0.5
CAMERA_POSITION 0 2 6
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.2
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0 1 0
NEW_PRIMITIVE
ELLIPSOID 0.8 0.8 0.8
POSITION -1.5 2 0
COLOR 1 0 0
NEW_PRIMITIVE
BOX 0.6 0.6 0.6
POSITION 1.5 2.5 0
COLOR 1 1 0
"""

# practice2's shape: a glass ball and a mirror box on a lit floor.
_PRACTICE2 = "DIMENSIONS 64 36\nRAY_DEPTH 6\nBG_COLOR 0.2 0.3 0.5\n" + _LIGHTS + _CAMERA + """
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.7 0.7 0.7
NEW_PRIMITIVE
ELLIPSOID 0.7 0.7 0.7
POSITION -0.6 0.7 0
COLOR 0.9 1 0.9
DIELECTRIC
IOR 1.5
NEW_PRIMITIVE
BOX 0.5 0.5 0.5
POSITION 0.9 0.5 -0.6
COLOR 0.9 0.9 0.9
METALLIC
"""

# practice5's shape: Monte-Carlo, an emissive triangle over a floor.
_PRACTICE5 = "DIMENSIONS 48 36\nRAY_DEPTH 6\nSAMPLES 512\nBG_COLOR 0.9 0.9 0.9\n" + _CAMERA + """
NEW_PRIMITIVE
PLANE 0 1 0
COLOR 0.4 0.5 0.8
NEW_PRIMITIVE
TRIANGLE -1 2 -1 1 2 -1 0 2 1
COLOR 0 0 0
EMISSION 5 5 5
NEW_PRIMITIVE
ELLIPSOID 0.5 0.5 0.5
POSITION 0 0.5 0
COLOR 0.8 0.6 0.4
"""


def test_torch_homebrew_stand_in_scenes_parse(tmp_path):
    """Each stand-in parses: camera set, primitives valid, the Monte-Carlo
    one in Monte-Carlo mode with its emitter."""
    for name, text in (("s000", _SCENE000), ("p2", _PRACTICE2), ("p5", _PRACTICE5)):
        scene = parse_homebrew_scene(_write(tmp_path, name, text))
        assert scene.camera.width > 0 and int(scene.valid.sum()) == 3
        assert scene.monte_carlo == (name == "p5")


def test_torch_homebrew_scene000_fields(tmp_path):
    scene = parse_homebrew_scene(_write(tmp_path, "s000", _SCENE000))
    assert scene.camera.width == 640 and scene.camera.height == 480
    np.testing.assert_allclose(scene.bg_color.numpy(), [0, 0, 0.5])
    kinds = scene.kind[scene.valid].tolist()
    assert set(kinds) == {T.PRIM_PLANE, T.PRIM_ELLIPSOID, T.PRIM_BOX}
    assert not scene.monte_carlo and scene.ray_depth == 1 and not scene.lit


def test_torch_homebrew_practice5_is_mc(tmp_path):
    scene = parse_homebrew_scene(_write(tmp_path, "p5", _PRACTICE5))
    assert scene.monte_carlo and scene.samples == 512 and scene.ray_depth == 6
    assert (scene.emission[scene.valid].sum(dim=-1) > 0).any()


def _render_file(path, w, h, seed=0, **kw):
    scene = parse_homebrew_scene(path)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(w, h), **kw)
    return legacy.render_homebrew(scene, seed=seed)


def test_torch_scene000_flat_colors(tmp_path):
    """Unlit Whitted: flat primitive colors over the background."""
    img = _u8(_render_file(_write(tmp_path, "s000", _SCENE000), 160, 120))
    np.testing.assert_array_equal(img[0, 0], [0, 0, 205])  # bg (0, 0, 0.5)
    np.testing.assert_array_equal(img[115, 80], [0, 231, 0])  # green plane
    np.testing.assert_array_equal(img[59, 50], [231, 0, 0])  # red ellipsoid
    np.testing.assert_array_equal(img[49, 110], [231, 231, 0])  # yellow box


def test_torch_lit_whitted_is_shaded(tmp_path):
    """Lit Whitted: diffuse shading and shadows, not flat fills."""
    hdr = _render_file(_write(tmp_path, "p2", _PRACTICE2), 48, 32, ray_depth=1)
    assert np.isfinite(hdr).all() and hdr.max() > 0
    assert len(np.unique(_u8(hdr).reshape(-1, 3), axis=0)) > 30


def test_torch_whitted_dielectric_and_metal(tmp_path):
    hdr = _render_file(_write(tmp_path, "p2", _PRACTICE2), 64, 36, ray_depth=4)
    assert np.isfinite(hdr).all() and hdr.max() > 0.1


def test_torch_whitted_depth_past_stack_floor(tmp_path):
    """RAY_DEPTH past the 12-slot stack floor is not truncated: the stack
    has depth + 1 slots, and depth 16 is converged against depth 20."""
    path = _write(tmp_path, "p2", _PRACTICE2)
    a = _render_file(path, 48, 27, ray_depth=16)
    b = _render_file(path, 48, 27, ray_depth=20)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_torch_whitted_repeatable(tmp_path):
    path = _write(tmp_path, "w", SCENES["whitted"])
    np.testing.assert_array_equal(_render_file(path, 32, 24), _render_file(path, 32, 24))


def test_torch_mc_seeds_converge(tmp_path):
    """Two seeds, independent streams of one estimator: the means agree
    within Monte-Carlo noise."""
    path = _write(tmp_path, "p5", _PRACTICE5)
    a = _render_file(path, 24, 18, seed=0, samples=64)
    b = _render_file(path, 24, 18, seed=1, samples=64)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
