"""The port's checkpoint/resume (``tpu_pathtracer_torch/parallel/checkpoint``)
on the CPU: interrupted renders equal uninterrupted ones, rejected files
are never blended in, the scene fingerprint is the JAX package's integer,
and a checkpoint written by either package is resumed by the other."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer import config as jax_cfg
from tpu_pathtracer.models.pathtracer import render as jax_render
from tpu_pathtracer.parallel import checkpoint as jax_ck
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils.image import quantize_u8 as jax_quantize
from tpu_pathtracer.utils.testscenes import (
    make_atrium_gltf,
    make_cornell_gltf,
    make_sphere_field_gltf,
    make_textured_cornell_gltf,
)
from tpu_pathtracer_torch import config as torch_cfg
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.models.pathtracer import render
from tpu_pathtracer_torch.parallel.checkpoint import (
    _EXECUTION_KNOBS,
    RenderState,
    render_with_checkpoints,
    scene_fingerprint,
)
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from tpu_pathtracer_torch.utils.image import quantize_u8
from test_torch_render import _assert_fp_noise
from test_torch_scene import same_host_path

torch.set_num_threads(1)

FIXTURES = {
    "cornell": make_cornell_gltf,
    "textured_cornell": make_textured_cornell_gltf,
    # 8 textured icospheres: several chunks and a real texture atlas.
    "sphere_field": lambda p: make_sphere_field_gltf(p, n_spheres=8, subdiv=2, textured=True),
    # 57k triangles, loads in well under a second in either package.
    "atrium": lambda p: make_atrium_gltf(p, detail=1),
}


def _both(path, monkeypatch, w=16, h=16):
    """The file loaded by each package at w x h, both on the same host build
    path (``same_host_path``): (JAX scene, port scene)."""
    same_host_path(monkeypatch)
    js = jax_parse(path, w / h)
    ts = parse_gltf_scene(path, w / h)
    return (dataclasses.replace(js, camera=js.camera.with_dims(w, h)),
            dataclasses.replace(ts, camera=ts.camera.with_dims(w, h)))


def _scene(tmp_path, w=16, h=16, make=make_cornell_gltf, name="c"):
    s = parse_gltf_scene(make(str(tmp_path / name / "scene.gltf")), w / h)
    return dataclasses.replace(s, camera=s.camera.with_dims(w, h))


def _u8(hdr):
    return np.asarray(jax_quantize(jnp.asarray(np.asarray(hdr)))).astype(int)


def test_torch_checkpointed_equals_render(tmp_path):
    scene = _scene(tmp_path)
    want = render(scene, spp=6, seed=5)
    got = render_with_checkpoints(scene, spp=6, seed=5, checkpoint_path=str(tmp_path / "ck.npz"),
                                  checkpoint_every=2)
    # Passes reassociate the per-pixel sample sum: ulp noise.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_torch_checkpointed_frame_pool_equals_render(tmp_path):
    """frame_pool pools the whole frame per pass inside the checkpoint loop
    too: the same paths, only the summation order moves."""
    scene = _scene(tmp_path, w=48, h=16)  # 768 pixels > one 512-lane chunk
    want = render(scene, spp=6, seed=5, config=RenderConfig(rays_per_batch=512))
    got = render_with_checkpoints(
        scene, spp=6, seed=5, config=RenderConfig(rays_per_batch=512, frame_pool=True),
        checkpoint_path=str(tmp_path / "ckfp.npz"), checkpoint_every=2,
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_torch_resume_after_interruption_bit_equal(tmp_path):
    scene = _scene(tmp_path)
    ck = str(tmp_path / "ck.npz")
    render_with_checkpoints(scene, spp=4, seed=9, checkpoint_path=ck, checkpoint_every=2)
    assert RenderState.load(ck).samples_done == 4
    resumed = render_with_checkpoints(scene, spp=8, seed=9, checkpoint_path=ck,
                                      checkpoint_every=2)
    whole = render_with_checkpoints(scene, spp=8, seed=9, checkpoint_path=str(tmp_path / "w.npz"),
                                    checkpoint_every=2)
    np.testing.assert_array_equal(resumed, whole)


def test_torch_mismatched_seed_checkpoint_ignored(tmp_path, capsys):
    scene = _scene(tmp_path)
    ck = str(tmp_path / "ck.npz")
    render_with_checkpoints(scene, spp=2, seed=1, checkpoint_path=ck)
    capsys.readouterr()
    got = render_with_checkpoints(scene, spp=2, seed=2, checkpoint_path=ck)
    err = capsys.readouterr().err
    assert err == (f"checkpoint {ck}: scene/config fingerprint or dims/seed mismatch — "
                   "ignoring it and restarting from sample 0\n")
    np.testing.assert_allclose(got, render(scene, spp=2, seed=2), rtol=0, atol=2e-5)


def test_torch_checkpoint_of_other_scene_rejected(tmp_path, capsys):
    """Same (W, H, seed), another scene: the fingerprint rejects the file."""
    a = _scene(tmp_path, name="a")
    b = _scene(tmp_path, make=make_textured_cornell_gltf, name="b")
    ck = str(tmp_path / "state.npz")
    render_with_checkpoints(a, spp=4, seed=5, checkpoint_path=ck)
    img = render_with_checkpoints(b, spp=4, seed=5, checkpoint_path=ck)
    assert "mismatch" in capsys.readouterr().err
    np.testing.assert_allclose(img, render(b, spp=4, seed=5), rtol=0, atol=1e-6)
    assert RenderState.load(ck).fingerprint == scene_fingerprint(b, RenderConfig())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_torch_fingerprint_equals_jax(tmp_path, monkeypatch, name):
    """The same integer as the JAX package's scene_fingerprint on the same
    file, under the default config and another estimator config."""
    js, ts = _both(FIXTURES[name](str(tmp_path / name / "scene.gltf")), monkeypatch)
    for kw in ({}, {"eps": 2e-4, "jitter": "sobol", "vndf_factor": 0.5}):
        assert scene_fingerprint(ts, RenderConfig(**kw)) == jax_ck.scene_fingerprint(
            js, jax_cfg.RenderConfig(**kw)), kw


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_torch_fingerprint_ignores_execution_knobs(tmp_path, monkeypatch, package):
    """Execution knobs leave the fingerprint alone, an estimator field
    (eps) changes it: in both packages, with the same knob list."""
    assert jax_ck._EXECUTION_KNOBS == _EXECUTION_KNOBS
    js, ts = _both(make_cornell_gltf(str(tmp_path / "c.gltf")), monkeypatch)
    scene, cfg, fingerprint = {
        "jax": (js, jax_cfg, jax_ck.scene_fingerprint),
        "torch": (ts, torch_cfg, scene_fingerprint),
    }[package]
    base = fingerprint(scene, cfg.RenderConfig())
    knobs = dict(rays_per_batch=512, spp_per_pass=3, failure_retries=0, sort_key="cell",
                 frame_pool=True, compaction=False, tuning=cfg.IntersectTuning(mode="twopass"))
    assert set(knobs) == set(_EXECUTION_KNOBS)
    for k, v in knobs.items():
        assert fingerprint(scene, cfg.RenderConfig(**{k: v})) == base, k
    assert fingerprint(scene, cfg.RenderConfig(eps=2e-4)) != base


def test_torch_render_state_file_format(tmp_path):
    """The six .npz keys; each package loads the other's file field for
    field; a file without a fingerprint loads as 0 (legacy) in both."""
    accum = np.arange(24, dtype=np.float32).reshape(8, 3)
    ours = RenderState(accum, 5, 4, 2, 7, fingerprint=123456789)
    ours.save(str(tmp_path / "ours.npz"))
    with np.load(tmp_path / "ours.npz") as z:
        assert sorted(z.files) == sorted(["accum", "samples_done", "width", "height", "seed",
                                          "fingerprint"])
    theirs = jax_ck.RenderState.load(str(tmp_path / "ours.npz"))
    jax_ck.RenderState(accum, 5, 4, 2, 7, 123456789).save(str(tmp_path / "theirs.npz"))
    back = RenderState.load(str(tmp_path / "theirs.npz"))
    for st in (theirs, back):
        np.testing.assert_array_equal(st.accum, accum)
        assert (st.samples_done, st.width, st.height, st.seed, st.fingerprint) == (
            5, 4, 2, 7, 123456789)
    np.savez(tmp_path / "legacy.npz", accum=accum, samples_done=5, width=4, height=2, seed=7)
    assert RenderState.load(str(tmp_path / "legacy.npz")).fingerprint == 0
    assert jax_ck.RenderState.load(str(tmp_path / "legacy.npz")).fingerprint == 0


def test_torch_resumes_jax_checkpoint(tmp_path, monkeypatch, capsys):
    """The JAX package renders 4 of 8 samples to a file; the port resumes it
    to 8 in one pass (no rejection, no restart).  Against the JAX package's
    uninterrupted render by the fp-noise rule (the two packages can flip an
    isolated Russian-roulette coin)."""
    js, ts = _both(make_cornell_gltf(str(tmp_path / "c.gltf")), monkeypatch)
    ck = str(tmp_path / "ck.npz")
    jax_ck.render_with_checkpoints(js, spp=4, seed=9, checkpoint_path=ck, checkpoint_every=4)
    passes = []
    got = render_with_checkpoints(ts, spp=8, seed=9, checkpoint_path=ck, checkpoint_every=4,
                                  progress=lambda done, total: passes.append(done))
    assert passes == [8] and capsys.readouterr().err == ""
    _assert_fp_noise(_u8(jax_render(js, spp=8, seed=9)), _u8(got))


def test_torch_checkpoint_resumed_by_jax(tmp_path, monkeypatch, capsys):
    """The reverse: the port writes 4 of 8 samples, the JAX package resumes
    it to 8 in one pass; against the port's uninterrupted render."""
    js, ts = _both(make_cornell_gltf(str(tmp_path / "c.gltf")), monkeypatch)
    ck = str(tmp_path / "ck.npz")
    render_with_checkpoints(ts, spp=4, seed=9, checkpoint_path=ck, checkpoint_every=4)
    passes = []
    got = jax_ck.render_with_checkpoints(js, spp=8, seed=9, checkpoint_path=ck,
                                         checkpoint_every=4,
                                         progress=lambda done, total: passes.append(done))
    assert passes == [8] and capsys.readouterr().err == ""
    _assert_fp_noise(_u8(render(ts, spp=8, seed=9)), _u8(got))
