"""Scenes with more than 512 lights: the port's cluster-worklist light pdf
(the host side of kernel B3 and its plain twin) against the JAX package's
``light_pdf_sum_chunks`` in interpret mode and against the dense reduce, and
a thousand-light render against the JAX render."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.models.pathtracer import render as jax_render
from tpu_pathtracer.ops import pallas_intersect as jpi
from tpu_pathtracer.ops.intersect import light_pdf_sum as jax_light_pdf_sum
from tpu_pathtracer.scene.accel import light_clusters
from tpu_pathtracer.scene.gltf import parse_gltf_scene as jax_parse
from tpu_pathtracer.utils.image import quantize_u8 as jax_quantize
from tpu_pathtracer.utils.testscenes import GltfBuilder, quad
from tpu_pathtracer_torch.bridge import scene_from_arrays
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.ops.intersect import light_pdf_sum_flat
from tpu_pathtracer_torch.utils.image import quantize_u8
from test_torch_render import _assert_fp_noise
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

EPS = 1e-4
COUNT = 937  # lights in use: not a multiple of the 128-light cluster


def _lights(seed, n_rays=256, n_dark=16):
    """1,000 random lights in a 1,024 capacity (COUNT of them in use), their
    clusters, and rays among them; the first ``n_dark`` rays start far
    away and point away from every light."""
    rng = np.random.default_rng(seed)
    n = 1000
    a = rng.uniform(-5, 5, (n, 1, 3))
    verts = np.concatenate([a, a + rng.uniform(-1, 1, (n, 2, 3))], axis=1)
    lverts = np.full((1024, 3, 3), 1e30)
    lverts[:n] = verts
    o = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o[:n_dark] = 100.0
    d[:n_dark] = np.array([1, 0, 0], np.float32)
    return verts, lverts, o, d


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ray_tile", [128, 256])
def test_torch_light_pdf_chunks_matches_jax_interpret(ray_tile):
    """The B3 twin through ``light_pdf_sum_chunks`` against the Pallas
    kernel in interpret mode on the same clusters and rays: the same Woop
    algebra and worklists, only the order of the sum differs."""
    _, lverts, o, d = _lights(seed=5, n_rays=512)
    cl = light_clusters(lverts, COUNT)
    want = np.asarray(jpi.light_pdf_sum_chunks(
        jnp.asarray(o), jnp.asarray(d), *(jnp.asarray(x) for x in (cl[2], cl[3], cl[0], cl[1])),
        jnp.asarray(COUNT, jnp.int32), EPS, ray_tile=ray_tile, interpret=True,
    ))
    got = ci.light_pdf_sum_chunks(_t(o), _t(d), _t(cl[2]), _t(cl[3]), _t(cl[0]), _t(cl[1]),
                                  COUNT, EPS, ray_tile=ray_tile).numpy()
    assert (want > 0).sum() > 50
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_torch_light_pdf_chunks_matches_dense():
    """The same twin against the dense reduce over all 937 lights (the JAX
    package's own bound for the cluster form, tests/test_many_lights.py);
    rays that pierce no cluster give exactly 0."""
    verts, lverts, o, d = _lights(seed=6)
    e1, e2 = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
    nrm = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    want = np.asarray(jax_light_pdf_sum(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts, jnp.float32),
        jnp.asarray(nrm, jnp.float32), jnp.asarray(area, jnp.float32),
        jnp.asarray(COUNT, jnp.int32), EPS,
    ))
    cl = light_clusters(lverts, COUNT)
    got = ci.light_pdf_sum_chunks(_t(o), _t(d), _t(cl[2]), _t(cl[3]), _t(cl[0]), _t(cl[1]),
                                  COUNT, EPS, ray_tile=128).numpy()
    assert (want > 0).sum() > 10
    np.testing.assert_array_equal(got[:16], 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_torch_light_pdf_twin_sums_in_worklist_order():
    """``run_light_pdf_plain`` adds each valid slot's cluster once and
    ignores slots past the count (which repeat the last id): equal to the
    per-cluster flat form summed over exactly the listed clusters."""
    _, lverts, o, d = _lights(seed=7, n_rays=256, n_dark=0)
    cl = light_clusters(lverts, COUNT)
    cw, ck = _t(cl[2]), _t(cl[3])
    rays = ci.pack_rays(_t(o), _t(d))
    idx = torch.tensor([[3, 0, 5, 5, 5, 5, 5, 5], [7, 7, 7, 7, 7, 7, 7, 7]], dtype=torch.int32)
    counts = torch.tensor([3, 1], dtype=torch.int32)
    got = ci.run_light_pdf_plain(rays, cw, ck, idx, counts, EPS)
    want = torch.zeros(256)
    for tile, clusters in ((0, (3, 0, 5)), (1, (7,))):
        rows = slice(128 * tile, 128 * (tile + 1))
        for c in clusters:
            want[rows] += light_pdf_sum_flat(_t(o)[rows], _t(d)[rows], cw[c:c + 1],
                                             ck[c:c + 1], 1, EPS)
    assert (want > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-9)


def _thousand_light_gltf(path, emissive):
    """tests/test_many_lights.py's scene: a floor under 500 small ceiling
    quads, emissive (1,000 lights) or not."""
    b = GltfBuilder()
    floor = b.add_material((0.8, 0.8, 0.8, 1))
    lightm = (b.add_material((0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=2.0)
              if emissive else b.add_material((0, 0, 0, 1)))
    b.add_mesh(*quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20)), material=floor)
    rng = np.random.default_rng(1)
    for cx, cz in rng.uniform(-10, 10, (500, 2)):
        b.add_mesh(*quad((cx - 0.2, 4.0, cz - 0.2), (cx + 0.2, 4.0, cz - 0.2),
                         (cx + 0.2, 4.0, cz + 0.2), (cx - 0.2, 4.0, cz + 0.2)), material=lightm)
    b.add_camera((0, 1.5, 8.0), yfov=0.8)
    return b.write(path)


def test_torch_thousand_light_scene_matches_jax(tmp_path, monkeypatch):
    """1,000 emissive triangles: the port's render takes the cluster
    worklists (B3's twin) where the JAX render on the CPU takes the dense
    reduce; the two images agree to fp noise, and the lit floor is brighter
    than the unlit control's."""
    calls = []
    real = ci.run_light_pdf
    monkeypatch.setattr(ci, "run_light_pdf", lambda *a: calls.append(1) or real(*a))
    w = h = 16
    imgs = {}
    for emissive in (True, False):
        js = jax_parse(_thousand_light_gltf(str(tmp_path / str(emissive) / "s.gltf"), emissive), 1.0)
        js = dataclasses.replace(js, camera=js.camera.with_dims(w, h))
        arrays, statics = jax_scene_arrays(js)
        ts = scene_from_arrays(arrays, {**statics, "width": w, "height": h})
        assert ts.lights.count == (1000 if emissive else 0)
        hdr = pt.render(ts, spp=2, seed=0)
        assert np.isfinite(hdr).all()
        imgs[emissive] = hdr
        if emissive:
            assert ts.lights.capacity > 512 and len(calls) > 0
            want = np.asarray(jax_quantize(jnp.asarray(jax_render(js, spp=2, seed=0))))
            got = quantize_u8(torch.from_numpy(hdr)).numpy()
            _assert_fp_noise(want.astype(int), got.astype(int))
    assert imgs[True].mean() > imgs[False].mean()


def test_torch_light_pdf_rejects_untileable_ray_count(tmp_path):
    """More than 512 lights and a wavefront that is not a multiple of 256
    rays: ``bounce_step`` raises instead of taking another pdf path."""
    js = jax_parse(_thousand_light_gltf(str(tmp_path / "s.gltf"), True), 1.0)
    arrays, statics = jax_scene_arrays(js)
    ts = scene_from_arrays(arrays, {**statics, "width": 8, "height": 8})
    r = 100
    o = torch.zeros((r, 3))
    o[:, 1] = 1.0
    d = torch.zeros((r, 3))
    d[:, 1] = -1.0
    draws = torch.full((pt._DRAWS, r), 0.5)
    with pytest.raises(ValueError, match="ray tile"):
        pt.bounce_step(ts, pt.RenderConfig(), o, d, torch.ones_like(o), torch.zeros_like(o),
                       torch.ones(r, dtype=torch.bool), draws)


def test_torch_light_kernel_wrappers_reject_other_devices():
    """A CPU tensor goes to the twin, a CUDA tensor to the kernel; any other
    device raises instead of falling back (B3 and B4)."""
    rays = torch.zeros((128, 8), device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    box = torch.zeros((4, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.run_light_pdf(rays, torch.zeros((1, 12, 128), device="meta"),
                         torch.zeros((1, 128), device="meta"), box[:1], box[:1], idx, idx[0], EPS)
    with pytest.raises(RuntimeError, match="no kernel"):
        ci.nearest_box_ids(rays[:, :3], rays[:, 4:7], box, box, EPS, ray_tile=128)


@pytest.mark.parametrize("counts", [(8, 1), (5, 0), (3, 7)], ids=["full", "empty_tile", "ragged"])
def test_torch_light_pdf_segmented_sum_matches_twin(counts):
    """B3's decomposition: each tile's worklist cut into segments of
    ``kernels.PDF_SEGMENT`` clusters, one partial sum per (ray, segment) in
    worklist order, then the partial sums added in segment order; equal to
    ``run_light_pdf_plain`` within 1e-6 relative (only the order of a sum
    of non-negative terms differs), with 0 where a tile has no cluster."""
    from tpu_pathtracer_torch import kernels

    seg = kernels.PDF_SEGMENT
    _, lverts, o, d = _lights(seed=8, n_rays=256, n_dark=0)
    cl = light_clusters(lverts, COUNT)
    cw, ck = _t(cl[2]), _t(cl[3])
    rays = ci.pack_rays(_t(o), _t(d))
    idx = torch.tensor([[3, 0, 5, 7, 1, 2, 6, 4], [7, 2, 1, 4, 5, 6, 3, 0]], dtype=torch.int32)
    counts = torch.tensor(counts, dtype=torch.int32)
    want = ci.run_light_pdf_plain(rays, cw, ck, idx, counts, EPS)
    n_seg = -(-idx.shape[1] // seg)
    partial = torch.zeros((n_seg, 256))
    for s in range(n_seg):
        part_counts = torch.clamp(counts - s * seg, 0, seg)
        partial[s] = ci.run_light_pdf_plain(rays, cw, ck, idx[:, s * seg:(s + 1) * seg].contiguous(),
                                            part_counts, EPS)
    got = torch.zeros(256)
    for s in range(n_seg):
        got = got + partial[s]
    assert (want > 0).sum() > 10
    np.testing.assert_array_equal((got == 0).numpy(), (want == 0).numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    for tile, n in enumerate(counts.tolist()):
        if n == 0:
            assert not want[128 * tile:128 * (tile + 1)].any()
