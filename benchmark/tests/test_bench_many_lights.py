"""The configuration ``litbanner``'s plain reference against the program on
the CPU, on the lit-banner atrium at detail 1: 6,144 banner triangles and
the 6 skylight triangles, more than 512 light slots, so the program takes
its cluster path (B1 over the cluster boxes, the worklist, B3's plain twin)
where the reference sums the dense pdf over every light."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import manifest
from benchmark.reference import scene as ref_scene
from benchmark.reference import twins
from benchmark.scenes import lit_banner
from benchmark.tests.test_bench_faults import _run

EPS = 1e-4
N_RAYS = 4096
# Per ray, the program's pdf against the reference's.  The two sum the same
# float32 terms in another order (by cluster worklist against by block of
# 128 lights), some 1e-7 of a sum, and find a hit's t by another algebra
# (the Woop rows against Cramer's rule), each rounded at the scene's scale
# of metres: a hit a few millimetres from the ray's origin, as from one fold
# of a banner to the next, has its t^2 off by up to some 1e-3 of itself
# (seen at seeds 19-22: at most 4 of 4,096 rays past 1e-3, at most 1 past
# 1e-2).  A ray that grazes a light's edge can be in on one side and out
# on the other: EDGE_RAYS of them are allowed.
REL = 1e-2
EDGE_RAYS = 4


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    path = lit_banner.make_lit_banner_atrium_gltf(
        str(tmp_path_factory.mktemp("litbanner") / "atrium.gltf"), detail=1)
    with open(os.path.join(manifest.ROOT, "benchmark", "configs", "litbanner.json")) as f:
        render = json.load(f)["render"]
    ref = ref_scene.load_scene(path, 64, 64, render)
    prog = parse_gltf_scene(path, 1.0, RenderConfig(**render))
    return ref, prog


def _rays(ref, seed=19):
    """N_RAYS rays from points on the floor and on the banners: half toward
    a point on a light drawn uniformly (the targets are returned too), half
    cosine-distributed about the surface normal."""
    rng = np.random.default_rng(seed)
    verts, mat = ref.verts.numpy(), ref.material.numpy()
    floor = np.nonzero((np.abs(verts[:, :, 1]).max(axis=1) == 0) & (mat[:, 0] > 0.6))[0]
    banner = np.nonzero(mat[:, 5] == np.float32(4.0))[0]
    tri = np.concatenate([rng.choice(floor, N_RAYS // 2), rng.choice(banner, N_RAYS // 2)])
    uv = rng.uniform(size=(N_RAYS, 2))
    uv = np.where(uv.sum(1, keepdims=True) > 1, 1 - uv, uv)
    v = verts[tri]
    o = v[:, 0] + uv[:, :1] * (v[:, 1] - v[:, 0]) + uv[:, 1:] * (v[:, 2] - v[:, 0])
    n = ref.normals.numpy()[tri].mean(axis=1)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    lv = ref.light_verts.numpy()[rng.integers(0, ref.n_lights, N_RAYS)]
    lw = rng.uniform(size=(N_RAYS, 2))
    lw = np.where(lw.sum(1, keepdims=True) > 1, 1 - lw, lw)
    target = lv[:, 0] + lw[:, :1] * (lv[:, 1] - lv[:, 0]) + lw[:, 1:] * (lv[:, 2] - lv[:, 0])
    toward = target - o
    local = rng.normal(size=(N_RAYS, 3))
    cosine = n + local / np.linalg.norm(local, axis=1, keepdims=True)
    d = np.where((np.arange(N_RAYS) % 2 == 0)[:, None], toward, cosine)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(target[::2].astype(np.float32)))


def _reference(ref, o, d):
    return twins.light_pdf_sum(o, d, ref.light_verts, ref.light_normal, ref.light_area,
                               ref.n_lights, EPS)


def _off(got, want):
    """Rays whose program pdf differs from the reference's by more than REL
    of it (NaN counts as off)."""
    return int((~((got - want).abs() <= REL * want.abs())).sum())


def test_bench_litbanner_takes_the_cluster_path(scenes):
    ref, prog = scenes
    lights = prog.lights
    assert ref.n_lights == lights.count == 6150
    assert lights.has_clusters and lights.capacity > 512


def test_bench_litbanner_light_list_in_program_order(scenes):
    """The reference's light list is the program's, in order, so a light
    draw picks the same triangle on both sides."""
    ref, prog = scenes
    assert torch.equal(ref.light_verts, prog.lights.verts[:prog.lights.count])
    u = torch.rand(1024, generator=torch.Generator().manual_seed(7))
    pick = twins.pick_uniform(u, ref.n_lights).long()
    assert torch.equal(ref.light_verts[pick], prog.lights.verts[pick])


def test_bench_litbanner_light_pdf_matches_program(scenes):
    from tpu_pathtracer_torch.models import pathtracer as pt

    ref, prog = scenes
    o, d, _ = _rays(ref)
    want = _reference(ref, o, d)
    got = pt.light_pdf(prog, o, d, EPS)
    assert int((want > 0).sum()) > N_RAYS // 2  # the light-aimed half and more
    assert torch.equal(got == 0, want == 0)
    assert _off(got, want) <= EDGE_RAYS


def test_bench_litbanner_light_pdf_fault_dropped_cluster(scenes):
    """A planted fault: the cluster whose box holds the most of the
    light-aimed rays' targets dropped from every worklist (its box made
    empty, as a padding cluster's is) fails the comparison."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    ref, prog = scenes
    o, d, target = _rays(ref)
    want = _reference(ref, o, d)
    lights = prog.lights
    inside = ((target[:, None] >= lights.cluster_min[None])
              & (target[:, None] <= lights.cluster_max[None])).all(dim=2)
    c = int(inside.sum(dim=0).argmax())
    nan = torch.full((3,), float("nan"))
    where = (torch.tensor([c]),)
    broken = dataclasses.replace(prog, lights=dataclasses.replace(
        lights, cluster_min=lights.cluster_min.index_put(where, nan),
        cluster_max=lights.cluster_max.index_put(where, nan)))
    assert _off(pt.light_pdf(broken, o, d, EPS), want) > EDGE_RAYS


def _small_cell():
    """The cell ``litbanner.progressive`` at 16x16 in passes of 2 spp on the
    lit-banner atrium at detail 1, so that a run takes seconds on the CPU."""
    cell = copy.deepcopy(manifest.cell("litbanner.progressive"))
    cell["config"]["scene"]["args"]["detail"] = 1
    cell["config"]["render"]["spp_per_pass"] = 2
    cell["traffic"].update(width=16, height=16, spp_per_pass=2, check_pixels=64)
    return cell


def test_bench_litbanner_sound_run_is_correct():
    assert _run(_small_cell(), 3000000019)["correct"] is True


def test_bench_litbanner_fault_half_the_clusters_dropped(monkeypatch):
    """A run whose light pdf leaves every other cluster out of every
    worklist (as a worklist that overflowed would) comes out not correct."""
    from tpu_pathtracer_torch.models import pathtracer as pt

    real = pt.light_pdf

    def broken(scene, pos, new_dir, eps):
        lights = scene.lights
        half = (torch.arange(0, lights.cluster_min.shape[0], 2),)
        nan = torch.tensor(float("nan"))
        return real(dataclasses.replace(scene, lights=dataclasses.replace(
            lights, cluster_min=lights.cluster_min.index_put(half, nan),
            cluster_max=lights.cluster_max.index_put(half, nan))), pos, new_dir, eps)

    monkeypatch.setattr(pt, "light_pdf", broken)
    assert _run(_small_cell(), 3000000019)["correct"] is False
