"""The premise of B3's per-ray cull, on the lit-banner atrium at detail 1
(6,150 lights in 49 clusters): a light whose Woop test passes lies in a
cluster whose box, grown by ``BOX_SLACK``, the ray enters by the slab
test's own arithmetic.  So the twin restricted to the (ray, cluster) pairs
whose ray enters the box gives the twin's sums, and ``count_work``'s
``b3_pairs`` / ``b3_live`` are the tile-level pairs and the entered ones.

Rays of five kinds, 512 each (one 512-ray tile a kind): cosine bounces from
surface points; directions toward points on banner triangles; rays spawned
on the banners; rays grazing the cluster boxes' edges and faces, or aimed at
light vertices; and the light pdf's own inputs from one bounce of the
renderer."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.ops.rng import jitter_uniforms
from tpu_pathtracer_torch.scene import fixtures, gltf

torch.set_num_threads(1)

EPS = 1e-4
N = 512  # rays of each kind: one tile
KINDS = ("cosine", "to_banner", "on_banner", "grazing", "renderer")


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _sphere(g, n):
    return _unit(torch.randn((n, 3), generator=g))


def _on_lights(lights, g, n):
    """n points on random lights (uniform barycentrics), in float32."""
    tri = lights.verts[torch.randint(0, lights.count, (n,), generator=g)]
    u, v = torch.rand((2, n, 1), generator=g)
    flip = (u + v) > 1
    u, v = torch.where(flip, 1 - u, u), torch.where(flip, 1 - v, v)
    return tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])


def _surface(scene, g):
    """Hit points of N camera rays on the scene's surfaces, with the
    geometric normal facing the ray."""
    pids = torch.arange(4 * N, dtype=torch.int32)
    o, d = pt.gen_rays(scene.camera, pids, jitter_uniforms(0, 0, pids))
    hit = pt.scene_closest_hit(scene, o, d, EPS, pt.RenderConfig().tuning)
    keep = torch.nonzero(hit.hit)[:N, 0]
    assert keep.numel() == N
    pos = o[keep] + hit.t[keep, None] * d[keep]
    v = scene.verts[hit.tri[keep].long()]
    nrm = _unit(torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    nrm = torch.where(((nrm * d[keep]).sum(-1, keepdim=True) > 0), -nrm, nrm)
    return pos, nrm


def _cosine(nrm, g):
    u1, u2 = torch.rand((2, nrm.shape[0]), generator=g)
    r, phi = torch.sqrt(u1), 2 * math.pi * u2
    a = torch.where(nrm[:, :1].abs() > 0.9, torch.tensor([0.0, 1.0, 0.0]),
                    torch.tensor([1.0, 0.0, 0.0]))
    t = _unit(torch.linalg.cross(nrm, a))
    b = torch.linalg.cross(nrm, t)
    return _unit(t * (r * torch.cos(phi))[:, None] + b * (r * torch.sin(phi))[:, None]
                 + nrm * torch.sqrt(1 - u1)[:, None])


def _grazing(lights, g):
    """Half: rays through a point on an edge of a cluster's box, nearly
    parallel to one of the edge's faces (every 4th exactly parallel, its
    origin on the face's plane); half: rays aimed at a light's vertex, which
    lies on its cluster's box or inside it."""
    lo, hi = lights.cluster_min, lights.cluster_max
    ok = torch.nonzero(~torch.isnan(lo[:, 0]))[:, 0]
    m = N // 2
    c = ok[torch.randint(0, ok.numel(), (m,), generator=g)]
    axis = torch.randint(0, 3, (m,), generator=g)
    a1, a2 = (axis + 1) % 3, (axis + 2) % 3
    rows = torch.arange(m)
    side = torch.rand((2, m), generator=g) < 0.5
    e = lo[c] + torch.rand((m, 1), generator=g) * (hi[c] - lo[c])
    e[rows, a1] = torch.where(side[0], lo[c, a1], hi[c, a1])
    e[rows, a2] = torch.where(side[1], lo[c, a2], hi[c, a2])
    d = _sphere(g, m)
    flat = torch.rand(m, generator=g) * 2e-3 - 1e-3
    flat[::4] = 0.0
    d[rows, a1] = flat
    d = _unit(d)
    o = e - d * (0.5 + 2.5 * torch.rand((m, 1), generator=g))
    o[::4, :] = e[::4] - d[::4] * 2.0
    o[rows[::4], a1[::4]] = e[rows[::4], a1[::4]]  # on the face's plane
    vert = lights.verts[torch.randint(0, lights.count, (m,), generator=g),
                        torch.randint(0, 3, (m,), generator=g)]
    vo = vert + _sphere(g, m) * (0.2 + 3 * torch.rand((m, 1), generator=g))
    return torch.cat([o, vo]), torch.cat([d, _unit(vert - vo)])


def _renderer(scene):
    """The light pdf's inputs of one bounce of N camera rays, as the
    renderer hands them to ``light_pdf_sum_chunks``."""
    seen = []
    real = pt.light_pdf_sum_chunks

    def spy(pos, new_dir, *rest, **kw):
        seen.append((pos.clone(), new_dir.clone()))
        return real(pos, new_dir, *rest, **kw)

    pids = torch.arange(N, dtype=torch.int32)
    config = pt.RenderConfig()
    o, d = pt.gen_rays(scene.camera, pids, jitter_uniforms(0, 0, pids))
    draws = pt.bounce_draws(0, 0, 0, pids, config)
    pt.light_pdf_sum_chunks = spy
    try:
        pt.bounce_step(scene, config, o, d, torch.ones_like(o), torch.zeros_like(o),
                       torch.ones(N, dtype=torch.bool), draws)
    finally:
        pt.light_pdf_sum_chunks = real
    return seen[0]


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    """The scene and the five kinds of rays, packed [5 * N, 8], one kind a
    512-ray tile."""
    path = fixtures.make_lit_banner_atrium_gltf(
        str(tmp_path_factory.mktemp("lit") / "atrium.gltf"), detail=1, textured=False)
    scene = gltf.parse_gltf_scene(path, 1.0, pt.RenderConfig())
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(32, 64))
    lights = scene.lights
    assert lights.capacity > 512 and lights.cluster_woop.shape[0] > 4
    g = torch.Generator().manual_seed(23)
    pos, nrm = _surface(scene, g)
    sets = {"cosine": (pos, _cosine(nrm, g)),
            "to_banner": (pos, _unit(_on_lights(lights, g, N) - pos)),
            "on_banner": (_on_lights(lights, g, N), _sphere(g, N)),
            "grazing": _grazing(lights, g),
            "renderer": _renderer(scene)}
    o = torch.cat([sets[k][0] for k in KINDS]).float().contiguous()
    d = torch.cat([sets[k][1] for k in KINDS]).float().contiguous()
    return scene, o, d


def _woop_pass(rays, cluster_woop):
    """[R, C] bool: some light of cluster c passes ray r's Woop test, in
    the twin's arithmetic (``run_light_pdf_plain``), every cluster tested."""
    o, d = rays[None, :, 0:3], rays[None, :, 4:7]
    out = []
    for c0 in range(0, cluster_woop.shape[0], 8):
        w = cluster_woop[c0:c0 + 8]
        p0, p1, p2 = (ci._contract_o(o, w, j) for j in (0, 4, 8))
        q0, q1, q2 = (ci._contract_d(d, w, j) for j in (0, 4, 8))
        t = -p2 / q2
        beta, gamma = p0 + t * q0, p1 + t * q1
        ok = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (t >= EPS)
        out.append(ok.any(dim=-1))
    return torch.cat(out).T


def _enters_np(rays, lo, hi):
    """[R, C] bool by ``tpt::slab_interval``'s arithmetic in numpy float32:
    t_lo <= t_hi and t_hi >= min_dst, no far bound."""
    o = rays[:, 0:3].numpy()
    d = rays[:, 4:7].numpy()
    inv = np.float32(1.0) / np.where(d == 0, np.float32(1e-30), d)
    lo, hi = lo.numpy(), hi.numpy()
    t_lo = t_hi = None
    for a in range(3):
        t1 = (lo[None, :, a] - o[:, None, a]) * inv[:, None, a]
        t2 = (hi[None, :, a] - o[:, None, a]) * inv[:, None, a]
        mn, mx = np.minimum(t1, t2), np.maximum(t1, t2)
        t_lo = mn if t_lo is None else np.maximum(t_lo, mn)
        t_hi = mx if t_hi is None else np.minimum(t_hi, mx)
    return (t_lo <= t_hi) & (t_hi >= np.float32(EPS))


def _grown(lights):
    return (ci._grown_once(lights.cluster_min, -1.0), ci._grown_once(lights.cluster_max, 1.0))


def _worklists(rays, lights, ray_tile):
    m8, ent, _ = ci.tile_chunk_activity_plain(rays, lights.cluster_min, lights.cluster_max, None,
                                              None, EPS, ray_tile, 1, False)
    ga, ge = ci._group_stats(m8 != 0, ent, 1)
    idx, counts, _ = ci._worklist(ga, ge, lights.cluster_woop.shape[0])
    return idx.contiguous(), counts.contiguous()


@pytest.mark.parametrize("kind", KINDS)
def test_torch_light_hits_lie_in_the_grown_boxes_the_ray_enters(lit, kind):
    """Every (ray, cluster) pair where some light passes the Woop test (over
    every cluster, not only the worklist's) has the ray entering the
    cluster's grown box by the slab test's arithmetic; both of the
    kernel's forms of that test (``light_pdf_entered_plain`` in torch, the
    kernel's op order in numpy) agree."""
    scene, o, d = lit
    k = KINDS.index(kind)
    rays = ci.pack_rays(o[k * N:(k + 1) * N], d[k * N:(k + 1) * N])
    lights = scene.lights
    passes = _woop_pass(rays, lights.cluster_woop)
    lo, hi = _grown(lights)
    enters = torch.from_numpy(_enters_np(rays, lo, hi))
    c = lights.cluster_woop.shape[0]
    every = torch.arange(c, dtype=torch.int32)[None, :]
    torch_enters = ci.light_pdf_entered_plain(rays, lo, hi, every, torch.tensor([c]), EPS)
    assert torch.equal(torch_enters.reshape(N, c), enters)
    assert int(passes.sum()) > 0
    missed = passes & ~enters
    assert not missed.any(), f"{int(missed.sum())} hit pairs outside the box the ray enters"


@pytest.mark.parametrize("ray_tile", [128, 512])
def test_torch_light_pdf_over_entered_pairs_equals_twin(lit, ray_tile):
    """The twin restricted to the pairs whose ray enters the grown box (one
    worklist a ray: its tile's clusters that it enters, in worklist order)
    gives the tile-level twin's sums: the same zero / non-zero pattern and
    the sum-order tolerance; and the entered pairs are far fewer."""
    scene, o, d = lit
    lights = scene.lights
    rays = ci.pack_rays(o, d)
    idx, counts = _worklists(rays, lights, ray_tile)
    want = ci.run_light_pdf_plain(rays, lights.cluster_woop, lights.cluster_k, idx, counts, EPS)
    lo, hi = _grown(lights)
    entered = ci.light_pdf_entered_plain(rays, lo, hi, idx, counts, EPS).reshape(rays.shape[0], -1)
    per_ray = idx.repeat_interleave(ray_tile, 0)
    order = torch.argsort((~entered).to(torch.int8), dim=1, stable=True)
    got = ci.run_light_pdf_plain(rays, lights.cluster_woop, lights.cluster_k,
                                 torch.gather(per_ray, 1, order).contiguous(),
                                 entered.sum(dim=1, dtype=torch.int32), EPS)
    nz = want != 0
    assert int(nz.sum()) > 100
    assert torch.equal(got != 0, nz)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    assert int(entered.sum()) < 0.5 * int(counts.sum()) * ray_tile


@pytest.mark.parametrize("ray_tile", [128, 512])
def test_torch_light_pdf_work_counts_equal_brute_force(lit, ray_tile):
    """Under ``count_work`` one ``light_pdf_sum_chunks`` call adds B1's
    (tile, cluster) tests, B3's tile-level (ray, cluster) pairs (the
    clusters whose box some ray of the tile enters, x the tile's rays) and
    the pairs whose ray enters the grown box, each counted here by brute
    force in numpy; B2's units stay 0 and the result is the call's own."""
    scene, o, d = lit
    lights = scene.lights
    rays = ci.pack_rays(o, d)
    r, c = rays.shape[0], lights.cluster_woop.shape[0]
    t_tiles = r // ray_tile
    listed = _enters_np(rays, lights.cluster_min, lights.cluster_max)
    listed = listed.reshape(t_tiles, ray_tile, c).any(axis=1)  # [T, C]
    enters = _enters_np(rays, *_grown(lights)).reshape(t_tiles, ray_tile, c)
    pairs = int(listed.sum()) * ray_tile
    live = int((enters & listed[:, None, :]).sum())
    work = torch.zeros(len(pt.WORK_COUNTS), dtype=torch.int64)
    args = (o, d, lights.cluster_woop, lights.cluster_k, lights.cluster_min, lights.cluster_max,
            lights.count, EPS)
    with ci.count_work(work):
        got_pdf = ci.light_pdf_sum_chunks(*args, ray_tile=ray_tile)
    got = dict(zip(pt.WORK_COUNTS, work.tolist()))
    assert got == {"b2_units": 0, "b1_tests": t_tiles * c, "b3_pairs": pairs, "b3_live": live}
    assert 0 < live < pairs
    assert torch.equal(got_pdf, ci.light_pdf_sum_chunks(*args, ray_tile=ray_tile))


@pytest.mark.cuda
@pytest.mark.parametrize("ray_tile", [128, 512])
def test_torch_light_pdf_kernel_culls_to_twin(lit, ray_tile):
    """B3 on the card against its twin on the same worklists: the same
    zero / non-zero pattern, relative error <= 1e-5, bit-equal across two
    launches; its work counter equal to the twin-side counts, and
    ``count_work`` on the card equal to ``count_work`` on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_pathtracer_torch import kernels

    scene, o, d = lit
    lights = scene.lights.to("cuda")
    rays = ci.pack_rays(o, d).cuda()
    idx, counts = (x.cuda() for x in _worklists(ci.pack_rays(o, d), scene.lights, ray_tile))
    lo, hi = _grown(lights)
    args = (rays, lights.cluster_woop, lights.cluster_k, lo, hi, idx, counts, EPS)
    work = torch.zeros(2, dtype=torch.int64, device="cuda")
    k1 = kernels.light_pdf(*args, work)
    k2 = kernels.light_pdf(*args)
    want = ci.run_light_pdf_plain(rays, lights.cluster_woop, lights.cluster_k, idx, counts, EPS)
    nz = want != 0
    assert int(nz.sum()) > 100 and torch.equal(k1 != 0, nz) and torch.equal(k1, k2)
    assert float(((k1[nz] - want[nz]).abs() / want[nz]).max()) <= 1e-5
    entered = int(ci.light_pdf_entered_plain(rays, lo, hi, idx, counts, EPS).sum())
    assert work.tolist() == [int(counts.sum()) * ray_tile, entered]
    counted = {}
    for dev, ls in (("cuda", lights), ("cpu", scene.lights)):
        w = torch.zeros(len(pt.WORK_COUNTS), dtype=torch.int64, device=dev)
        with ci.count_work(w):
            ci.light_pdf_sum_chunks(o.to(dev), d.to(dev), ls.cluster_woop, ls.cluster_k,
                                    ls.cluster_min, ls.cluster_max, ls.count, EPS,
                                    ray_tile=ray_tile)
        counted[dev] = w.tolist()
    assert counted["cuda"] == counted["cpu"] and counted["cpu"][3] == entered
