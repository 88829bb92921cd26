"""The intersector's large-scene path in the port, at a small size: the
256-ray tiles past ``narrow_tile_chunks`` and the coarse gate recomputed
under each ray's best t on every cascade recheck past
``super_tbound_min`` gate blocks, both forced on a 2,606-triangle atrium
through ``IntersectTuning``.  Both are exact: the closest hits and a
rendered pass are bit-equal with and without them, and equal to a brute
force in the kernels' own arithmetic, because the cascade grows its chunk
boxes (a hit on a box's face is reached by the ray's own slab test) and
breaks an exact tie to the smallest triangle id (not to the first
tested).  Both depart from the JAX package, which the same path is held
to here on the rays where they do not matter.  The persistent loop's work
counts (``b2_units``: B2's set sub-tile bits of live slots; ``b1_tests``:
B1's (tile, chunk) tests its gate lets through) equal the same counts
taken directly from the worklists, and every render entry puts them, with
the call's ``ray_tile`` and ``chunks``, on its ``engine_call`` spans."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import IntersectTuning as JaxIntersectTuning
from tpu_pathtracer.ops import pallas_intersect as jpi
from tpu_pathtracer_torch import cli
from tpu_pathtracer_torch.config import IntersectTuning, RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.ops.intersect import closest_hit
from tpu_pathtracer_torch.parallel.checkpoint import render_with_checkpoints
from tpu_pathtracer_torch.renderer import Renderer
from tpu_pathtracer_torch.scene import fixtures
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene
from tpu_pathtracer_torch.utils import profiling

torch.set_num_threads(1)

EPS = 1e-4
# Both switches on a 24-chunk scene: 256-ray tiles, the coarse gate on its
# one block (``super_min`` 0) and recomputed under t at every recheck.
BOTH = dict(narrow_tile_chunks=0, super_min=0, super_tbound_min=1)
NEITHER = dict(narrow_tile_chunks=1_000_000, super_min=0, super_tbound_min=0)


@pytest.fixture(scope="module")
def atrium(tmp_path_factory):
    path = fixtures.make_atrium_gltf(str(tmp_path_factory.mktemp("atrium") / "atrium.gltf"),
                                     detail=0, textured=False)
    return path, parse_gltf_scene(path, 1.0)


def _rays(scene, n, seed):
    """Seeded rays from inside the scene's box in random directions."""
    lo, hi = ci.scene_bounds(scene.chunk_aabb_min, scene.chunk_aabb_max)
    g = torch.Generator().manual_seed(seed)
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    return o, d / d.norm(dim=1, keepdim=True)


def _cascade(scene, o, d, ray_tile, **tuning):
    return ci.closest_hit_chunks(
        o, d, scene.chunk_woop, scene.chunk_aabb_min, scene.chunk_aabb_max, scene.woop_rows,
        EPS, ray_tile=ray_tile, tuning=dataclasses.replace(IntersectTuning(), **tuning))


def _brute_force(scene, o, d):
    """Every chunk group of every tile with every sub-tile bit set, through
    B2's twin: the closest hit in the kernels' arithmetic, no culling."""
    cg = -(-scene.chunk_woop.shape[0] // ci.GROUP)
    cw = ci._nan_pad(scene.chunk_woop, cg * ci.GROUP)
    rays = ci.pack_rays(o, d)
    t_tiles = o.shape[0] // ci.RAY_TILE
    t, tri = ci.run_items_plain(
        rays, torch.full((o.shape[0],), float("inf")), torch.zeros(o.shape[0], dtype=torch.int32),
        cw, torch.arange(cg, dtype=torch.int32).expand(t_tiles, cg).contiguous(),
        torch.full((t_tiles,), cg, dtype=torch.int32),
        torch.full((t_tiles, cg, 2), -1, dtype=torch.int32), EPS, ci.GROUP, 8)
    return ci._winner(rays, scene.woop_rows, t, tri)


def test_torch_large_scene_tiles_and_tbound_gate_are_exact(atrium):
    """At 256- and 512-ray tiles, with the t-bounded gate on and off, the
    cascade's (t, tri, beta, gamma) are bit-equal, equal to the brute force
    in the kernels' arithmetic, and agree with the dense sweep."""
    _, scene = atrium
    o, d = _rays(scene, 2048, seed=20)
    hits = {(tile, tb): _cascade(scene, o, d, tile, super_min=0, super_tbound_min=tb)
            for tile, tb in itertools.product((256, 512), (0, 1))}
    want = _brute_force(scene, o, d)
    assert int(want.hit.sum()) > 400
    for key, got in hits.items():
        for field in ("t", "tri", "beta", "gamma", "hit"):
            assert torch.equal(getattr(got, field), getattr(want, field)), (key, field)
    dense = closest_hit(o, d, scene.woop, EPS)
    both = dense.hit & want.hit
    assert (dense.hit == want.hit).float().mean() > 0.995
    torch.testing.assert_close(want.t[both], dense.t[both], rtol=1e-5, atol=1e-6)
    assert (want.tri[both] == dense.tri[both]).float().mean() > 0.99


def _own_slab_misses(o, d, t, bmin, bmax):
    """Rays whose own rounded slab test of the given boxes fails the
    cascade's conditions at their hit t (entered, exit past min_dst, entry
    not past t)."""
    inv = ci._inv_dir(d)
    t1, t2 = (bmin - o) * inv, (bmax - o) * inv
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t_lo = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    t_hi = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return ~((t_lo <= t_hi) & (t_hi >= EPS) & (t_lo <= t))


def test_torch_grown_boxes_reach_every_hits_chunk(atrium):
    """Rays aimed at points of the atrium's floor, whose chunks have flat
    boxes: as the boxes are, some ray's own rounded slab test misses the
    chunk of its brute-force hit (the hit lies on the box's face), so only
    another ray of its tile could activate it; grown by ``BOX_SLACK``, as
    the cascade tests them, none does."""
    _, scene = atrium
    lo, hi = ci.scene_bounds(scene.chunk_aabb_min, scene.chunk_aabb_max)
    g = torch.Generator().manual_seed(3)
    target = lo + (hi - lo) * torch.rand((4096, 3), generator=g)
    target[:, 1] = lo[1]
    o = lo + (hi - lo) * torch.rand((4096, 3), generator=g)
    d = (target - o) / (target - o).norm(dim=1, keepdim=True)
    want = _brute_force(scene, o, d)
    chunk = (want.tri // scene.chunk_woop.shape[2]).long()
    hit = want.hit
    assert int(hit.sum()) > 1000
    raw = _own_slab_misses(o, d, want.t, scene.chunk_aabb_min[chunk], scene.chunk_aabb_max[chunk])
    assert int((raw & hit).sum()) > 0
    grown = _own_slab_misses(o, d, want.t, ci._grown_once(scene.chunk_aabb_min, -1.0)[chunk],
                             ci._grown_once(scene.chunk_aabb_max, 1.0)[chunk])
    assert int((grown & hit).sum()) == 0
    for tile in (256, 512):
        got = _cascade(scene, o, d, tile, super_min=0, super_tbound_min=1)
        assert torch.equal(got.t, want.t) and torch.equal(got.tri, want.tri)


def _floor_rays(scene, n, seed):
    """Seeded rays from inside the scene's box aimed at points of its floor,
    whose chunks have flat boxes."""
    lo, hi = ci.scene_bounds(scene.chunk_aabb_min, scene.chunk_aabb_max)
    g = torch.Generator().manual_seed(seed)
    target = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    target[:, 1] = lo[1]
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    return o, (target - o) / (target - o).norm(dim=1, keepdim=True)


def _woop64(o, d, w):
    """(t, beta, gamma) of each ray against its triangle's Woop rows ``w``
    ([n, 12], rows[t, 4j+k]) in float64, with the float32 forward-error
    bound of t that tests/test_torch_modes.py allows the JAX package."""
    o, d, w = (np.asarray(x, dtype=np.float64) for x in (o, d, w))
    p = [(o * w[:, 4 * j:4 * j + 3]).sum(axis=1) + w[:, 4 * j + 3] for j in range(3)]
    q = [(d * w[:, 4 * j:4 * j + 3]).sum(axis=1) for j in range(3)]
    t = -p[2] / q[2]
    terms = np.abs(o * w[:, 8:11]).sum(axis=1) + np.abs(w[:, 11])
    return t, p[0] + t * q[0], p[1] + t * q[1], 1e-6 * np.abs(t) + 8 * 2.0**-24 * terms / np.abs(q[2])


@pytest.mark.parametrize("which", ["random", "floor"])
def test_torch_large_scene_path_against_jax(atrium, which):
    """The port's cascade at 256-ray tiles with the t-bounded gate on every
    recheck, against the JAX package's (Pallas in interpret mode) with the
    same tuning on the same 4,096 rays.  Hit masks are equal; triangles are
    equal, and t within the rounding bound of tests/test_torch_modes.py,
    except on the rays where the port departs from its reference by design,
    each of which is listed and counted:

    * a tie: both triangles hold the hit point and give the same t within
      that bound (a shared edge), and the two sides rounded it apart (the
      JAX side through XLA's fused multiply-adds, the port breaking an
      exact tie to the smallest triangle id);
    * a hit on a box's face: the port's hit is nearer, and the ray's own
      slab test of the plain box of its chunk misses, so the JAX package,
      testing the boxes as they are, finds it only if another ray of the
      tile activates the chunk.

    Measured: 2 ties among 1,284 hits on the random rays, none among 1,509
    on the floor rays, and no hit on a box's face in either set."""
    _, scene = atrium
    o, d = _rays(scene, 4096, seed=20) if which == "random" else _floor_rays(scene, 4096, seed=3)
    kw = dict(super_min=0, super_tbound_min=1)
    want = jpi.closest_hit_chunks(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(scene.chunk_woop.numpy()),
        jnp.asarray(scene.chunk_aabb_min.numpy()), jnp.asarray(scene.chunk_aabb_max.numpy()),
        jnp.asarray(scene.woop.numpy()), EPS, ray_tile=256, interpret=True,
        tuning=JaxIntersectTuning(**kw))
    got = _cascade(scene, o, d, 256, **kw)
    hw, tw, rw = (np.asarray(x) for x in (want.hit, want.t, want.tri))
    hg, tg, rg = got.hit.numpy(), got.t.numpy(), got.tri.numpy()
    rows = scene.woop_rows.numpy()
    t_j, b_j, g_j, bound = _woop64(o, d, rows[rw])
    t_p, b_p, g_p, _ = _woop64(o, d, rows[rg])
    inside = lambda b, g: (b >= -1e-5) & (g >= -1e-5) & (b + g <= 1 + 1e-5)  # noqa: E731
    chunk = torch.from_numpy(rg // scene.chunk_woop.shape[2]).long()
    face = _own_slab_misses(o, d, got.t, scene.chunk_aabb_min[chunk],
                            scene.chunk_aabb_max[chunk]).numpy()
    assert hw.sum() > 1000
    assert not (hw & ~hg).any()
    with np.errstate(invalid="ignore"):  # inf - inf on the misses
        same = hw & hg & (rw == rg) & (np.abs(tg - tw) <= bound)
    differ = np.nonzero(hg & ~same)[0]
    ties = [int(i) for i in differ
            if hw[i] and abs(t_j[i] - t_p[i]) <= bound[i] and abs(tg[i] - tw[i]) <= bound[i]
            and inside(b_j[i], g_j[i]) and inside(b_p[i], g_p[i])]
    faces = [int(i) for i in differ
             if face[i] and (not hw[i] or tg[i] < tw[i] - bound[i])]
    unexplained = sorted(set(differ.tolist()) - set(ties) - set(faces))
    assert not unexplained, [(i, hw[i], tw[i], rw[i], tg[i], rg[i]) for i in unexplained]
    assert len(ties) + len(faces) <= 0.005 * hw.sum(), (ties, faces)
    print(which, "hits", int(hw.sum()), "ties", ties, "faces", faces)


def test_torch_exact_tie_goes_to_the_smallest_triangle_in_any_order(atrium):
    """Two groups holding the same 1,024 triangles tie exactly on every hit:
    in either worklist order, and from a tie carried in (tmin0, tidx0), B2's
    twin keeps the smaller triangle id, the first group's."""
    _, scene = atrium
    cw = torch.cat([scene.chunk_woop[:8], scene.chunk_woop[:8]])
    o, d = _rays(scene, 512, seed=22)
    rays = ci.pack_rays(o, d)
    inf, zero = torch.full((512,), float("inf")), torch.zeros(512, dtype=torch.int32)
    masks = torch.full((1, 2, 2), -1, dtype=torch.int32)

    def run(order, t0=inf, i0=zero):
        idx = torch.tensor([order], dtype=torch.int32)
        return ci.run_items_plain(rays, t0, i0, cw, idx, torch.tensor([len(order)], dtype=torch.int32),
                                  masks[:, :len(order)], EPS, ci.GROUP, 8)

    t01, tri01 = run([0, 1])
    t10, tri10 = run([1, 0])
    hit = torch.isfinite(t01)
    assert int(hit.sum()) > 20
    assert torch.equal(t01, t10) and torch.equal(tri01, tri10) and bool((tri01[hit] < 1024).all())
    t1, tri1 = run([1])
    assert torch.equal(t1, t01) and bool((tri1[hit] >= 1024).all())
    t_tie, tri_tie = run([0], t1, tri1)
    assert torch.equal(t_tie, t01) and torch.equal(tri_tie[hit], tri01[hit])


def test_torch_large_scene_switches_leave_a_pass_bit_equal(atrium):
    """A one-pass render with both switches engaged is bit-equal to one with
    neither and to one at the defaults; the calls' spans name the tile."""
    _, scene = atrium
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(32, 32))
    base = RenderConfig(spp_per_pass=2, rays_per_batch=1024)
    images, tiles = {}, {}
    for name, tuning in (("both", BOTH), ("neither", NEITHER), ("default", {})):
        cfg = dataclasses.replace(base, tuning=dataclasses.replace(base.tuning, **tuning))
        with profiling.span("test") as mark:
            images[name] = pt.render(scene, spp=2, seed=5, config=cfg)
        tiles[name] = {s.counts["ray_tile"] for s in profiling.spans()
                       if s.id > mark.id and s.name == "engine_call"}
    assert tiles == {"both": {256}, "neither": {512}, "default": {512}}
    assert np.array_equal(images["both"], images["neither"])
    assert np.array_equal(images["both"], images["default"])
    assert images["both"].mean() > 0


def _set_bits(counts, masks, group, n_sub):
    """B2's units counted directly: the set sub-tile bits of every chunk of
    every live slot (slot < counts[tile])."""
    total = 0
    m = masks.numpy().view(np.uint8)
    for t, n in enumerate(counts.tolist()):
        for s in range(n):
            for g in range(group):
                total += bin(int(m[t, s, g]) & ((1 << n_sub) - 1)).count("1")
    return total


def _gated_pairs(r, ray_tile, c, gate):
    """B1's tests counted directly: (tile, chunk) pairs of the 512-chunk
    blocks whose gate bit is set (every pair without a gate)."""
    t_tiles = r // ray_tile
    if gate is None:
        return t_tiles * c
    words = gate.numpy().astype(np.int64) & 0xFFFFFFFF
    return sum(min(ci.ACT_COLS, c - ci.ACT_COLS * b)
               for t in range(t_tiles) for b in range(-(-c // ci.ACT_COLS))
               if (words[t, b // 32] >> (b % 32)) & 1)


def _spy(monkeypatch):
    """Count B2's units, B1's tests and B3's pairs directly at every launch
    (the atrium's six lights take K1: no B3 launch, its counts stay 0)."""
    direct = dict.fromkeys(pt.WORK_COUNTS, 0)
    items, activity, pdf = ci.run_items, ci.tile_chunk_activity, ci.run_light_pdf

    def run_items(*args):
        direct["b2_units"] += _set_bits(args[5], args[6], args[8], args[9])
        return items(*args)

    def run_light_pdf(rays, cw, ck, box_min, box_max, idx, counts, min_dst):
        direct["b3_pairs"] += int(counts.sum()) * (rays.shape[0] // idx.shape[0])
        direct["b3_live"] += int(ci.light_pdf_entered_plain(rays, box_min, box_max, idx, counts,
                                                            min_dst).sum())
        return pdf(rays, cw, ck, box_min, box_max, idx, counts, min_dst)

    def tile_chunk_activity(rays, cmin, cmax, tbest, gate, min_dst, ray_tile, *rest, **kw):
        direct["b1_tests"] += _gated_pairs(rays.shape[0], ray_tile, cmin.shape[0], gate)
        return activity(rays, cmin, cmax, tbest, gate, min_dst, ray_tile, *rest, **kw)

    monkeypatch.setattr(ci, "run_items", run_items)
    monkeypatch.setattr(ci, "tile_chunk_activity", tile_chunk_activity)
    monkeypatch.setattr(ci, "run_light_pdf", run_light_pdf)
    return direct


@pytest.mark.parametrize("tuning", [BOTH, NEITHER, {}], ids=["both", "neither", "default"])
def test_torch_work_count_equals_the_worklists_set_bits(atrium, monkeypatch, tuning):
    """Under ``count_work`` one cascade call's ``b2_units`` are the set
    sub-tile bits of its live slots and its ``b1_tests`` the (tile, chunk)
    pairs its gates let through, counted directly; outside it nothing is
    counted."""
    _, scene = atrium
    o, d = _rays(scene, 1024, seed=21)
    direct = _spy(monkeypatch)
    work = torch.zeros(len(pt.WORK_COUNTS), dtype=torch.int64)
    with ci.count_work(work):
        _cascade(scene, o, d, 256 if tuning.get("narrow_tile_chunks") == 0 else 512, **tuning)
    got = dict(zip(pt.WORK_COUNTS, work.tolist()))
    assert got == direct and direct["b2_units"] > 0 and direct["b1_tests"] > 0
    _cascade(scene, o, d, 512, **tuning)
    assert work.tolist() == list(got.values()) and ci._WORK[0] is None


def _entry(name, path, scene, cfg, tmp_path, monkeypatch):
    if name == "render":
        pt.render(scene, spp=2, seed=1, config=cfg)
    elif name == "render_with_checkpoints":
        render_with_checkpoints(scene, spp=2, seed=1, config=cfg,
                                checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=1,
                                resume=False)
    elif name == "Renderer.render":
        Renderer(path, config=cfg, device="cpu").render(32, 32, 2, seed=1)
    else:
        monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("TPU_PT_NARROW_TILE_CHUNKS", "0")
        assert cli.main(["x", path, "32", "32", "2", str(tmp_path / "o.ppm")]) == 0


@pytest.mark.parametrize("entry", ["render", "render_with_checkpoints", "Renderer.render", "cli"])
def test_torch_every_entry_puts_work_counts_on_its_calls(atrium, tmp_path, monkeypatch, entry):
    """Each render entry's ``engine_call`` spans carry ``b2_units`` and
    ``b1_tests`` (read with the call's rays, summing to the launches'
    direct counts) and the static ``ray_tile`` and ``chunks``."""
    path, scene = atrium
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(32, 32))
    cfg = RenderConfig(rays_per_batch=512, tuning=dataclasses.replace(IntersectTuning(),
                                                                      narrow_tile_chunks=0))
    direct = _spy(monkeypatch)
    with profiling.span("test") as mark:
        _entry(entry, path, scene, cfg, tmp_path, monkeypatch)
    calls = [s for s in profiling.spans() if s.id > mark.id and s.name == "engine_call"]
    assert calls
    for c in calls:
        assert c.counts["ray_tile"] == 256 and c.counts["chunks"] == scene.chunk_woop.shape[0]
        assert c.counts["rays"] > 0 and c.counts["b2_units"] > 0 and c.counts["b1_tests"] > 0
    assert {k: sum(c.counts[k] for c in calls) for k in direct} == direct
