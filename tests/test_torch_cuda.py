"""``add_rows``, the persistent engine's accumulation, adds repeated rows in
the same order on every run; on the card, the threefry kernel and the
cascade's worklist kernel (K5) equal their twins, and the CUDA graphs of the persistent loop, the scan engine and the
homebrew renderers equal their eager loops, each captured once and
replayed; a capture that fails raises without a retry.  The CUDA
cases have the marker ``cuda`` and skip on a machine without a card; on the
card run ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import kernels
from tpu_pathtracer_torch.models.pathtracer import add_rows
from tpu_pathtracer_torch.ops import chunk_intersect as ci


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_torch_add_rows_repeats_exactly(device):
    """Rows that repeat (lanes finishing samples of one pixel in the same
    iteration) give the same bits on every run, so renders repeat exactly
    and a resumed render equals an uninterrupted one (``index_add_`` fails
    this on the card: float atomics in arbitrary order).  On the CPU the sum
    is the serial one; on the card its order is fixed but not serial."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 257, (65536,), generator=g)
    values = torch.rand((65536, 3), generator=g) * torch.logspace(-3, 3, 65536)[:, None]
    serial = torch.ones((258, 3))
    for r, v in zip(rows.tolist(), values):
        serial[r] += v
    runs = [add_rows(torch.ones((258, 3), device=device), rows.to(device), values.to(device)).cpu()
            for _ in range(4)]
    assert all(torch.equal(run, runs[0]) for run in runs)
    if device == "cpu":
        assert torch.equal(runs[0], serial)
    else:
        torch.testing.assert_close(runs[0], serial, rtol=1e-5, atol=0)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def worklist_case(seed, t_tiles, cg, group, n_sub, passes=3, p_active=0.3, ties=False,
                  empty_tiles=0, with_cbits=False):
    """Inputs of a cascade's worklist passes (``ci.worklist_pass``) as B1
    leaves them, from numpy's generator: an initial activity of ``n_sub``
    bits a chunk, its chunk entries ``ent`` (finite exactly where a bit is
    set; with ``ties`` three values, so group entries tie), and for each
    pass an activity whose bits are a subset of the initial ones (a
    recheck only clears bits), the first ``empty_tiles`` tiles with none;
    and the coarse gate words [T, ceil(C / 16384)] or None.  Returns
    (m8 per pass, ent, cbits) as CPU tensors."""
    rs = np.random.default_rng(seed)
    c = cg * group
    m0 = rs.integers(1, 1 << n_sub, size=(t_tiles, c))
    m0[rs.random((t_tiles, c)) > p_active] = 0
    vals = rs.integers(1, 4, size=(t_tiles, c)) if ties else rs.uniform(1e-4, 9.0, (t_tiles, c))
    ent = np.where(m0 != 0, vals, np.inf).astype(np.float32)
    m8s = []
    for k in range(passes):
        keep = m0 if k == 0 else m0 & rs.integers(0, 256, size=(t_tiles, c))
        keep = np.where(rs.random((t_tiles, c)) < 0.5, keep, 0) if k else keep
        keep[:empty_tiles] = 0
        m8s.append(torch.from_numpy(keep.astype(np.int32)))
    cbits = None
    if with_cbits:
        cbits = torch.from_numpy(rs.integers(-2**31, 2**31, size=(t_tiles, -(-c // 16384)))
                                 .astype(np.int32))
    return m8s, torch.from_numpy(ent), cbits


def worklist_caps(cg):
    """The cascade's pass caps over ``cg`` groups at the default tuning
    (near passes 2 and 6 quarters of max(4, cg // 9), then the residual)."""
    base = max(4, cg // 9)
    return [cap for cap in (2 * base // 4, 6 * base // 4) if cap < cg] + [cg]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 213, 8, 8), (256, 1203, 8, 4), (16, 4500, 8, 8),
                                   (64, 81, 3, 2)],
                         ids=["atrium", "bigatrium", "past_shared_memory", "group3"])
@pytest.mark.parametrize("with_cbits", [False, True])
def test_torch_worklist_kernel_equals_twin(shape, with_cbits):
    """K5 (``csrc/chunk_kernels.cu`` ``worklist_kernel``) against its twin,
    the cascade's torch chain, bit for bit over a whole cascade's passes
    (``tested`` carried from pass to pass on both sides): the atrium's 128
    tiles x 213 groups, ``bigatrium``'s 256 x 1,203 at 4 sub-tiles, 4,500
    groups (the keys past shared memory, in global scratch) and groups of
    3 chunks; entries tied, a tile with no active group, the gate words
    with and without the coarse gate."""
    _needs_card()
    t_tiles, cg, group, n_sub = shape
    m8s, ent, cbits = worklist_case(t_tiles + cg, t_tiles, cg, group, n_sub, ties=True,
                                    empty_tiles=1, with_cbits=with_cbits)
    ent = ent.cuda()
    cbits = None if cbits is None else cbits.cuda()
    tested_k = torch.zeros((t_tiles, cg), dtype=torch.bool, device="cuda")
    tested_p = tested_k.clone()
    launches = kernels.launches["k5"]
    caps = worklist_caps(cg)
    for m8, cap in zip(m8s, caps):
        gate = cap < cg
        got = ci.worklist_pass(m8.cuda(), ent, tested_k, cap, group, n_sub, cbits, gate)
        want = ci.worklist_pass_plain(m8.cuda(), ent, tested_p, cap, group, n_sub, cbits, gate)
        for name, g, w in zip(ci.Worklist._fields, got, want):
            assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), (name, cap)
        assert torch.equal(tested_k, tested_p), cap
        assert int(got.counts.max()) == cap or cap == cg
    assert kernels.launches["k5"] == launches + len(caps)


@pytest.mark.cuda
def test_torch_threefry_kernel_equals_twin():
    """The threefry kernel (``csrc/rng_kernels.cu``) against its plain twin,
    bit for bit: the bounce draws with the seed as a device scalar, the
    camera jitter, the key-words form with scalar (sample, depth), and a
    device-scalar sample past 2^32."""
    _needs_card()
    from tpu_pathtracer_torch.ops import rng

    g = torch.Generator().manual_seed(3)
    pix = torch.randint(0, 2**31 - 1, (70_001,), generator=g, dtype=torch.int32).cuda()
    smp = torch.randint(0, 70_000, (70_001,), generator=g, dtype=torch.int32).cuda()
    dep = torch.randint(0, 9, (70_001,), generator=g, dtype=torch.int32).cuda()
    seed = torch.tensor(2**32 + 7, device="cuda")
    for args in ((*rng.key_words(seed), smp, dep, pix, 10),
                 (*rng.key_words(seed), smp, rng.JITTER_DEPTH, pix, 2),
                 (*rng.fold_in(0, 7, 3), 5, 0, pix, 7),
                 (0, 99, torch.tensor(2**33 + 3, device="cuda"), 4, pix, 9)):
        launches = kernels.launches["rng"]
        got = rng.lane_uniforms_key(*args)
        assert kernels.launches["rng"] == launches + 1
        want = rng.lane_uniforms_key_plain(*args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 65_537])
@pytest.mark.parametrize("base_form", ["int", "tensor"])
def test_torch_threefry_instances_equal_twin(lanes, base_form):
    """Every instance of the threefry kernel (10, 4 and 2 draws) and the
    generic one (1, 7 and 8 draws) against the twin, bit for bit, at one
    lane and at a lane count no block shape divides, with the sample and
    pixel bases as ints or as device scalars past 2^32."""
    _needs_card()
    from tpu_pathtracer_torch.ops import rng

    g = torch.Generator().manual_seed(lanes)
    slot, smp, dep = (torch.randint(0, hi, (lanes,), generator=g, dtype=torch.int32).cuda()
                      for hi in (2**31 - 1, 70_000, 9))
    sb, pb = 2**32 + 11, 2**33 + 5
    if base_form == "tensor":
        sb, pb = torch.tensor(sb, device="cuda"), torch.tensor(pb, device="cuda")
    seed = torch.tensor(2**32 + 7, device="cuda")
    for n_draws in (10, 4, 2, 1, 7, 8):
        got = rng.lane_uniforms_key(0, seed, smp, dep, slot, n_draws, sb, pb)
        want = rng.lane_uniforms_key_plain(0, seed, smp, dep, slot, n_draws, sb, pb)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), n_draws


@pytest.mark.cuda
def test_torch_graph_loop_equals_eager(tmp_path):
    """The persistent engine's loop as a CUDA graph against the eager loop on
    the atrium (sort on, kernels B1 / B2): frames identical and measured
    rays equal, twice through the cached graph, with a moved camera."""
    _needs_card()
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    path = fixtures.make_atrium_gltf(str(tmp_path / "a.gltf"), detail=1, textured=False)
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(96, 96)).to("cuda")
    moved = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, position=scene.camera.position + torch.tensor([0.4, 0.0, 0.0], device="cuda")))
    captures = CapturedBlock.captures
    for s in (scene, moved):
        want_stats, got_stats = {}, {}
        want = pt.render(s, spp=2, seed=1, stats=want_stats, eager=True)
        got = pt.render(s, spp=2, seed=1, stats=got_stats)
        assert got_stats["loop"] == "graph"
        assert np.array_equal(got, want)
        assert got_stats["measured_rays"] == want_stats["measured_rays"]
    assert CapturedBlock.captures == captures + 1
    pt.clear_compiled_loops()


@pytest.mark.cuda
def test_torch_graph_loop_alternates_chunk_widths(tmp_path):
    """Two atrium scenes of different chunk widths under mode "twopass" (so
    B6, whose shared memory grows with the chunk width, runs in the graph),
    in turns through their cached graphs: the wider scene's graph, replayed
    after the narrower scene ran, still launches and equals the eager loop."""
    _needs_card()
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.config import IntersectTuning, RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock
    from tpu_pathtracer_torch.ops import chunk_intersect as ci
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    path = fixtures.make_atrium_gltf(str(tmp_path / "a.gltf"), detail=1, textured=False)
    scenes = []
    for chunk_tris in (128, 64):
        config = RenderConfig(tuning=IntersectTuning(mode="twopass", chunk_tris=chunk_tris))
        scene = parse_gltf_scene(path, 1.0, config)
        scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64)).to("cuda")
        scenes.append((scene, config))
    pt.clear_compiled_loops()
    captures = CapturedBlock.captures
    for scene, config in scenes + scenes:
        want_stats, got_stats = {}, {}
        want = pt.render(scene, spp=1, seed=2, config=config, stats=want_stats, eager=True)
        slots = kernels.launches["b6"]
        got = pt.render(scene, spp=1, seed=2, config=config, stats=got_stats)
        assert got_stats["loop"] == "graph" and kernels.launches["b6"] > slots
        assert np.array_equal(got, want)
        assert got_stats["measured_rays"] == want_stats["measured_rays"]
    assert CapturedBlock.captures == captures + 2
    pt.clear_compiled_loops()


@pytest.mark.cuda
def test_torch_graph_cache_sees_in_place_edit(tmp_path):
    """A cached graph after an in-place write to a scene tensor: half the
    atrium's chunks are emptied (their Woop blocks set to NaN) between two
    graphed renders, and the second render equals an eager render of the
    edited scene, not the first render (a graph reads the copies derived
    from the scene's tensors when it was captured, which the write makes
    stale)."""
    _needs_card()
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    path = fixtures.make_atrium_gltf(str(tmp_path / "a.gltf"), detail=1, textured=False)
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(96, 96)).to("cuda")
    pt.clear_compiled_loops()
    stats = {}
    before = pt.render(scene, spp=2, seed=1, stats=stats)
    assert stats["loop"] == "graph"
    scene.chunk_woop[::2] = float("nan")
    got = pt.render(scene, spp=2, seed=1)
    want = pt.render(scene, spp=2, seed=1, eager=True)
    assert not np.array_equal(want, before)
    assert np.array_equal(got, want)
    pt.clear_compiled_loops()


@pytest.mark.cuda
def test_torch_scan_graph_equals_eager(tmp_path):
    """The scan engine's sample body as a CUDA graph against the eager
    early-exit loop on the atrium (sort, kernels B1 / B2, threefry): over
    three chunks, two passes and two seeds the frames are identical, the
    body is captured once, and every later sample is one replay."""
    _needs_card()
    import dataclasses

    import numpy as np

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    path = fixtures.make_atrium_gltf(str(tmp_path / "a.gltf"), detail=1, textured=False)
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(96, 96)).to("cuda")
    config = RenderConfig(compaction=False, rays_per_batch=4096, spp_per_pass=1)
    chunks = -(-96 * 96 // 4096)
    pt.clear_compiled_loops()
    captures, replays = CapturedBlock.captures, CapturedBlock.replays
    for seed in (1, 2):
        want = pt.render(scene, spp=2, seed=seed, config=config, eager=True)
        got = pt.render(scene, spp=2, seed=seed, config=config)
        assert np.isfinite(got).all() and got.max() > 0
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert CapturedBlock.captures == captures + 1
    assert CapturedBlock.replays == replays + 2 * chunks * 2 - 1
    pt.clear_compiled_loops()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["target", "cell", "dirhint", "none", "twopass", "dense",
                                  "cheap2", "sobol", "many_lights"])
def test_torch_scan_graph_holds_every_path(case, tmp_path):
    """The scan engine's graph on every path its body can take, each frame
    identical to the eager loop's: the atrium (2,048 lanes, sorted) under
    every sort key (B4 under "target"), the intersector modes "twopass"
    (B6) and "dense" (B5), the cheap recheck, Sobol draws, and a scene of
    1,000 lights (B3)."""
    _needs_card()
    import dataclasses

    import numpy as np

    from test_torch_graph_loop import _case
    from tpu_pathtracer_torch.config import IntersectTuning
    from tpu_pathtracer_torch.models import pathtracer as pt

    change = {"twopass": {"tuning": IntersectTuning(mode="twopass")},
              "dense": {"tuning": IntersectTuning(mode="dense")},
              "cheap2": {"tuning": IntersectTuning(cheap_recheck=2)},
              "sobol": {"jitter": "sobol", "lowdisc": "sobol"}}.get(case, {"sort_key": case})
    scene, config, _ = _case("many_lights" if case == "many_lights" else "atrium_items", tmp_path)
    scene = scene.to("cuda")
    config = dataclasses.replace(config, compaction=False,
                                 **({} if case == "many_lights" else change))
    pt.clear_compiled_loops()
    want = pt.render(scene, spp=2, seed=4, config=config, eager=True)
    got = pt.render(scene, spp=2, seed=4, config=config)
    assert np.isfinite(got).all() and got.max() > 0
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    pt.clear_compiled_loops()


@pytest.mark.cuda
def test_torch_homebrew_graphs_equal_eager(tmp_path):
    """The Monte-Carlo sample body and the Whitted search's blocks as CUDA
    graphs against the eager loops, over three chunks and two seeds: frames
    identical, one capture per static configuration, one replay per later
    sample (Monte-Carlo) or block (Whitted)."""
    _needs_card()
    import numpy as np

    from test_torch_legacy import SCENES, _write
    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import legacy
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CapturedBlock
    from tpu_pathtracer_torch.scene.homebrew import parse_homebrew_scene

    config = RenderConfig(rays_per_batch=100)  # 16x16: three chunks
    for name in ("mc", "whitted"):
        scene = parse_homebrew_scene(_write(tmp_path, name, SCENES[name])).to("cuda")
        pt.clear_compiled_loops()
        captures, replays = CapturedBlock.captures, CapturedBlock.replays
        runs = 0
        for seed in (3, 4):
            want = legacy.render_homebrew(scene, seed=seed, config=config, eager=True)
            legacy.render_homebrew.iterations = 0
            got = legacy.render_homebrew(scene, seed=seed, config=config)
            runs += legacy.render_homebrew.iterations // (
                1 if name == "mc" else legacy.WHITTED_ITERATIONS)
            assert np.isfinite(got).all() and got.max() > 0
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), name
        assert CapturedBlock.captures == captures + 1, name
        assert CapturedBlock.replays == replays + runs - 1, name
        if name == "mc":
            assert runs == 2 * 3 * scene.samples
    pt.clear_compiled_loops()


@pytest.mark.cuda
def test_torch_failed_capture_raises_without_retry(tmp_path, monkeypatch, capsys):
    """A body that reads the host fails its capture on the card: ``render``
    raises ``CaptureError`` at once, without a retry, though it may retry
    failed executions; the eager loop of the same body renders."""
    _needs_card()
    import dataclasses

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models import pathtracer as pt
    from tpu_pathtracer_torch.models.graph import CaptureError
    from tpu_pathtracer_torch.scene import fixtures
    from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

    path = fixtures.make_cornell_gltf(str(tmp_path / "c.gltf"))
    scene = parse_gltf_scene(path, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(16, 16)).to("cuda")
    real = pt.sanitize_nans
    monkeypatch.setattr(pt, "sanitize_nans", lambda c: real(c) + 0.0 * float(c.sum()))
    config = RenderConfig(compaction=False, failure_retries=2)
    pt.clear_compiled_loops()
    with pytest.raises(CaptureError):
        pt.render(scene, spp=2, seed=1, config=config)
    assert "retrying" not in capsys.readouterr().err
    pt.clear_compiled_loops()
    assert pt.render(scene, spp=2, seed=1, config=config, eager=True).max() > 0
