"""The persistent engine's loop in blocks of ``LOOP_ITERATIONS`` iterations
(``models/pathtracer.persistent_accum``): the "graph" loop (the default;
on the CPU its block runs without a CUDA graph, the body a graph captures
on CUDA) against the per-iteration "eager" loop, bit for bit, on every
path the render takes; the traced scalars as 0-d tensors; iterations past
the end; the compiled loop's buffers serving chunks, passes, seeds and
cameras; the tensor-key threefry against the JAX package's draws.  The
CUDA graph itself and the threefry kernel run in
``tests/test_torch_cuda.py`` (cuda marker)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer_torch import kernels
from tpu_pathtracer_torch.config import IntersectTuning, RenderConfig
from tpu_pathtracer_torch.models import pathtracer as pt
from tpu_pathtracer_torch.ops import chunk_intersect as ci
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.scene import fixtures
from tpu_pathtracer_torch.scene.gltf import parse_gltf_scene

torch.set_num_threads(1)


def _scene(path, w, h, config=None, ray_depth=None):
    scene = parse_gltf_scene(path, w / h, config or RenderConfig())
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(w, h))
    return dataclasses.replace(scene, ray_depth=ray_depth) if ray_depth else scene


def _thousand_lights(path):
    """A floor under 500 small emissive ceiling quads: 1,000 lights, more
    than 512, so the light pdf takes the cluster worklists (B3's path)."""
    b = fixtures.GltfBuilder()
    floor = b.add_material((0.8, 0.8, 0.8, 1))
    lightm = b.add_material((0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=2.0)
    b.add_mesh(*fixtures.quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20)),
               material=floor)
    rng = np.random.default_rng(1)
    for cx, cz in rng.uniform(-10, 10, (500, 2)):
        b.add_mesh(*fixtures.quad((cx - 0.2, 4.0, cz - 0.2), (cx + 0.2, 4.0, cz - 0.2),
                                  (cx + 0.2, 4.0, cz + 0.2), (cx - 0.2, 4.0, cz + 0.2)),
                   material=lightm)
    b.add_camera((0, 1.5, 8.0), yfov=0.8)
    return b.write(path)


def _case(name, tmp):
    """(scene, config, spp) of each path the render takes."""
    if name == "cornell":
        return _scene(fixtures.make_cornell_gltf(str(tmp / "c.gltf")), 16, 16), RenderConfig(), 3
    if name in ("atrium_items", "atrium_twopass"):
        path = fixtures.make_atrium_gltf(str(tmp / "a.gltf"), detail=1, textured=False)
        mode = name.split("_")[1]
        config = RenderConfig(tuning=IntersectTuning(mode=mode))
        return _scene(path, 64, 32, ray_depth=3), config, 1
    if name == "env_field":
        path = fixtures.make_sphere_field_gltf(str(tmp / "f.gltf"), n_spheres=4, subdiv=2,
                                               textured=True)
        config = RenderConfig(use_env_map=True, add_light_triangle=True,
                              env_map_path=fixtures.make_env_hdr(str(tmp / "env.hdr")))
        return _scene(path, 64, 32, config, ray_depth=4), config, 2
    if name == "many_lights":
        return _scene(_thousand_lights(str(tmp / "l.gltf")), 16, 16), RenderConfig(), 2
    raise ValueError(name)


CASES = ["cornell", "atrium_items", "atrium_twopass", "env_field", "many_lights"]


@pytest.mark.parametrize("case", CASES)
def test_torch_batched_loop_equals_eager(case, tmp_path, monkeypatch):
    """Blocks of ``LOOP_ITERATIONS`` iterations with one host read each give
    the per-iteration loop's frame and measured rays bit for bit, and run
    at least as many iterations, in whole blocks.
    The atrium cases run the sort (2,048 lanes, > 1,024 triangles); the
    many-light case runs B3's twin."""
    scene, config, spp = _case(case, tmp_path)
    pdf_calls = []
    real_pdf = ci.run_light_pdf
    monkeypatch.setattr(ci, "run_light_pdf", lambda *a: pdf_calls.append(1) or real_pdf(*a))
    out = {}
    for loop in ("eager", "graph"):
        stats = {}
        pt.persistent_accum.iterations = 0
        img = pt.render(scene, spp=spp, seed=5, config=config, stats=stats,
                        eager=loop == "eager")
        out[loop] = (img, stats["measured_rays"], pt.persistent_accum.iterations, stats["loop"])
    (want, rays_e, it_e, loop_e), (got, rays_b, it_b, loop_b) = out["eager"], out["graph"]
    assert (loop_e, loop_b) == ("eager", "graph")
    assert np.isfinite(want).all() and want.max() > 0
    assert np.array_equal(got, want)
    assert rays_b == rays_e > 0
    assert it_e <= it_b and it_b % pt.LOOP_ITERATIONS == 0
    if case == "many_lights":
        assert scene.lights.capacity > 512 and pdf_calls
    if case.startswith("atrium"):
        assert scene.capacity > 1024 and scene.camera.width * scene.camera.height >= 2048


def test_torch_loop_choice(tmp_path):
    """"graph" by default, "eager" when asked for, and "eager" for
    intersector mode "bins" on CUDA (it reads the host, which a graph cannot
    hold); a render's ``stats["loop"]`` says which ran."""
    bins = RenderConfig(tuning=IntersectTuning(mode="bins"))
    assert pt.engine_loop(RenderConfig(), "cpu") == pt.engine_loop(bins, "cpu") == "graph"
    assert pt.engine_loop(RenderConfig(), "cuda") == "graph"
    assert pt.engine_loop(bins, "cuda") == "eager"
    assert pt.engine_loop(RenderConfig(), "cpu", eager=True) == "eager"
    assert pt.engine_loop(RenderConfig(), "cuda", eager=True) == "eager"
    scene, config, spp = _case("cornell", tmp_path)
    stats = {}
    pt.render(scene, spp=1, config=config, stats=stats)
    assert stats["loop"] == "graph"


def test_torch_traced_scalars_as_device_tensors(tmp_path):
    """``chunk_start``, ``seed``, ``sample_start``, ``w_total`` and
    ``pix_count`` given as 0-d tensors (the JAX package's traced arguments)
    give the Python ints' accumulator and rays bit for bit, on a pool that
    starts mid-frame and has fewer pixels than lanes."""
    scene, config, _ = _case("cornell", tmp_path)
    args = dict(chunk_start=37, seed=2**32 + 9, sample_start=3, w_total=200 * 2, pix_count=200)
    want = pt.persistent_accum(scene, args["chunk_start"], args["seed"], args["sample_start"],
                               256, args["w_total"], config, pix_count=args["pix_count"])
    t = {k: torch.tensor(v, dtype=torch.int64) for k, v in args.items()}
    got = pt.persistent_accum(scene, t["chunk_start"], t["seed"], t["sample_start"], 256,
                              t["w_total"], config, pix_count=t["pix_count"])
    assert float(want[0].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    mixed = pt.render_chunk_persistent(scene, t["chunk_start"], 9, 3, 256, 2, config,
                                       pix_count=torch.tensor(200))
    ints = pt.render_chunk_persistent(scene, 37, 9, 3, 256, 2, config, pix_count=200)
    assert torch.equal(mixed[0], ints[0]) and torch.equal(mixed[1], ints[1])


def test_torch_iterations_past_the_end_change_nothing(tmp_path):
    """Once no lane is alive and no work is left, further iterations leave
    every row of the accumulator that reaches the frame, the rays traced,
    ``alive``, ``active`` and ``next_work`` as they were: what makes the
    blocks of the graph loop exact."""
    scene, config, _ = _case("cornell", tmp_path)
    scalars = pt._traced_scalars(scene.device, 0, 4, 0, 256 * 2, 256)
    body = pt._PersistentLoop(scene, config, 256, 256, scene.camera, scalars)
    c = body.start()
    n = 0
    while bool(body.more(c)):
        c = body.iteration(c)
        n += 1
    assert n > 3
    accum = body.accum[:256].clone()
    for _ in range(pt.LOOP_ITERATIONS * 2):
        later = body.iteration(c)
        assert torch.equal(body.accum[:256], accum)
        assert torch.equal(later["n_bounce"], c["n_bounce"])
        assert not bool(later["alive"].any()) and not bool(later["active"].any())
        assert int(later["next_work"]) == 512
        c = later
    assert float(accum.sum()) > 0


def test_torch_compiled_loop_buffers_serve_every_call(tmp_path, capsys):
    """The compiled loop's bookkeeping (on the CPU its block runs on the
    cached buffers with no graph): one cached loop serves several chunks of
    a frame, two seeds, two passes and a moved camera, each equal to the
    eager loop's frame and rays; the cache keeps at most ``GRAPH_CACHE``
    loops."""
    pt.clear_compiled_loops()
    scene, config, _ = _case("cornell", tmp_path)
    big = dataclasses.replace(scene, camera=scene.camera.with_dims(24, 24))  # 3 chunks of 256
    config = dataclasses.replace(config, rays_per_batch=256, frame_pool=False, spp_per_pass=1)
    moved = dataclasses.replace(big, camera=dataclasses.replace(
        big.camera, position=big.camera.position + torch.tensor([0.3, 0.0, 0.0])))
    for s, seed in ((big, 1), (big, 7), (moved, 7)):
        want_stats, got_stats = {}, {}
        want = pt.render(s, spp=2, seed=seed, config=config, stats=want_stats, eager=True)
        got = pt.render(s, spp=2, seed=seed, config=config, stats=got_stats)
        assert np.array_equal(got, want)
        assert got_stats == {**want_stats, "loop": "graph"}
    (entry,) = pt._GRAPHS.values()
    assert entry["block"].graph is None  # no capture on the CPU
    # No render reached its result through a retry.
    assert "execution failed" not in capsys.readouterr().err
    # More static configurations than the cache keeps: the oldest go.
    for rows in range(256, 256 + pt.GRAPH_CACHE + 2):
        pt.persistent_accum(big, 0, 1, 0, 256, 256, config, accum_rows=rows)
    assert len(pt._GRAPHS) == pt.GRAPH_CACHE
    pt.clear_compiled_loops()


def test_torch_compiled_loop_key_follows_in_place_writes(tmp_path):
    """The compiled loop's cache key changes after an in-place write to any
    of the scene's tensors (a CUDA graph captured before it would read the
    stale copies ``kernels.made_once`` derived), and not after a write to
    the camera's, which every call copies in; a render after the write
    equals the eager loop's and runs in a loop of its own."""
    pt.clear_compiled_loops()
    scene, config, _ = _case("cornell", tmp_path)
    args = (config, 256, 256, pt.LOOP_ITERATIONS)
    key = pt._static_key(scene, *args)[0]
    assert pt._static_key(scene, *args)[0] == key
    scene.camera.position.add_(0.1)
    assert pt._static_key(scene, *args)[0] == key
    for name in ("chunk_woop", "chunk_aabb_min", "shade_attrs"):
        getattr(scene, name).mul_(1.0)
        assert pt._static_key(scene, *args)[0] != key, name
        key = pt._static_key(scene, *args)[0]
    before = pt.render(scene, spp=1, seed=3, config=config)
    scene.bg_color.add_(0.5)
    want_stats, got_stats = {}, {}
    want = pt.render(scene, spp=1, seed=3, config=config, stats=want_stats, eager=True)
    got = pt.render(scene, spp=1, seed=3, config=config, stats=got_stats)
    assert not np.array_equal(want, before)
    assert np.array_equal(got, want)
    assert got_stats == {**want_stats, "loop": "graph"}
    assert len(pt._GRAPHS) == 2
    pt.clear_compiled_loops()


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_torch_tensor_key_threefry_equals_jax(seed):
    """``lane_uniforms`` with the seed as a 0-d tensor (how the compiled
    loop passes it) equals the JAX package's draws bit for bit, for the
    bounce draws (per-lane sample and depth), the camera jitter and a
    scalar (sample, depth)."""
    rs = np.random.default_rng(seed % 1000)
    pix = rs.integers(0, 2**31 - 1, size=300).astype(np.int32)
    sample = rs.integers(0, 70_000, size=300).astype(np.int32)
    depth = rs.integers(0, 9, size=300).astype(np.int32)
    key = jax.random.key(seed)
    t_seed = torch.tensor(seed, dtype=torch.int64)
    for s, b, n in ((sample, depth, pt._DRAWS), (sample, trng.JITTER_DEPTH, 2), (5, 3, 7)):
        got = trng.lane_uniforms(t_seed, torch.as_tensor(s), torch.as_tensor(b),
                                 torch.from_numpy(pix), n).numpy()
        want = np.asarray(jrng.lane_uniforms(key, jnp.asarray(s), jnp.asarray(b),
                                             jnp.asarray(pix), n))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = trng.jitter_uniforms(t_seed, torch.from_numpy(sample), torch.from_numpy(pix)).numpy()
    want = np.asarray(jrng.jitter_uniforms(key, jnp.asarray(sample), jnp.asarray(pix)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_torch_graph_replays_count_every_kernel_wrapper():
    """Every launch is counted in one place, ``kernels.launches``, which a
    graph replay adds its captured launches to: each launcher of
    ``kernels.py`` counts under one name of the kernel table, the thirteen
    names between them, no module of the port keeps a ``launches`` counter
    of its own, and ``models/graph.py`` (below the models) imports nothing
    of ``ops`` or ``models``."""
    import ast
    import importlib
    import pkgutil

    import tpu_pathtracer_torch

    with open(kernels.__file__) as f:
        tree = ast.parse(f.read())
    counted = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef):
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and getattr(call.func, "id", None) == "_launched":
                    counted.setdefault(fn.name, []).append(call.args[2].value)
    assert all(len(names) == 1 for names in counted.values()), counted
    assert sorted(n for (n,) in counted.values()) == sorted(
        [f"b{i}" for i in range(1, 8)] + ["rng"] + [f"k{i}" for i in range(1, 6)])
    modules = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        tpu_pathtracer_torch.__path__, "tpu_pathtracer_torch.") if not m.name.endswith("__main__")]
    assert kernels in modules and pt in modules and ci in modules
    keeping = [(mod.__name__, name) for mod in modules for name, v in vars(mod).items()
               if name == "launches" or (callable(v) and hasattr(v, "launches"))]
    assert keeping == [("tpu_pathtracer_torch.kernels", "launches")]
    from tpu_pathtracer_torch.models import graph

    with open(graph.__file__) as f:
        imports = [(n.level, n.module or "", [a.name for a in n.names])
                   for n in ast.walk(ast.parse(f.read())) if isinstance(n, ast.ImportFrom)]
    assert imports and not [i for i in imports if i[0] == 1 or (i[0] and (
        i[1].split(".")[0] in ("ops", "models") or {"ops", "models"} & set(i[2])))]


def test_torch_threefry_wrapper_dispatch():
    """The threefry wrapper takes its twin for CPU tensors and counts no
    launch; any device other than the CPU or CUDA raises."""
    pix = torch.arange(64, dtype=torch.int32)
    got = trng.lane_uniforms_key(0, torch.tensor(3), 2, 1, pix, 4)
    assert torch.equal(got, trng.lane_uniforms_key_plain(0, 3, 2, 1, pix, 4))
    assert kernels.launches["rng"] == 0
    with pytest.raises(RuntimeError, match="no kernel"):
        trng.lane_uniforms_key(0, 3, 2, 1, torch.zeros(64, dtype=torch.int32, device="meta"), 4)


class _HostWatch(TorchDispatchMode):
    """Records the operations that would copy from the host (``torch.tensor``
    of Python data, list indexing: ``lift_fresh``) or read the device from
    the host (``item``, ``bool``: ``_local_scalar_dense``; ``nonzero``),
    neither of which a CUDA graph can hold."""

    HOST = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "nonzero", "equal",
            "is_nonzero"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.HOST:
            self.seen.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _opaque(fn):
    """``fn`` run outside the watch: a kernel wrapper, whose CPU branch is the
    plain twin (free to read the host) and whose CUDA branch is a launch."""
    def run(*a, **kw):
        with _disable_current_modes():
            return fn(*a, **kw)
    return run


BODY_CASES = {
    "cornell": ("cornell", {}),
    "atrium_items": ("atrium_items", {}),
    "atrium_twopass": ("atrium_twopass", {}),
    "atrium_dense": ("atrium_items", {"tuning": IntersectTuning(mode="dense")}),
    "atrium_cheap2": ("atrium_items", {"tuning": IntersectTuning(cheap_recheck=2)}),
    "sort_target": ("atrium_items", {"sort_key": "target"}),
    "sort_cell": ("atrium_items", {"sort_key": "cell"}),
    "sort_dirhint": ("atrium_items", {"sort_key": "dirhint"}),
    "sobol": ("atrium_items", {"jitter": "sobol", "lowdisc": "sobol"}),
    "env_field": ("env_field", {}),
    "many_lights": ("many_lights", {}),
    "bins": ("atrium_items", {"tuning": IntersectTuning(mode="bins")}),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_torch_loop_body_holds_no_host_traffic(case, tmp_path, monkeypatch):
    """After one warm-up iteration (which fills every made-once cache, as the
    graph's first block does), an iteration of the loop body copies nothing
    from the host and reads nothing back, outside the kernel wrappers: what
    a CUDA graph capture needs.  Mode "bins" does read the host, which is
    why it keeps the eager loop."""
    for name in ("tile_chunk_activity", "run_items", "run_light_pdf", "nearest_box_ids",
                 "run_dense", "run_slots", "ray_group_bools"):
        monkeypatch.setattr(ci, name, _opaque(getattr(ci, name)))
    monkeypatch.setattr(trng, "lane_uniforms_key", _opaque(trng.lane_uniforms_key))
    base, change = BODY_CASES[case]
    scene, config, _ = _case(base, tmp_path)
    config = dataclasses.replace(config, **change)
    n = scene.camera.width * scene.camera.height
    lanes = n + (-n) % ci.RAY_TILE
    scalars = pt._traced_scalars(scene.device, 0, 3, 0, n * 2, n)
    body = pt._PersistentLoop(scene, config, lanes, n, scene.camera, scalars)
    c = body.iteration(body.start())
    watch = _HostWatch()
    with watch:
        body.iteration(c)
    if case == "bins":
        assert "nonzero" in watch.seen and "_local_scalar_dense" in watch.seen
    else:
        assert watch.seen == []
