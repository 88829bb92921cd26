"""Multi-host rendering: sample farming across hosts (port of
``tpu_pathtracer/parallel/multihost.py``).

A host is a ``torchrun`` node: ``LOCAL_WORLD_SIZE`` processes, one per
device, whose ranks form a contiguous block of the world.  Every host
renders a disjoint range of samples of the same replicated scene over its
own local mesh (``mesh.render_sharded``), and one ``all_gather`` plus a sum
in host order merges the hosts' images.  Because the draws are keyed per
(pixel, sample), the union of any disjoint split is the single-host render.

Launch one process per device with ``torchrun`` (or set ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` yourself), call ``maybe_initialize_distributed`` and then
``render_multihost``; ``parallel/worker.py`` does both.  Without that
environment everything runs in one process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.pathtracer import background
from ..scene.types import TriangleScene
from .checkpoint import resume_or_start, scene_fingerprint
from .mesh import TIMEOUT, Mesh, gather_in_rank_order, make_mesh, render_sharded


def maybe_initialize_distributed(device: Optional[torch.device] = None,
                                 init_method: Optional[str] = None) -> bool:
    """Join the process group that ``torchrun``'s environment describes.

    When ``WORLD_SIZE`` > 1 and no group exists yet, initialise one: NCCL
    when ``device`` (default ``cli.select_device()``) is CUDA, after making
    ``cuda:LOCAL_RANK`` this process's device, and gloo on the CPU.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``).  Returns whether the world has more than one process;
    without the environment it does nothing and returns False."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if device is None:
            from ..cli import select_device

            device = select_device()
        backend = "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            backend = "nccl"
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=int(os.environ["RANK"]), timeout=TIMEOUT)
    return dist.is_initialized() and dist.get_world_size() > 1


@dataclasses.dataclass(frozen=True)
class Hosts:
    """The world as hosts: ``count`` hosts, this process on host ``index``;
    ``mesh`` is its host's local mesh (all local ranks on the "rays" axis)
    and ``cross_group`` joins the ranks of the same local rank on every
    host (the cross-host merge; None on one host)."""

    count: int
    index: int
    mesh: Mesh
    cross_group: Optional[dist.ProcessGroup] = None


def hosts() -> Hosts:
    """Map the world to hosts: ``WORLD_SIZE / LOCAL_WORLD_SIZE`` of them,
    this one ``RANK // LOCAL_WORLD_SIZE`` (one host when
    ``LOCAL_WORLD_SIZE`` is unset).  Creates process groups, so every rank
    calls it."""
    if not dist.is_initialized():
        return Hosts(1, 0, make_mesh())
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide WORLD_SIZE={world}")
    count, index = world // local, rank // local
    mesh = make_mesh(range(index * local, (index + 1) * local))
    cross = None
    if count > 1:
        for j in range(local):  # every local rank's group, on every rank
            g = dist.new_group([h * local + j for h in range(count)], timeout=TIMEOUT)
            if j == rank % local:
                cross = g
    return Hosts(count, index, mesh, cross)


def _render_span(
    scene: TriangleScene,
    spp: int,
    seed: int,
    config: RenderConfig,
    sample_start: int = 0,
    layout: Optional[Hosts] = None,
) -> np.ndarray:
    """Render one span of ``spp`` samples (global sample indices
    ``sample_start`` .. ``sample_start + spp - 1``) split across all hosts;
    returns the MEAN image over the span, the same on every rank.

    spp is split evenly across hosts, the remainder spread over the first
    ones; ``sample_start`` offsets the counter stream so host slices are
    disjoint and their union is the single-host sample set.  Each host's
    slice mean is weighted by its share of the span, and the cross-host
    merge is one [H*W, 3] ``all_gather`` and a sum in host order."""
    layout = layout or hosts()
    p, rank = layout.count, layout.index
    if p == 1:
        return render_sharded(scene, spp, seed, config, layout.mesh, sample_start=sample_start)

    base_spp, rem = divmod(spp, p)
    local_spp = base_spp + (1 if rank < rem else 0)
    local_start = sample_start + rank * base_spp + min(rank, rem)
    cam = scene.camera
    if local_spp > 0:
        local = render_sharded(
            scene, local_spp, seed, config, layout.mesh, sample_start=local_start,
        ).reshape(-1, 3)
        local = local * (local_spp / spp)  # slice mean -> weighted share
    else:  # more hosts than samples: this host contributes nothing
        local = np.zeros((cam.height * cam.width, 3), dtype=np.float32)

    parts = gather_in_rank_order(torch.from_numpy(local).to(scene.device), layout.cross_group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.cpu().numpy().reshape(cam.height, cam.width, 3)


def render_multihost(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: Optional[RenderConfig] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
) -> np.ndarray:
    """Multi-host render: each host renders a disjoint sample range on its
    local devices and the hosts' images are summed (see ``_render_span``).

    With ``checkpoint_path`` the render proceeds in merged passes of
    ``checkpoint_every`` samples (default ``config.spp_per_pass``) and saves
    a resumable accumulator after each.  Every rank holds the whole merged
    accumulator after each pass, so each saves and loads its own copy (no
    shared filesystem needed).  Rank 0's (samples_done, accum) is broadcast
    at resume, so ranks whose files disagree (a host restarted on a fresh
    disk, a stale or rejected file) resume together.  A killed-and-resumed
    render equals an uninterrupted one with the same ``checkpoint_every``
    bit for bit: the pass sums accumulate in the same order."""
    config = config or RenderConfig()
    layout = hosts()
    if checkpoint_path is None:
        return _render_span(scene, max(int(spp), 1), seed, config, layout=layout)

    cam = scene.camera
    h, w = cam.height, cam.width
    if scene.ray_depth == 0:
        return background(scene)
    spp = max(int(spp), 1)

    state = resume_or_start(
        checkpoint_path if resume else None, w, h, seed, scene_fingerprint(scene, config),
        "checkpoint {path} does not match this render (dims/seed/scene+config "
        "fingerprint); ignoring it and restarting from sample 0",
    )
    if dist.is_initialized():
        done = torch.tensor([state.samples_done], dtype=torch.int64, device=scene.device)
        accum = torch.from_numpy(state.accum).to(scene.device)
        dist.broadcast(done, src=0)
        dist.broadcast(accum, src=0)
        state.samples_done = int(done.item())
        state.accum = accum.cpu().numpy().astype(np.float32)

    pass_spp = checkpoint_every or config.spp_per_pass
    while state.samples_done < spp:
        todo = min(pass_spp, spp - state.samples_done)
        img = _render_span(scene, todo, seed, config, sample_start=state.samples_done,
                           layout=layout)
        state.accum += img.reshape(-1, 3) * todo
        state.samples_done += todo
        state.save(checkpoint_path)
    return state.image
