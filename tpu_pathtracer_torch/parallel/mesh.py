"""Multi-device rendering over a ("rays", "spp") mesh of processes (port of
``tpu_pathtracer/parallel/mesh.py``).

One process per device, as ``torchrun`` launches them.  The JAX package's
contract, without its ``shard_map`` form:

* axis "rays": the pixels of a pass split into equal slices, one per rank;
* axis "spp": the samples split into contiguous ranges of
  ``ceil(spp / S)``, indices past ``spp`` masked;
* the scene is replicated: every rank holds all of it.

Per-(pixel, sample) counter draws make the merged image the single-device
render's for any mesh shape.  ``render_pass_rank`` is one rank's work as a
plain function of its mesh position, so every rank of a mesh can also run in
one process; ``render_pass_sharded`` adds the collectives.  The "spp" merge
is an ``all_gather`` and a sum in rank order (never an ``all_reduce``, whose
summation order the backend chooses), so the bits do not depend on the
backend.
"""

from __future__ import annotations

import dataclasses
import sys
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.graph import CaptureError
from ..models.pathtracer import (
    background,
    check_config,
    persistent_accum,
    pick_chunk,
    record_rays,
    scan_accum,
)
from ..scene.types import TriangleScene

# Collectives that wait longer than this fail instead of hanging: ranks of
# a mesh do equal shares of a pass, so they reach each merge close together.
TIMEOUT = timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a ("rays", "spp") mesh of ranks, laid out
    row-major over (rays, spp).  ``spp_group`` joins the ranks that share
    this rank's ray index (the sample merge), ``rays_group`` those that
    share its spp index (the pixel gather).  Both are None when no process
    group is initialised: the mesh is then this process alone."""

    shape: dict  # {"rays": R, "spp": S}
    ray_idx: int
    spp_idx: int
    spp_group: Optional[dist.ProcessGroup] = None
    rays_group: Optional[dist.ProcessGroup] = None


def make_mesh(ranks: Optional[Sequence[int]] = None, rays: Optional[int] = None,
              spp: int = 1) -> Mesh:
    """A (rays x spp) mesh over ``ranks`` (default: every rank of the world;
    all of them on the "rays" axis unless ``spp`` says otherwise).

    ``ranks`` must be a contiguous block of the world whose size divides it:
    the world is tiled by blocks of that size (a ``torchrun`` node's local
    ranks are one), and every rank creates the axis groups of every block,
    in the same order, because ``torch.distributed.new_group`` must be
    called by all ranks.  So every rank of the world calls ``make_mesh``
    with its own block.  Without a process group the world is this process
    and no group is made."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = tuple(range(world)) if ranks is None else tuple(int(r) for r in ranks)
    n = len(ranks)
    if rays is None:
        rays = n // spp
    if n == 0 or rays * spp != n:
        raise ValueError(f"mesh {rays}x{spp} != {n} ranks")
    first = ranks[0]
    if ranks != tuple(range(first, first + n)) or first % n or world % n:
        raise ValueError(f"ranks {ranks} are not a contiguous block of a world of {world} "
                         "tiled by blocks of their size")
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh {ranks}")
    ray_idx, spp_idx = divmod(rank - first, spp)
    spp_group = rays_group = None
    if dist.is_initialized():
        for base in range(0, world, n):  # every block's groups, on every rank
            for r in range(rays):
                g = dist.new_group([base + r * spp + s for s in range(spp)], timeout=TIMEOUT)
                if base == first and r == ray_idx:
                    spp_group = g
            for s in range(spp):
                g = dist.new_group([base + r * spp + s for r in range(rays)], timeout=TIMEOUT)
                if base == first and s == spp_idx:
                    rays_group = g
    return Mesh({"rays": rays, "spp": spp}, ray_idx, spp_idx, spp_group, rays_group)


def render_pass_rank(
    scene: TriangleScene,
    chunk_start: int,  # first linear pixel id of the pass
    seed: int,
    sample_start: int,  # first global sample index of the pass
    n_rays_global: int,  # pixels of the pass, over all "rays" ranks
    spp: int,
    config: RenderConfig,
    shape: dict,  # {"rays": R, "spp": S}
    ray_idx: int,
    spp_idx: int,
):
    """One rank's share of a sharded pass: the pixel slice ``ray_idx`` of
    ``n_rays_global / R`` pixels, the sample range ``spp_idx`` of
    ``ceil(spp / S)`` samples (indices >= ``spp`` masked).  Returns
    ([n_local, 3] radiance SUM over this rank's samples, [] int64 rays
    traced).  Pixels past the frame (a padded tail) are neither traced nor
    counted by the persistent engine; the scan engine traces them and
    counts nothing, as in the JAX package."""
    n_rays_mesh, n_spp_mesh = shape["rays"], shape["spp"]
    if n_rays_global % n_rays_mesh:
        raise ValueError(f"{n_rays_global} pixels do not split over {n_rays_mesh} ranks")
    n_local = n_rays_global // n_rays_mesh
    spp_local = -(-spp // n_spp_mesh)
    rank_start = chunk_start + ray_idx * n_local
    dev = scene.device
    my_count = min(max(spp - spp_idx * spp_local, 0), spp_local)
    if config.compaction:
        npix = scene.camera.width * scene.camera.height
        pc_rank = min(max(npix - rank_start, 0), n_local)
        # The pool floors at one pixel so a fully padded rank's ``% pool``
        # stays defined; its pool is empty, so nothing spawns.
        acc, counts = persistent_accum(
            scene, rank_start, seed, sample_start + spp_idx * spp_local, n_local,
            pc_rank * my_count, config, pix_count=max(pc_rank, 1),
        )
        return acc, counts[0]
    acc = scan_accum(scene, rank_start, seed, sample_start + spp_idx * spp_local, n_local,
                     my_count, config)
    return acc, torch.zeros((), dtype=torch.int64, device=dev)


def merge_spp(row: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """The "spp" merge of one ray slice: ``row`` holds each spp rank's
    (radiance sum, rays) in spp index order; the sums are added in that
    order."""
    acc, rays = row[0]
    for a, r in row[1:]:
        acc = acc + a
        rays = rays + r
    return acc, rays


def join_rays(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], spp: int):
    """The "rays" join: each ray slice's merged (radiance sum, rays) in ray
    index order -> ([R * n_local, 3] mean radiance over ``spp``, [R] int64
    rays per ray slice)."""
    rad = torch.cat([a for a, _ in parts]) / spp
    return rad, torch.stack([r.reshape(()) for _, r in parts])


def gather_in_rank_order(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> List[torch.Tensor]:
    """``t`` of every rank of ``group``, in group rank order (= global rank
    order: groups sort their ranks)."""
    if group is None:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def render_pass_sharded(
    scene: TriangleScene,
    chunk_start: int,
    seed: int,
    sample_start: int,
    n_rays_global: int,
    spp: int,
    config: RenderConfig,
    mesh: Mesh,
):
    """One sharded pass: this rank's share, then the "spp" merge and the
    "rays" gather.  Returns ([n_rays_global, 3] mean radiance over ``spp``,
    [R] int64 rays traced per ray slice), the same on every rank.

    A share whose execution raises is recomputed, up to
    ``config.failure_retries`` times (the counter draws make it a pure
    function of its inputs).  The collectives are not retried: a rank that
    repeated one would pair with its peers' next pass."""
    for attempt in range(config.failure_retries + 1):
        try:
            acc, rays = render_pass_rank(
                scene, chunk_start, seed, sample_start, n_rays_global, spp, config,
                mesh.shape, mesh.ray_idx, mesh.spp_idx,
            )
            break
        except CaptureError:  # a fault of the engine's body: no retry hides it
            raise
        except Exception as err:  # a failed execution of this rank's share
            if attempt == config.failure_retries:
                raise
            print(f"sharded pass {chunk_start}: execution failed ({err}), retrying "
                  f"({attempt + 1}/{config.failure_retries})", file=sys.stderr)
    rays = rays.reshape(1)
    row = list(zip(gather_in_rank_order(acc, mesh.spp_group),
                   gather_in_rank_order(rays, mesh.spp_group)))
    acc, rays = merge_spp(row)
    parts = list(zip(gather_in_rank_order(acc, mesh.rays_group),
                     gather_in_rank_order(rays, mesh.rays_group)))
    return join_rays(parts, spp)


def render_sharded(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: Optional[RenderConfig] = None,
    mesh: Optional[Mesh] = None,
    sample_start: int = 0,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Full-frame render over ``mesh`` (default ``make_mesh()``) -> host
    numpy [H, W, 3] float32 HDR, the same on every rank of the mesh.

    Renders exactly ``spp`` samples, sample indices ``sample_start`` to
    ``sample_start + spp - 1`` of the seed's counter stream (the offset
    keeps the slices of several hosts disjoint).  With the persistent
    engine ``stats["measured_rays"]`` receives the mesh's rays traced,
    summed in int64 on the host."""
    config = config or RenderConfig()
    check_config(config)
    mesh = mesh or make_mesh()
    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return background(scene)
    spp = max(int(spp), 1)
    n_rays_mesh = mesh.shape["rays"]
    # The per-rank lane count rounds up to the ray tile like the single
    # render's; pixel ids past the frame are not rendered (persistent) or
    # dropped (scan).
    per_dev = pick_chunk(config, -(-npix // n_rays_mesh))
    chunk = per_dev * n_rays_mesh
    out = np.zeros((npix, 3), dtype=np.float32)
    measured = 0
    for start in range(0, npix, chunk):
        n = min(chunk, npix - start)
        rad, rays = render_pass_sharded(scene, start, seed, sample_start, chunk, spp, config, mesh)
        out[start:start + n] = rad[:n].cpu().numpy()
        measured += int(rays.cpu().numpy().astype(np.int64).sum())
    record_rays(stats, config, scene.device, measured)
    return out.reshape(h, w, 3)
