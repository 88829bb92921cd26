"""Checkpoint / resume for long renders (port of
``tpu_pathtracer/parallel/checkpoint.py``).

The counter-based per-(pixel, sample) draws make the whole render state the
HDR accumulator plus the number of samples already folded in: resuming
continues the sample counter from ``samples_done``, so a crash loses at most
one pass and a resumed render equals an uninterrupted one sample for sample.

The file is the JAX package's ``.npz`` (``accum``, ``samples_done``,
``width``, ``height``, ``seed``, ``fingerprint``), and ``scene_fingerprint``
gives the JAX package's integer for the same scene and config, so either
package resumes the other's checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import zlib
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.pathtracer import background, check_config, chunk_pass, frame_plan, record_rays
# ``benchmark/tests/test_bench_faults.py`` patches the persistent engine here
# as well as in ``models.pathtracer``, where ``chunk_pass`` calls it.
from ..models.pathtracer import render_chunk_persistent  # noqa: F401
from ..scene.accel import LEAF_SIZE, build_leaves, leaf_woop
from ..scene.types import TriangleScene
from ..utils.profiling import span

# Config fields that change HOW the render executes but not WHAT estimator
# it computes (the same samples, up to fp summation order).  They are left
# out of the fingerprint, so tuning them between runs keeps a
# checkpoint resumable.
_EXECUTION_KNOBS = (
    "rays_per_batch",
    "spp_per_pass",
    "failure_retries",
    "sort_key",
    "frame_pool",
    "compaction",
    "tuning",
)

# The JAX loader keeps the row-major Woop view only up to this many
# triangle slots (tpu_pathtracer/scene/gltf.py:583-589); past it the view
# is not a leaf of its scene, so it is not hashed.
WOOP_ROWS_MAX = 4_194_304


def _jax_scene_leaves(scene: TriangleScene) -> Iterator[np.ndarray]:
    """The leaves of the JAX package's scene pytree for this scene, in its
    flattening order (dataclass field order, static fields and None fields
    left out).  The port does not hold the leaf-traversal arrays nor the
    per-triangle material columns: they are rebuilt bit for bit, the leaves
    from the soup as the JAX loader builds them, the columns from the packed
    shading rows (the loader casts both from the same float64 rows)."""

    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v

    verts, valid, woop = host(scene.verts), host(scene.valid), host(scene.woop)
    leaf_min, leaf_max = build_leaves(verts, valid, LEAF_SIZE)
    attrs = host(scene.shade_attrs)
    tex_ids = attrs[:, 43:47].astype(np.int32)  # color, emissive, mr, normal
    atlas, lights, cam = scene.atlas, scene.lights, scene.camera
    leaves = (
        verts, scene.normals, scene.uvs, scene.tangents, valid, woop,
        leaf_min, leaf_max, leaf_woop(woop, LEAF_SIZE),
        scene.chunk_aabb_min, scene.chunk_aabb_max, scene.chunk_woop, attrs,
        attrs[:, 33:37], attrs[:, 37:40], attrs[:, 40], attrs[:, 41], attrs[:, 42],
        tex_ids[:, 0], tex_ids[:, 1], tex_ids[:, 2], tex_ids[:, 3],
        atlas.texels, atlas.offset, atlas.width, atlas.height, atlas.quad,
        lights.verts, lights.normal, lights.area, np.asarray(lights.count, dtype=np.int32),
        lights.cluster_min, lights.cluster_max, lights.cluster_woop, lights.cluster_k,
        scene.bg_color, np.asarray(scene.env_tex, dtype=np.int32),
        scene.woop_rows if scene.capacity <= WOOP_ROWS_MAX else None,
        cam.position, cam.right, cam.up, cam.forward, cam.fov_x,
    )
    for leaf in leaves:
        if leaf is not None:
            yield np.asarray(host(leaf))


def scene_fingerprint(scene: TriangleScene, config: RenderConfig) -> int:
    """crc32 of the estimator-relevant config and every scene array: the
    JAX package's ``scene_fingerprint`` of the same scene and config.

    Guards resume against blending a checkpoint of another scene or
    estimator into the accumulator.  ``_EXECUTION_KNOBS`` are set to their
    defaults first: they move fp summation order at most.  A
    ``fingerprint`` span of the log."""
    with span("fingerprint"):
        defaults = RenderConfig()
        normalized = dataclasses.replace(config, **{k: getattr(defaults, k)
                                                    for k in _EXECUTION_KNOBS})
        crc = zlib.crc32(repr(normalized).encode())
        for arr in _jax_scene_leaves(scene):
            crc = zlib.crc32(arr.tobytes(), crc)
            crc = zlib.crc32(str(arr.dtype).encode() + str(arr.shape).encode(), crc)
        return crc


@dataclasses.dataclass
class RenderState:
    """Resumable accumulation state: sum of per-sample radiance per pixel."""

    accum: np.ndarray  # [H*W, 3] float32, SUM over samples (not mean)
    samples_done: int
    width: int
    height: int
    seed: int
    fingerprint: int = 0  # scene + config hash (0 = unknown, legacy checkpoints)

    @property
    def image(self) -> np.ndarray:
        """Current mean-radiance HDR image."""
        n = max(self.samples_done, 1)
        return (self.accum / n).reshape(self.height, self.width, 3)

    def save(self, path: str) -> None:
        """Atomic write: a crash mid-save leaves the previous file whole.  A
        ``save`` span of the log."""
        with span("save"):
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=parent or ".", suffix=".npz.tmp")
            os.close(fd)
            try:
                with open(tmp, "wb") as f:
                    np.savez(
                        f,
                        accum=self.accum,
                        samples_done=self.samples_done,
                        width=self.width,
                        height=self.height,
                        seed=self.seed,
                        fingerprint=self.fingerprint,
                    )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

    @staticmethod
    def load(path: str) -> "RenderState":
        with np.load(path) as z:
            return RenderState(
                accum=z["accum"],
                samples_done=int(z["samples_done"]),
                width=int(z["width"]),
                height=int(z["height"]),
                seed=int(z["seed"]),
                fingerprint=int(z["fingerprint"]) if "fingerprint" in z else 0,
            )


def resume_or_start(path: Optional[str], width: int, height: int, seed: int,
                    fingerprint: int, rejected: str) -> RenderState:
    """The checkpoint at ``path`` when it matches the render (dims, seed, and
    a fingerprint equal to ``fingerprint`` or 0 for a legacy file), else a
    state at sample 0; a rejected file is reported on stderr as
    ``rejected`` (formatted with ``path``), never blended in silently."""
    if path and os.path.exists(path):
        cand = RenderState.load(path)
        if (cand.width, cand.height, cand.seed) == (width, height, seed) and (
            cand.fingerprint in (0, fingerprint)
        ):
            return cand
        print(rejected.format(path=path), file=sys.stderr)
    return RenderState(
        accum=np.zeros((width * height, 3), dtype=np.float32),
        samples_done=0,
        width=width,
        height=height,
        seed=seed,
        fingerprint=fingerprint,
    )


def render_with_checkpoints(
    scene: TriangleScene,
    spp: int,
    seed: int = 0,
    config: Optional[RenderConfig] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Like ``models.pathtracer.render``, but accumulates in resumable passes.

    Samples are rendered in passes of ``checkpoint_every`` (default
    ``config.spp_per_pass``); after each pass the accumulator is saved to
    ``checkpoint_path``.  If that file exists and matches the resolution,
    seed and fingerprint, rendering resumes from its ``samples_done``.
    Returns the final [H, W, 3] HDR image.  The chunks and passes are
    ``frame_plan``'s, as in ``render``, and with the persistent engine
    ``stats["measured_rays"]`` receives the rays traced (by the passes this
    call ran) and ``stats["loop"]`` the loop taken.  Each pass is a
    ``pass`` span of the log, holding a chunk's ``chunk_pass`` (its engine
    call, the call's counts read right after it, then its ``readback``
    span: the copy to the host and the accumulate) and the ``save``;
    ``progress`` is called after it."""
    config = config or RenderConfig()
    check_config(config)
    cam = scene.camera
    h, w = cam.height, cam.width
    npix = h * w
    if scene.ray_depth == 0:
        return background(scene)

    state = resume_or_start(
        checkpoint_path if resume else None, w, h, seed, scene_fingerprint(scene, config),
        "checkpoint {path}: scene/config fingerprint or dims/seed mismatch — ignoring it "
        "and restarting from sample 0",
    )
    plan = frame_plan(config, npix, checkpoint_every)
    measured = 0
    for s0, todo in plan.passes(state.samples_done, spp):
        with span("pass"):
            for start, n in plan.chunks():
                with chunk_pass(scene, config, plan, start, n, seed, s0, todo) as (rad, rays):
                    measured += rays
                    with span("readback"):
                        host = rad[:n].cpu().numpy()
                        # The engines return the mean over ``todo``; accumulate the sum.
                        state.accum[start:start + n] += host * todo
            state.samples_done += todo
            if checkpoint_path:
                state.save(checkpoint_path)
        if progress:
            progress(state.samples_done, spp)
    record_rays(stats, config, scene.device, measured)
    return state.image
