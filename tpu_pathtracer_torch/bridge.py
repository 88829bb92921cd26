"""Carry a scene across from the JAX package as plain numpy arrays.

``scene_from_arrays`` builds the port's ``TriangleScene`` from the leaves of
the JAX package's scene pytree, keyed by dotted field path (``"verts"``,
``"atlas.texels"``, ``"lights.cluster_woop"``, ``"camera.position"``, ...),
so both packages can be fed bit-identical inputs.  It imports no jax: the
caller flattens the JAX scene to numpy.  Keys the port does not hold (the
JAX scene's leaf-traversal arrays and per-triangle material columns) are
ignored.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .scene.types import Camera, LightSet, TextureAtlas, TriangleScene


def scene_from_arrays(
    d: Mapping[str, np.ndarray], statics: Mapping, device="cpu"
) -> TriangleScene:
    """``d``: dotted field path -> numpy array; ``statics``: the JAX scene's
    static fields (``width``, ``height``, ``ray_depth``, ``samples``,
    ``has_env``, ``tex_slots``)."""

    def t(key: str) -> torch.Tensor:
        return torch.from_numpy(np.array(d[key])).to(device)

    def opt(key: str):
        return t(key) if d.get(key) is not None else None

    camera = Camera(
        position=t("camera.position"),
        right=t("camera.right"),
        up=t("camera.up"),
        forward=t("camera.forward"),
        fov_x=t("camera.fov_x"),
        width=int(statics["width"]),
        height=int(statics["height"]),
    )
    atlas = TextureAtlas(
        texels=t("atlas.texels"),
        offset=t("atlas.offset"),
        width=t("atlas.width"),
        height=t("atlas.height"),
        quad=opt("atlas.quad"),
    )
    lights = LightSet(
        verts=t("lights.verts"),
        normal=t("lights.normal"),
        area=t("lights.area"),
        count=int(np.asarray(d["lights.count"])),
        cluster_min=opt("lights.cluster_min"),
        cluster_max=opt("lights.cluster_max"),
        cluster_woop=opt("lights.cluster_woop"),
        cluster_k=opt("lights.cluster_k"),
    )
    return TriangleScene(
        verts=t("verts"),
        normals=t("normals"),
        uvs=t("uvs"),
        tangents=t("tangents"),
        valid=t("valid"),
        woop=t("woop"),
        woop_rows=t("woop_rows"),
        chunk_aabb_min=t("chunk_aabb_min"),
        chunk_aabb_max=t("chunk_aabb_max"),
        chunk_woop=t("chunk_woop"),
        shade_attrs=t("shade_attrs"),
        atlas=atlas,
        lights=lights,
        bg_color=t("bg_color"),
        env_tex=int(np.asarray(d["env_tex"])),
        camera=camera,
        ray_depth=int(statics["ray_depth"]),
        samples=int(statics["samples"]),
        has_env=bool(statics["has_env"]),
        tex_slots=tuple(bool(x) for x in statics["tex_slots"]),
    )

