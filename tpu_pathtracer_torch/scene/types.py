"""Scene representation as frozen dataclasses of tensors (port of
``tpu_pathtracer/scene/types.py:48-333``).

Same arrays, same layouts, same padding conventions as the JAX package's
pytrees, so one set of numpy arrays feeds both (``bridge.py``).  The port
keeps only what its render path reads: the per-triangle material columns and
the Morton-leaf traversal arrays of the JAX scene are left out (materials
ride ``shade_attrs``; the chunk cascade replaces the leaf traversal).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Texture-id conventions for the shared atlas (slots 0/1 are built in).
TEX_WHITE = 0  # 1x1 {1,1,1,1}    — geometry::WHITE_TEXTURE (src/geometry.h:601)
TEX_NORMAL_UP = 1  # 1x1 {.5,.5,1,0} — geometry::NORMAL_UP  (src/geometry.h:602)


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field moved to device."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            kw[f.name] = v.to(device)
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera (src/scene.h:60-72)."""

    position: torch.Tensor  # [3] float32
    right: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    forward: torch.Tensor  # [3]
    fov_x: torch.Tensor  # [] float32
    width: int = 0
    height: int = 0

    @staticmethod
    def create(width, height, position, right, up, forward, fov_x) -> "Camera":
        a3 = lambda v: torch.from_numpy(np.asarray(v, dtype=np.float32).reshape(3).copy())
        return Camera(
            width=int(width),
            height=int(height),
            position=a3(position),
            right=a3(right),
            up=a3(up),
            forward=a3(forward),
            fov_x=torch.tensor(float(fov_x), dtype=torch.float32),
        )

    def with_dims(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, width=int(width), height=int(height))

    def to(self, device) -> "Camera":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """All decoded textures in one flat texel pool: texture k occupies
    ``texels[offset[k] : offset[k] + width[k]*height[k]]`` row-major.
    ``quad`` is the optional corner-quad pool (row i = the four bilinear
    corners of texel i), one 16-float row gather per (ray, texture)."""

    texels: torch.Tensor  # [T, 4] float32, linear
    offset: torch.Tensor  # [K] int32
    width: torch.Tensor  # [K] int32
    height: torch.Tensor  # [K] int32
    quad: Optional[torch.Tensor] = None  # [T, 16] float32

    def to(self, device) -> "TextureAtlas":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class LightSet:
    """Compacted emissive triangles for light-mixture sampling, plus the
    128-wide spatial clusters the all-hits pdf contracts against."""

    verts: torch.Tensor  # [L, 3, 3] float32
    normal: torch.Tensor  # [L, 3]
    area: torch.Tensor  # [L]
    count: int  # true number of lights; rows past it are masked
    cluster_min: Optional[torch.Tensor] = None  # [C, 3]
    cluster_max: Optional[torch.Tensor] = None  # [C, 3]
    cluster_woop: Optional[torch.Tensor] = None  # [C, 12, 128]
    cluster_k: Optional[torch.Tensor] = None  # [C, 128] = 1/(2 area^2), 0 pad

    @property
    def capacity(self) -> int:
        return self.verts.shape[0]

    @property
    def has_clusters(self) -> bool:
        return self.cluster_woop is not None

    def to(self, device) -> "LightSet":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class TriangleScene:
    """Flat triangle soup + packed per-triangle shading rows + camera."""

    verts: torch.Tensor  # [N, 3, 3] float32
    normals: torch.Tensor  # [N, 3, 3]
    uvs: torch.Tensor  # [N, 3, 2]
    tangents: torch.Tensor  # [N, 3, 3]
    valid: torch.Tensor  # [N] bool
    # World -> (beta, gamma, n) affine maps, [4, 3N] columns grouped
    # 3-per-triangle; NaN on degenerate/padding triangles.
    woop: torch.Tensor
    # Row-major [N, 12] view of woop (rows[t, 4j+k] = woop[k, 3t+j]) for the
    # winner-barycentric epilogue.
    woop_rows: torch.Tensor
    # 128-triangle chunks of the spatially ordered soup: AABBs (NaN = never
    # hit) and [C, 12, 128] Woop blocks (row = 4*component + coefficient).
    chunk_aabb_min: torch.Tensor  # [C, 3]
    chunk_aabb_max: torch.Tensor  # [C, 3]
    chunk_woop: torch.Tensor  # [C, 12, 128]
    # verts[9] normals[9] uvs[6] tangents[9] color[4] emission[3] metallic
    # roughness ior color_tex emissive_tex mr_tex normal_tex | pad -> 48.
    shade_attrs: torch.Tensor  # [N, 48]
    atlas: TextureAtlas
    lights: LightSet
    bg_color: torch.Tensor  # [3]
    env_tex: int  # atlas id (TEX_WHITE when no env map)
    camera: Camera
    ray_depth: int = 8
    samples: int = 1
    has_env: bool = False
    # Per-slot "some material uses a real texture" bits, order
    # (color, emissive, mr, normal): builtin-only slots skip the fetch.
    tex_slots: tuple = (True, True, True, True)

    @property
    def capacity(self) -> int:
        return self.verts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def to(self, device) -> "TriangleScene":
        return _to(self, device)


# --- Homebrew (scene-NNN.txt) world -------------------------------------

PRIM_PLANE = 0
PRIM_ELLIPSOID = 1
PRIM_BOX = 2
PRIM_TRIANGLE = 3

MAT_DIFFUSE = 0
MAT_METALLIC = 1
MAT_DIELECTRIC = 2


@dataclasses.dataclass(frozen=True)
class PrimitiveScene:
    """Analytic primitives of the homebrew format in local space: a
    primitive with rotation quaternion q and position p is intersected by
    taking the ray into its local frame (conjugate rotation)."""

    kind: torch.Tensor  # [P] int32 in {PRIM_*}
    param: torch.Tensor  # [P, 9]: plane normal / radii / half-sizes / 3 verts
    position: torch.Tensor  # [P, 3]
    rotation: torch.Tensor  # [P, 4] quaternion (x, y, z, w)
    color: torch.Tensor  # [P, 3]
    emission: torch.Tensor  # [P, 3]
    mat_kind: torch.Tensor  # [P] int32 in {MAT_*}
    ior: torch.Tensor  # [P]
    valid: torch.Tensor  # [P] bool

    # Whitted-mode lights
    ambient: torch.Tensor  # [3]
    dir_light_dir: torch.Tensor  # [Ld, 3] (normalized at parse)
    dir_light_intensity: torch.Tensor  # [Ld, 3]
    dir_light_valid: torch.Tensor  # [Ld] bool
    point_light_pos: torch.Tensor  # [Lp, 3]
    point_light_intensity: torch.Tensor  # [Lp, 3]
    point_light_atten: torch.Tensor  # [Lp, 3] (c0, c1, c2)
    point_light_valid: torch.Tensor  # [Lp] bool

    bg_color: torch.Tensor  # [3]

    camera: Camera = None
    ray_depth: int = 1
    samples: Optional[int] = None  # None => Whitted mode
    # True when the scene defines any light (ambient/directional/point).
    # Lightless non-MC scenes are stage-1 homework: flat primitive colors.
    lit: bool = True

    @property
    def capacity(self) -> int:
        return self.kind.shape[0]

    @property
    def monte_carlo(self) -> bool:
        """SAMPLES present => path-traced (practice5+); else Whitted (hw2/3)."""
        return self.samples is not None

    @property
    def device(self) -> torch.device:
        return self.kind.device

    def to(self, device) -> "PrimitiveScene":
        return _to(self, device)


def pad_to(n: int, multiple: int = 8, minimum: int = 8) -> int:
    """Round a count up to a padded capacity."""
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)
