"""Runtime render configuration of the port (its own copy of
``tpu_pathtracer/config.py``).

The reference renderer keeps its knobs as compile-time flags
(``src/config.h:7-47``); here, as in the JAX package, the same knobs (same
names, snake_cased, same defaults) live in frozen dataclasses.  Field names,
defaults and the ``TPU_PT_*`` environment overrides are identical to the
JAX package's, so a configuration means the same to both packages
(``tests/test_torch_host.py`` holds them equal).  Knobs that only the TPU
path reads (``max_cap``, ``light_items``, ``packed_permute``) are kept for
that equality and ignored by the port; ``narrow_tile_chunks`` is read, as in
the JAX package, by ``models/pathtracer.scene_closest_hit`` (256-ray tiles
past that many chunks).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


# Environment override per IntersectTuning field; the environment wins over
# the config value when set.  One table, so the overrides cannot drift from
# the dataclass.
_TUNING_ENV = {
    "mode": "TPU_PT_INTERSECT",
    "sub_rows": "TPU_PT_SUB",
    "super_min": "TPU_PT_SUPER_MIN",
    "super_tbound_min": "TPU_PT_SUPER_TBOUND_MIN",
    "pass1_min": "TPU_PT_PASS1_MIN",
    "near": "TPU_PT_NEAR",
    "max_cap": "TPU_PT_MAX_CAP",
    "cheap_recheck": "TPU_PT_CHEAP_RECHECK",
    "gate_recheck": "TPU_PT_GATE_RECHECK",
    "bins_cap": "TPU_PT_BINS_CAP",
    "light_items": "TPU_PT_LIGHT_ITEMS",
    "narrow_tile_chunks": "TPU_PT_NARROW_TILE_CHUNKS",
    "chunk_tris": "TPU_PT_CHUNK_TRIS",
    "build": "TPU_PT_BUILD",
    "quad_max": "TPU_PT_QUAD_MAX",
    "packed_permute": "TPU_PT_PACKED_PERMUTE",
}


@dataclasses.dataclass(frozen=True)
class IntersectTuning:
    """Knobs of the intersector and the scene build.  Every knob is
    exactness-neutral: each mode and schedule gives the closest hit; only
    speed moves."""

    # Intersect mode: "items" (the work-item cascade, the default),
    # "twopass" (the slot-grid cascade), "dense" (every active pair) or
    # "bins" (per-ray binned groups).
    mode: str = "items"
    # Rays per sub-tile of the activity bits (a power-of-two divisor of the
    # ray tile).
    sub_rows: int = 64
    # Column blocks above which the super-block gate engages.
    super_min: int = 3
    # Column blocks at or above which cascade rechecks recompute the coarse
    # gate bounded by each ray's best t (0 = never).
    super_tbound_min: int = 16
    # Minimum near-pass-1 worklist cap (ladder base = max(this, cg // 9)).
    pass1_min: int = 4
    # Near-pass ladder multipliers (x base/4 each), comma-separated.
    near: str = "2,6"
    # Worklist cap override of the TPU's scalar-memory budget (0 = derive).
    max_cap: int = 0
    # Cascade recheck form: 0 full slab re-run, 1 cheap stored-entry
    # comparison, 2 hybrid (cheap between near passes, full pre-residual).
    cheap_recheck: int = 0
    # Gate cascade rechecks by live-block bits (1 = on).
    gate_recheck: int = 1
    # Bins mode: binned pair-row capacity in multiples of R.
    bins_cap: int = 12
    # Max prefetched worklist items per light-pdf window of the TPU kernel.
    light_items: int = 48_000
    # Chunk count past which the intersector uses 256-ray tiles (a TPU
    # measurement).  On an H100 80GB HBM3 the two tile sizes render a
    # 1000x1000 16-spp pass within 1% of each other on the atrium at 1,704
    # and at 9,624 chunks, so the card has no switch point of its own there.
    narrow_tile_chunks: int = 4096
    # --- scene-build knobs (read at parse time by scene/gltf.py) ---
    # Triangles per intersector chunk.
    chunk_tris: int = 128
    # Spatial build: "sah" chunk-aligned sweep-SAH treelets (default) or
    # "morton" (the Morton curve).
    build: str = "sah"
    # Corner-quad texture pool texel cap (past it the flat pool is used).
    quad_max: int = 32 * 1024 * 1024
    # Per-bounce carry permutation form of the TPU path.
    packed_permute: int = 1

    def resolve(self) -> "IntersectTuning":
        """Apply the ``TPU_PT_*`` environment overrides on top of the config
        values (each parsed by the type of the field's default)."""
        over = {}
        for field, env in _TUNING_ENV.items():
            raw = os.environ.get(env)
            if raw is None:
                continue
            kind = type(getattr(self, field))
            over[field] = kind(raw)
        return dataclasses.replace(self, **over) if over else self


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The reference's compile-time flag block (``src/config.h``) plus the
    wavefront's execution knobs."""

    # Numerical epsilon of intersection validity windows and pdf guards
    # (src/config.h:15).
    eps: float = 1e-4

    # Path depth when the scene does not specify one (src/config.h:17).
    default_ray_depth: int = 8

    # Roughness clamp: anything below is treated as this (src/config.h:20).
    min_roughness: float = 0.04

    # MIS weight of the VNDF strategy; the cosine/light mixture gets
    # (1 - vndf_factor) (src/config.h:26).
    vndf_factor: float = 1.0 / 3.0

    # When False only 1x1 textures are honored (src/config.h:29).
    use_textures: bool = True

    # Environment map trio (src/config.h:36-38).  The CLI sets the
    # background color to (env_map_intensity,)*3, as src/main.cpp:28-31.
    env_map_intensity: float = 1.0
    use_env_map: bool = False
    env_map_path: str = "env.hdr"

    # Extra camera-space light triangle (src/config.h:41-47).
    add_light_triangle: bool = False
    light_triangle_intensity: float = 10.0
    light_triangle_relative_pos: Tuple[Tuple[float, float, float], ...] = (
        (10.0, 0.0, -0.1),
        (0.0, 10.0, -0.1),
        (0.0, -10.0, -0.1),
    )

    # Rays per wavefront batch.
    rays_per_batch: int = 1 << 16

    # Samples per pixel accumulated per pass.
    spp_per_pass: int = 16

    # Failed chunk executions are recomputed up to this many times (the
    # counter-based RNG makes every chunk a pure function of its inputs).
    failure_retries: int = 2

    # Wavefront coherence sort key: "hint" (direction octant x the chunk id
    # of the spawn surface), "cell" (octant x 16^3 Morton origin cell),
    # "target" (the worklist group each ray first enters x octant),
    # "dirhint" (fine direction bins over the spawn chunk) or "none"
    # (compaction order only).  Sorting does not change the estimator.
    sort_key: str = "hint"

    # Frame pool: each persistent pass's work pool covers the whole frame.
    frame_pool: bool = False

    # Wavefront engine: True = persistent wavefront with path regeneration;
    # False = fixed scan over ray_depth bounces.  Same estimator.
    compaction: bool = True

    # Camera-jitter sampler: "uniform" (the reference estimator) or "sobol"
    # (Owen-scrambled (0,2)-sequence jitter).
    jitter: str = "uniform"

    # Low-discrepancy bounce draws: "off" (the reference's draws) or
    # "sobol" (the VNDF and light-point pairs from Owen-scrambled
    # sequences).
    lowdisc: str = "off"

    # Intersector and scene-build knobs (see IntersectTuning).
    tuning: IntersectTuning = IntersectTuning()


DEFAULT_CONFIG = RenderConfig()
