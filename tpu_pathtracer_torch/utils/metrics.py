"""Structured render metrics of the port (its own copy of
``tpu_pathtracer/utils/metrics.py``, same JSON keys)."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RenderMetrics:
    width: int
    height: int
    samples: int
    ray_depth: int
    load_seconds: float
    render_seconds: float
    # Rays traced (live lanes entering each bounce), counted by the
    # persistent engine; None under the scan engine.
    measured_rays: Optional[int] = None

    @property
    def pixel_samples(self) -> int:
        return self.width * self.height * self.samples

    @property
    def samples_per_second(self) -> float:
        return self.pixel_samples / max(self.render_seconds, 1e-9)

    @property
    def mrays_per_second(self) -> float:
        """Upper-bound ray rate: every sample taken as ``ray_depth`` rays.
        ``measured_mrays_per_second`` counts the rays actually traced."""
        return self.pixel_samples * self.ray_depth / max(self.render_seconds, 1e-9) / 1e6

    @property
    def measured_mrays_per_second(self) -> Optional[float]:
        if self.measured_rays is None:
            return None
        return self.measured_rays / max(self.render_seconds, 1e-9) / 1e6

    def to_json(self) -> str:
        out = {
            "width": self.width,
            "height": self.height,
            "samples": self.samples,
            "ray_depth": self.ray_depth,
            "load_seconds": round(self.load_seconds, 4),
            "render_seconds": round(self.render_seconds, 4),
            "samples_per_second": round(self.samples_per_second, 1),
            "mrays_per_second_depth_bound": round(self.mrays_per_second, 3),
        }
        if self.measured_rays is not None:
            out["measured_rays"] = self.measured_rays
            out["measured_mrays_per_second"] = round(self.measured_mrays_per_second, 3)
        return json.dumps(out)
