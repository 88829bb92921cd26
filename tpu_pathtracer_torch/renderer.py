"""High-level embedding API (port of ``tpu_pathtracer/renderer.py``).

A resident object: the scene is parsed once and its tensors moved to the
device once, then many frames render against them (different cameras,
sizes, sample counts).  A camera move swaps only the small ``Camera``: the
scene is not uploaded again and no kernel library is rebuilt.

    r = Renderer("scene.gltf")
    r.look_at(eye=(0, 1, 4), target=(0, 1, 0), fov_x=1.2)
    hdr = r.render(512, 512, spp=64)
    r.write("frame.ppm", hdr)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .cli import select_device
from .config import DEFAULT_CONFIG, RenderConfig
from .models.legacy import render_homebrew
from .models.pathtracer import render
from .scene.gltf import parse_gltf_scene
from .scene.homebrew import parse_homebrew_scene
from .scene.types import Camera, PrimitiveScene
from .utils.image import quantize_u8, write_ppm


class Renderer:
    def __init__(
        self,
        scene_path: str,
        config: RenderConfig = DEFAULT_CONFIG,
        aspect_ratio: float = 1.0,
        device: Optional[torch.device] = None,
    ) -> None:
        self.config = config
        self.device = select_device() if device is None else torch.device(device)
        if scene_path.endswith((".gltf", ".glb")):
            scene = parse_gltf_scene(scene_path, aspect_ratio, config)
        else:
            scene = parse_homebrew_scene(scene_path)
        self.scene = scene.to(self.device)

    # --- camera ------------------------------------------------------------

    @property
    def camera(self) -> Camera:
        return self.scene.camera

    def set_camera(self, camera: Camera) -> None:
        self.scene = dataclasses.replace(self.scene, camera=camera.to(self.device))

    def look_at(
        self,
        eye: Tuple[float, float, float],
        target: Tuple[float, float, float],
        up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
        fov_x: Optional[float] = None,
    ) -> None:
        """Place the camera (right-handed, the reference's basis)."""
        eye_v = np.asarray(eye, dtype=np.float64)
        fwd = np.asarray(target, dtype=np.float64) - eye_v
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, dtype=np.float64))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        cam = self.scene.camera
        self.set_camera(
            Camera.create(
                width=cam.width or 1,
                height=cam.height or 1,
                position=eye_v,
                right=right,
                up=true_up,
                forward=fwd,
                fov_x=fov_x if fov_x is not None else (float(cam.fov_x) or math.pi / 2),
            )
        )

    # --- rendering -----------------------------------------------------------

    def render(self, width: int, height: int, spp: int, seed: int = 0) -> np.ndarray:
        """Render an HDR [H, W, 3] float32 frame."""
        scene = dataclasses.replace(self.scene, camera=self.scene.camera.with_dims(width, height))
        if isinstance(scene, PrimitiveScene):
            if scene.monte_carlo and spp:
                scene = dataclasses.replace(scene, samples=spp)
            return render_homebrew(scene, seed=seed, config=self.config)
        return render(scene, spp=spp, seed=seed, config=self.config)

    def render_ldr(self, width: int, height: int, spp: int, seed: int = 0) -> np.ndarray:
        """Render straight to tone-mapped uint8 (the reference's pipeline)."""
        return quantize_u8(torch.from_numpy(self.render(width, height, spp, seed))).numpy()

    @staticmethod
    def write(path: str, image: np.ndarray) -> None:
        """Write a PPM (or PNG by extension) from HDR or uint8 pixels."""
        if image.dtype != np.uint8:
            image = quantize_u8(torch.from_numpy(np.ascontiguousarray(image))).numpy()
        if path.lower().endswith(".png"):
            from PIL import Image

            Image.fromarray(image).save(path)
        else:
            write_ppm(path, image)
