"""Parser for the course's homebrew ``scene-NNN.txt`` format (port of
``tpu_pathtracer/scene/homebrew.py``): numpy while parsing, torch tensors
(on the CPU) in the returned ``PrimitiveScene``.  Grammar (keyword-per-line,
whitespace separated):

  DIMENSIONS w h | RAY_DEPTH n | SAMPLES n | BG_COLOR r g b
  AMBIENT_LIGHT r g b
  NEW_LIGHT / LIGHT_DIRECTION xyz / LIGHT_POSITION xyz /
             LIGHT_ATTENUATION c0 c1 c2 / LIGHT_INTENSITY rgb
  CAMERA_POSITION / CAMERA_RIGHT / CAMERA_UP / CAMERA_FORWARD xyz
  CAMERA_FOV_X f
  NEW_PRIMITIVE followed by
    PLANE nx ny nz | ELLIPSOID rx ry rz | BOX sx sy sz | TRIANGLE 9 floats
    POSITION xyz | ROTATION x y z w | COLOR rgb | EMISSION rgb
    METALLIC | DIELECTRIC | IOR f

SAMPLES present selects Monte-Carlo mode (practice5+); otherwise the scene is
rendered with the deterministic Whitted-style integrator (hw2/3 semantics).
Unknown keywords are skipped with a warning, mirroring the tolerant spirit of
the reference's ``warn`` helper (src/scene.h:55-58).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from . import types as T


class _Prim:
    def __init__(self) -> None:
        self.kind: int = -1
        self.param = np.zeros(9, dtype=np.float32)
        self.position = np.zeros(3, dtype=np.float32)
        self.rotation = np.array([0, 0, 0, 1], dtype=np.float32)
        self.color = np.zeros(3, dtype=np.float32)
        self.emission = np.zeros(3, dtype=np.float32)
        self.mat_kind: int = T.MAT_DIFFUSE
        self.ior: float = 1.5


class _Light:
    def __init__(self) -> None:
        self.direction: Optional[np.ndarray] = None
        self.position: Optional[np.ndarray] = None
        self.attenuation = np.array([1, 0, 0], dtype=np.float32)
        self.intensity = np.ones(3, dtype=np.float32)


def parse_homebrew_scene(path: str) -> T.PrimitiveScene:
    with open(path, "r") as f:
        lines = f.read().splitlines()

    width, height = 640, 480
    ray_depth = 1
    samples: Optional[int] = None
    bg = np.zeros(3, dtype=np.float32)
    ambient = np.zeros(3, dtype=np.float32)
    cam = {
        "position": np.zeros(3, dtype=np.float32),
        "right": np.array([1, 0, 0], dtype=np.float32),
        "up": np.array([0, 1, 0], dtype=np.float32),
        "forward": np.array([0, 0, -1], dtype=np.float32),
        "fov_x": 1.5708,
    }
    prims: List[_Prim] = []
    lights: List[_Light] = []

    def fvec(tokens, n):
        return np.array([float(t) for t in tokens[:n]], dtype=np.float32)

    for raw in lines:
        tokens = raw.split()
        if not tokens:
            continue
        kw, args = tokens[0], tokens[1:]
        if kw == "DIMENSIONS":
            width, height = int(args[0]), int(args[1])
        elif kw == "RAY_DEPTH":
            ray_depth = int(args[0])
        elif kw == "SAMPLES":
            samples = int(args[0])
        elif kw == "BG_COLOR":
            bg = fvec(args, 3)
        elif kw == "AMBIENT_LIGHT":
            ambient = fvec(args, 3)
        elif kw == "CAMERA_POSITION":
            cam["position"] = fvec(args, 3)
        elif kw == "CAMERA_RIGHT":
            cam["right"] = fvec(args, 3)
        elif kw == "CAMERA_UP":
            cam["up"] = fvec(args, 3)
        elif kw == "CAMERA_FORWARD":
            cam["forward"] = fvec(args, 3)
        elif kw == "CAMERA_FOV_X":
            cam["fov_x"] = float(args[0])
        elif kw == "NEW_LIGHT":
            lights.append(_Light())
        elif kw == "LIGHT_DIRECTION":
            d = fvec(args, 3)
            lights[-1].direction = d / np.linalg.norm(d)
        elif kw == "LIGHT_POSITION":
            lights[-1].position = fvec(args, 3)
        elif kw == "LIGHT_ATTENUATION":
            lights[-1].attenuation = fvec(args, 3)
        elif kw == "LIGHT_INTENSITY":
            lights[-1].intensity = fvec(args, 3)
        elif kw == "NEW_PRIMITIVE":
            prims.append(_Prim())
        elif kw == "PLANE":
            prims[-1].kind = T.PRIM_PLANE
            n = fvec(args, 3)
            prims[-1].param[:3] = n / np.linalg.norm(n)
        elif kw == "ELLIPSOID":
            prims[-1].kind = T.PRIM_ELLIPSOID
            prims[-1].param[:3] = fvec(args, 3)
        elif kw == "BOX":
            prims[-1].kind = T.PRIM_BOX
            prims[-1].param[:3] = fvec(args, 3)
        elif kw == "TRIANGLE":
            prims[-1].kind = T.PRIM_TRIANGLE
            prims[-1].param[:9] = fvec(args, 9)
        elif kw == "POSITION":
            prims[-1].position = fvec(args, 3)
        elif kw == "ROTATION":
            prims[-1].rotation = fvec(args, 4)
        elif kw == "COLOR":
            prims[-1].color = fvec(args, 3)
        elif kw == "EMISSION":
            prims[-1].emission = fvec(args, 3)
        elif kw == "METALLIC":
            prims[-1].mat_kind = T.MAT_METALLIC
        elif kw == "DIELECTRIC":
            prims[-1].mat_kind = T.MAT_DIELECTRIC
        elif kw == "IOR":
            prims[-1].ior = float(args[0])
        else:
            print(f"WARN: unknown scene keyword {kw!r}", file=sys.stderr)

    camera = T.Camera.create(
        width=width,
        height=height,
        position=cam["position"],
        right=cam["right"],
        up=cam["up"],
        forward=cam["forward"],
        fov_x=cam["fov_x"],
    )

    prims = [p for p in prims if p.kind >= 0]
    cap = T.pad_to(len(prims))
    kind = np.zeros(cap, dtype=np.int32)
    param = np.zeros((cap, 9), dtype=np.float32)
    position = np.zeros((cap, 3), dtype=np.float32)
    rotation = np.tile(np.array([0, 0, 0, 1], dtype=np.float32), (cap, 1))
    color = np.zeros((cap, 3), dtype=np.float32)
    emission = np.zeros((cap, 3), dtype=np.float32)
    mat_kind = np.zeros(cap, dtype=np.int32)
    ior = np.full(cap, 1.5, dtype=np.float32)
    valid = np.zeros(cap, dtype=bool)
    for i, p in enumerate(prims):
        kind[i] = p.kind
        param[i] = p.param
        position[i] = p.position
        rotation[i] = p.rotation
        color[i] = p.color
        emission[i] = p.emission
        mat_kind[i] = p.mat_kind
        ior[i] = p.ior
        valid[i] = True

    dir_lights = [l for l in lights if l.direction is not None]
    point_lights = [l for l in lights if l.position is not None]
    dcap = T.pad_to(len(dir_lights), minimum=1)
    pcap = T.pad_to(len(point_lights), minimum=1)
    dl_dir = np.tile(np.array([0, 1, 0], dtype=np.float32), (dcap, 1))
    dl_int = np.zeros((dcap, 3), dtype=np.float32)
    dl_valid = np.zeros(dcap, dtype=bool)
    for i, l in enumerate(dir_lights):
        dl_dir[i], dl_int[i], dl_valid[i] = l.direction, l.intensity, True
    pl_pos = np.zeros((pcap, 3), dtype=np.float32)
    pl_int = np.zeros((pcap, 3), dtype=np.float32)
    pl_att = np.tile(np.array([1, 0, 0], dtype=np.float32), (pcap, 1))
    pl_valid = np.zeros(pcap, dtype=bool)
    for i, l in enumerate(point_lights):
        pl_pos[i], pl_int[i], pl_att[i], pl_valid[i] = (
            l.position,
            l.intensity,
            l.attenuation,
            True,
        )

    t = torch.from_numpy
    return T.PrimitiveScene(
        kind=t(kind),
        param=t(param),
        position=t(position),
        rotation=t(rotation),
        color=t(color),
        emission=t(emission),
        mat_kind=t(mat_kind),
        ior=t(ior),
        valid=t(valid),
        ambient=t(ambient),
        dir_light_dir=t(dl_dir),
        dir_light_intensity=t(dl_int),
        dir_light_valid=t(dl_valid),
        point_light_pos=t(pl_pos),
        point_light_intensity=t(pl_int),
        point_light_atten=t(pl_att),
        point_light_valid=t(pl_valid),
        bg_color=t(bg),
        camera=camera,
        ray_depth=ray_depth,
        samples=samples,
        lit=bool(lights) or bool(np.any(ambient != 0)),
    )
