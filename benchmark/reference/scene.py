"""The reference's own reading of a scene: the glTF soup, its materials and
textures, its camera and lights, and the environment map, parsed from the
files the benchmark generated, in plain numpy.  Nothing here comes from the
program: the reference works every derived table out again (the Woop rows
of the dense sweep, the light list and its order, the texture pool).

The glTF subset is the one the benchmark's generators write: one primitive
per mesh, triangle lists, float32 POSITION / NORMAL / TEXCOORD_0, images by
file, nodes with TRS and children, one perspective camera.  Semantics follow
the reference renderer (src/scene.h): normals by the adjugate normal
transform, tangents (1, 0, 0) (its lowercase ``tangent`` quirk), glTF
texture i at pool slot 2 + i after the two builtin 1x1 textures, emission
times ``KHR_materials_emissive_strength``, metallic 1 and roughness 1 by
default, and lights the triangles whose emission factor is not zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess

import numpy as np
import torch

from .twins import TRI_BLOCK, TextureAtlas

TEX_WHITE = 0
TEX_NORMAL_UP = 1
_WHITE = np.array([[[1, 1, 1, 1]]], dtype=np.float32)
_NORMAL_UP = np.array([[[0.5, 0.5, 1, 0]]], dtype=np.float32)


@dataclasses.dataclass
class RefCamera:
    position: torch.Tensor  # [3] float32
    right: torch.Tensor
    up: torch.Tensor
    forward: torch.Tensor
    fov_x: torch.Tensor  # [] float32
    width: int
    height: int

    def to(self, device) -> "RefCamera":
        return dataclasses.replace(self, **{k: getattr(self, k).to(device) for k in
                                            ("position", "right", "up", "forward", "fov_x")})


@dataclasses.dataclass
class RefScene:
    woop: torch.Tensor  # [4, 3N] dense-sweep rows, N a multiple of TRI_BLOCK
    verts: torch.Tensor  # [N, 3, 3]
    normals: torch.Tensor  # [N, 3, 3]
    uvs: torch.Tensor  # [N, 3, 2]
    tangents: torch.Tensor  # [N, 3, 3]
    material: torch.Tensor  # [N, 14]: color4 emission3 metallic roughness ior tex4
    atlas: TextureAtlas
    slots: tuple  # (color, emissive, mr, normal): a material uses a real texture
    light_verts: torch.Tensor  # [L, 3, 3] in the scene's light order
    light_normal: torch.Tensor
    light_area: torch.Tensor
    n_lights: int
    env_tex: int  # TEX_WHITE when no environment map
    bg_color: torch.Tensor  # [3]
    camera: RefCamera
    ray_depth: int

    def to(self, device) -> "RefScene":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.to(device)
            elif isinstance(v, TextureAtlas):
                v = TextureAtlas(*(t.to(device) for t in v[:4]))
            elif isinstance(v, RefCamera):
                v = v.to(device)
            out[f.name] = v
        return RefScene(**out)


# --- images -------------------------------------------------------------------


def read_hdr_linear(path: str) -> np.ndarray:
    """A flat (non-RLE) Radiance HDR file -> linear float32 [H, W, 3], as
    stb_image converts RGBE: ``byte * 2^(E - 136)``."""
    with open(path, "rb") as f:
        data = f.read()
    head, sep, rest = data.partition(b"\n\n")
    if not sep or not head.startswith(b"#?RADIANCE"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    line, _, body = rest.partition(b"\n")
    m = re.match(rb"-Y (\d+) \+X (\d+)$", line)
    if not m:
        raise ValueError(f"{path}: unsupported resolution line {line!r}")
    h, w = int(m.group(1)), int(m.group(2))
    if len(body) != h * w * 4:
        raise ValueError(f"{path}: only flat (not run-length encoded) scanlines are read here")
    rgbe = np.frombuffer(body, dtype=np.uint8).reshape(h, w, 4)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2((e - 136).astype(np.float32)), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """[H, W, 4] float32: PNG bytes / 255; a Radiance HDR through stb_image's
    8-bit path (gamma 1/2.2, rounded, clamped to a byte), alpha 1."""
    with open(path, "rb") as f:
        magic = f.read(10)
    if magic.startswith(b"#?RADIANCE"):
        rgb = read_hdr_linear(path)
        z = np.power(np.maximum(rgb, 0.0), 1.0 / 2.2) * 255.0 + 0.5
        out = np.ones(rgb.shape[:2] + (4,), dtype=np.float32)
        out[..., :3] = np.clip(z, 0.0, 255.0).astype(np.uint8).astype(np.float32) / 255.0
        return out
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0


# --- geometry -----------------------------------------------------------------


def _trs(node: dict) -> np.ndarray:
    x, y, z, w = (float(v) for v in node.get("rotation", [0, 0, 0, 1]))
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag(np.asarray(node.get("scale", [1, 1, 1]), dtype=np.float64))
    m[:3, 3] = np.asarray(node.get("translation", [0, 0, 0]), dtype=np.float64)
    if "matrix" in node:
        m = np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T @ m
    return m


def _normal_matrix(m4: np.ndarray) -> np.ndarray:
    """The reference's inverse-transpose: the adjugate over the product of
    the squared row lengths."""
    a = m4[:3, :3]
    adj = np.array([[a[(r + 1) % 3, (c + 1) % 3] * a[(r + 2) % 3, (c + 2) % 3]
                     - a[(r + 1) % 3, (c + 2) % 3] * a[(r + 2) % 3, (c + 1) % 3]
                     for c in range(3)] for r in range(3)])
    return adj / float((a[0] @ a[0]) * (a[1] @ a[1]) * (a[2] @ a[2]))


def _accessor(root, buffers, idx, comps, dtype="<f4"):
    acc = root["accessors"][idx]
    view = root["bufferViews"][acc["bufferView"]]
    off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    out = np.frombuffer(buffers[view["buffer"]], dtype=dtype, count=acc["count"] * comps,
                        offset=off)
    return out.reshape(acc["count"], comps) if comps > 1 else out


_INDEX_TYPES = {5121: "<u1", 5123: "<u2", 5125: "<u4"}


def _material(root: dict, idx: int) -> np.ndarray:
    mat = root["materials"][idx]
    pbr = mat.get("pbrMetallicRoughness", {})
    emission = np.asarray(mat.get("emissiveFactor", [0, 0, 0]), dtype=np.float64)
    strength = mat.get("extensions", {}).get("KHR_materials_emissive_strength", {})
    if "emissiveStrength" in strength:
        emission = emission * float(strength["emissiveStrength"])

    def tex(entry, default):
        return 2 + entry["index"] if entry is not None else default

    return np.array([
        *pbr.get("baseColorFactor", [1, 1, 1, 1]), *emission,
        float(pbr.get("metallicFactor", 1.0)), float(pbr.get("roughnessFactor", 1.0)), 1.5,
        tex(pbr.get("baseColorTexture"), TEX_WHITE), tex(mat.get("emissiveTexture"), TEX_WHITE),
        tex(pbr.get("metallicRoughnessTexture"), TEX_WHITE),
        tex(mat.get("normalTexture"), TEX_NORMAL_UP),
    ], dtype=np.float64)


def _walk(root, buffers, node_idx, parent, out):
    node = root["nodes"][node_idx]
    m = parent @ _trs(node)
    if "camera" in node:
        out["camera"] = (m, root["cameras"][node["camera"]]["perspective"])
    if "mesh" in node:
        nm = _normal_matrix(m)
        for prim in root["meshes"][node["mesh"]]["primitives"]:
            if prim.get("mode", 4) != 4:
                raise ValueError("the reference reads triangle lists only")
            attrs = prim["attributes"]
            pos = _accessor(root, buffers, attrs["POSITION"], 3).astype(np.float64)
            if "indices" in prim:
                acc = root["accessors"][prim["indices"]]
                idx = _accessor(root, buffers, prim["indices"], 1,
                                _INDEX_TYPES[acc["componentType"]]).astype(np.int64)
            else:
                idx = np.arange(pos.shape[0])
            tri = idx[: idx.shape[0] - idx.shape[0] % 3].reshape(-1, 3)
            world = (np.concatenate([pos, np.ones((pos.shape[0], 1))], 1) @ m.T)[:, :3]
            v = world[tri].astype(np.float32)
            if "NORMAL" in attrs:
                wn = _accessor(root, buffers, attrs["NORMAL"], 3).astype(np.float64) @ nm.T
                wn /= np.linalg.norm(wn, axis=-1, keepdims=True)
                n = wn[tri].astype(np.float32)
            else:
                fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
                n = np.repeat(fn[:, None], 3, axis=1)
            uv = (_accessor(root, buffers, attrs["TEXCOORD_0"], 2)[tri].astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((tri.shape[0], 3, 2), np.float32))
            out["verts"].append(v)
            out["normals"].append(n)
            out["uvs"].append(uv)
            out["mats"].append(np.tile(_material(root, prim["material"]), (tri.shape[0], 1)))
    for child in node.get("children", []):
        _walk(root, buffers, child, m, out)


def woop_rows(verts: np.ndarray) -> np.ndarray:
    """[4, 3N] float32 rows of the dense sweep: per triangle the inverse of
    (b - a, c - a, n) with its translation, solved in float64; NaN rows for
    a degenerate triangle."""
    v = verts.astype(np.float64)
    a = v[:, 0]
    m = np.stack([v[:, 1] - a, v[:, 2] - a, np.cross(v[:, 1] - a, v[:, 2] - a)], axis=-1)
    det = np.linalg.det(m)
    ok = np.isfinite(det) & (np.abs(det) > 0)
    minv = np.linalg.inv(np.where(ok[:, None, None], m, np.eye(3)[None]))
    w = np.concatenate([minv, -np.einsum("nij,nj->ni", minv, a)[:, :, None]], axis=-1)
    w = np.where(ok[:, None, None], w, np.nan)
    return w.transpose(2, 0, 1).astype(np.float32).reshape(4, -1)


SAH_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sah_order.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "benchmark")
GXX_FLAGS = ["-O3", "-std=c++20", "-shared", "-fPIC"]


def _sah_library() -> ctypes.CDLL:
    """``sah_order.cpp`` built by g++ into ``build/benchmark/`` of the
    checkout, once per source and flags (a digest in the file name)."""
    with open(SAH_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libsah_order_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SAH_SOURCE], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.sah_chunk_order_f32.restype = None
    lib.sah_chunk_order_f32.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    return lib


def scene_order(verts: np.ndarray, chunk: int = 128) -> np.ndarray:
    """The scene's triangle order, which fixes the order of its lights and so
    the light a draw picks: chunk-aligned sweep-SAH treelets in DFS order
    (``sah_order.cpp``)."""
    v = np.ascontiguousarray(verts, dtype=np.float32)
    perm = np.empty(v.shape[0], dtype=np.int64)
    _sah_library().sah_chunk_order_f32(v, np.ones(v.shape[0], dtype=np.uint8), v.shape[0], chunk,
                                       perm)
    return perm


def look_at_camera(eye, target, fov_x: float, width: int, height: int,
                   up=(0.0, 1.0, 0.0)) -> RefCamera:
    """A camera at ``eye`` looking at ``target`` (the reference's right-handed
    basis: right = forward x up, true up = right x forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right /= np.linalg.norm(right)
    return _camera(eye, right, np.cross(right, fwd), fwd, fov_x, width, height)


def _camera(position, right, up, forward, fov_x, width, height) -> RefCamera:
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32).reshape(3).copy())
    return RefCamera(position=f32(position), right=f32(right), up=f32(up), forward=f32(forward),
                     fov_x=torch.tensor(float(fov_x), dtype=torch.float32),
                     width=int(width), height=int(height))


def load_scene(path: str, width: int, height: int, render: dict) -> RefScene:
    """The scene at ``path`` (.gltf) as the reference renders it at
    ``width`` x ``height`` under the configuration's ``render`` fields
    (``default_ray_depth``, ``use_env_map``, ``env_map_path``,
    ``env_map_intensity``, ``add_light_triangle`` and its intensity and
    relative position)."""
    with open(path) as f:
        root = json.load(f)
    base = os.path.dirname(path)
    buffers = []
    for b in root["buffers"]:
        with open(os.path.join(base, b["uri"]), "rb") as f:
            buffers.append(f.read()[: b["byteLength"]])
    images = [_WHITE, _NORMAL_UP] + [
        load_image(os.path.join(base, root["images"][t["source"]]["uri"]))
        for t in root.get("textures", [])]
    env_tex = TEX_WHITE
    if render.get("use_env_map", False):
        env_tex = len(images)
        images.append(load_image(render["env_map_path"]))

    out = dict(verts=[], normals=[], uvs=[], mats=[], camera=None)
    scene = root.get("scenes", [{}])[root.get("scene", 0)]
    for node_idx in scene.get("nodes", range(len(root["nodes"]))):
        _walk(root, buffers, node_idx, np.eye(4), out)

    aspect = width / height
    if out["camera"] is None:
        cam = _camera((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, -1), 1.5708, width, height)
    else:
        m, persp = out["camera"]
        axis = lambda v: (m @ np.asarray(v, dtype=np.float64))[:3] / np.linalg.norm(
            (m @ np.asarray(v, dtype=np.float64))[:3])
        fov_x = math.atan(math.tan(float(persp["yfov"]) / 2)
                          * float(persp.get("aspectRatio", aspect))) * 2
        cam = _camera((m @ np.array([0, 0, 0, 1.0]))[:3], axis([1, 0, 0, 0]), axis([0, 1, 0, 0]),
                      axis([0, 0, -1, 0]), fov_x, width, height)

    verts = np.concatenate(out["verts"])
    normals = np.concatenate(out["normals"])
    uvs = np.concatenate(out["uvs"])
    mats = np.concatenate(out["mats"])
    if render.get("add_light_triangle", False):
        # The camera-space light triangle, in float32 (src/scene.h:479-498).
        x, y, z, w = (t.numpy() for t in (cam.right, cam.up, cam.forward, cam.position))
        rel = np.asarray(render["light_triangle_relative_pos"], dtype=np.float32)
        lv = w[None] + rel[:, 0:1] * x + rel[:, 1:2] * y + rel[:, 2:3] * z
        fn = np.cross(lv[1] - lv[0], lv[2] - lv[0])
        fn = fn / np.linalg.norm(fn)
        verts = np.concatenate([verts, lv[None].astype(np.float32)])
        normals = np.concatenate([normals, np.tile(fn.astype(np.float32), (1, 3, 1))])
        uvs = np.concatenate([uvs, np.zeros((1, 3, 2), np.float32)])
        intensity = float(render["light_triangle_intensity"])
        mats = np.concatenate([mats, np.array([[1, 1, 1, 1, intensity, intensity, intensity,
                                                 1, 1, 1.5, TEX_WHITE, TEX_WHITE, TEX_WHITE,
                                                 TEX_NORMAL_UP]], dtype=np.float64)])

    order = scene_order(verts)
    verts, normals, uvs, mats = verts[order], normals[order], uvs[order], mats[order]
    n = verts.shape[0]
    cap = -(-n // TRI_BLOCK) * TRI_BLOCK
    woop = np.full((4, 3 * cap), np.nan, dtype=np.float32)
    woop[:, : 3 * n] = woop_rows(verts)

    emissive = np.any(mats[:, 4:7].astype(np.float32) != 0.0, axis=-1)
    lv = verts[emissive]
    lcross = np.cross(lv[:, 1] - lv[:, 0], lv[:, 2] - lv[:, 0])
    offsets = np.cumsum([0] + [im.shape[0] * im.shape[1] for im in images])[:-1]
    atlas = TextureAtlas(
        texels=torch.from_numpy(np.concatenate([im.reshape(-1, 4) for im in images])),
        offset=torch.tensor(offsets, dtype=torch.int32),
        width=torch.tensor([im.shape[1] for im in images], dtype=torch.int32),
        height=torch.tensor([im.shape[0] for im in images], dtype=torch.int32),
    )
    tex = mats[:, 10:14]
    return RefScene(
        woop=torch.from_numpy(woop),
        verts=torch.from_numpy(verts),
        normals=torch.from_numpy(normals),
        uvs=torch.from_numpy(uvs),
        tangents=torch.tensor([1.0, 0.0, 0.0]).expand(n, 3, 3).contiguous(),
        material=torch.from_numpy(mats.astype(np.float32)),
        atlas=atlas,
        slots=(bool((tex[:, 0] != TEX_WHITE).any()), bool((tex[:, 1] != TEX_WHITE).any()),
               bool((tex[:, 2] != TEX_WHITE).any()), bool((tex[:, 3] != TEX_NORMAL_UP).any())),
        light_verts=torch.from_numpy(lv),
        light_normal=torch.from_numpy(
            (lcross / np.linalg.norm(lcross, axis=-1, keepdims=True)).astype(np.float32)),
        light_area=torch.from_numpy((0.5 * np.linalg.norm(lcross, axis=-1)).astype(np.float32)),
        n_lights=int(lv.shape[0]),
        env_tex=env_tex,
        bg_color=torch.full((3,), float(render.get("env_map_intensity", 1.0))),
        camera=cam,
        ray_depth=int(render.get("default_ray_depth", 8)),
    )
