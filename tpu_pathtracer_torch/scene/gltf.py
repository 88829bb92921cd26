"""glTF 2.0 (restricted subset) loader, jax-free (port of
``tpu_pathtracer/scene/gltf.py:46-641``).

The host pipeline is the JAX package's numpy code, kept operation for
operation so every array comes out bit-equal to ``parse_gltf_scene`` there
(pinned by tests/test_torch_scene.py); only the final hand-off builds torch
tensors instead of jax arrays.  The numpy helpers that live in jax-importing
modules of the JAX package (``tri_capacity``, ``build_woop``,
``build_chunk_woop``, the TRS/normal-transform helpers, ``light_clusters``
and ``quad_pool``) are copied here; the spatial builders come from the
jax-free ``tpu_pathtracer.scene.accel`` (native C++ packer first).

Environment maps and the extra camera-space light triangle are a later slice
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_pathtracer.config import DEFAULT_CONFIG, RenderConfig
from tpu_pathtracer.scene import native
from tpu_pathtracer.scene.accel import (
    LEAF_SIZE,
    build_leaves,
    chunk_aabbs,
    morton_order,
    sah_chunk_order,
)

from . import types as T

_COMPONENT_DTYPES = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32}

TRI_BLOCK = 1024  # dense-sweep triangle block (ops/intersect.py)
CHUNK_TRIS = 128  # triangles per intersector chunk


# --------------------------------------------------------------------------
# numpy helpers copied from jax-importing modules of the JAX package
# --------------------------------------------------------------------------


def tri_capacity(n: int) -> int:
    """Padded triangle capacity (ops/intersect.py:42-47)."""
    if n <= TRI_BLOCK:
        return max(128, ((n + 127) // 128) * 128)
    return ((n + TRI_BLOCK - 1) // TRI_BLOCK) * TRI_BLOCK


def build_woop(verts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[4, 3N] intersection matrix (ops/intersect.py:50-82): the native C++
    packer when it builds, else the float64 numpy solve.  Degenerate or
    padding triangles get NaN rows."""
    if not os.environ.get("TPU_PATHTRACER_NO_NATIVE"):
        out = native.build_woop(verts, valid)
        if out is not None:
            return out
    v = np.asarray(verts, dtype=np.float64)
    n = v.shape[0]
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    av = b - a
    au = c - a
    n0 = np.cross(av, au)
    m = np.stack([av, au, n0], axis=-1)
    det = np.linalg.det(m)
    ok = np.asarray(valid, dtype=bool) & np.isfinite(det) & (np.abs(det) > 0)
    m_safe = np.where(ok[:, None, None], m, np.eye(3)[None])
    minv = np.linalg.inv(m_safe)
    trans = -np.einsum("nij,nj->ni", minv, a)
    w = np.concatenate([minv, trans[:, :, None]], axis=-1)  # [N, 3, 4]
    w = np.where(ok[:, None, None], w, np.nan)
    return w.transpose(2, 0, 1).astype(np.float32, order="C").reshape(4, 3 * n)


def build_chunk_woop(woop_cols: np.ndarray, chunk_tris: int = CHUNK_TRIS) -> np.ndarray:
    """[4, 3N] -> [C, 12, chunk_tris] blocks, row = 4*comp + coef
    (ops/pallas_intersect.py:1929-1946)."""
    _, n3 = woop_cols.shape
    n = n3 // 3
    pad = (-n) % chunk_tris
    w = woop_cols.reshape(4, n, 3)
    if pad:
        w = np.concatenate([w, np.full((4, pad, 3), np.nan, w.dtype)], axis=1)
        n += pad
    c = n // chunk_tris
    w = w.reshape(4, c, chunk_tris, 3).transpose(1, 3, 0, 2)
    return w.astype(np.float32, order="C").reshape(c, 12, chunk_tris)


def np_quat_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation from quaternion (x, y, z, w) (ops/vecmath.py:134-144)."""
    x, y, z, w = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def np_trs_matrix(scale, quat_xyzw, translation) -> np.ndarray:
    """4x4 T*R*S compose (ops/vecmath.py:147-152)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = np_quat_rotation_matrix(quat_xyzw) @ np.diag(
        np.asarray(scale, dtype=np.float64)
    )
    m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def np_normal_transform(m4: np.ndarray) -> np.ndarray:
    """The reference's fast inverse-transpose for normals: adjugate over the
    product of squared row lengths (ops/vecmath.py:155-173)."""
    a = np.asarray(m4, dtype=np.float64)[:3, :3]
    d2 = float((a[0] @ a[0]) * (a[1] @ a[1]) * (a[2] @ a[2]))
    adj = np.empty((3, 3), dtype=np.float64)
    for r in range(3):
        for c in range(3):
            r1, r2 = (r + 1) % 3, (r + 2) % 3
            c1, c2 = (c + 1) % 3, (c + 2) % 3
            adj[r, c] = a[r1, c1] * a[r2, c2] - a[r1, c2] * a[r2, c1]
    return adj / d2


def quad_pool(images, quad_max: int = 0) -> Optional[np.ndarray]:
    """Corner-quad pool (scene/types.py:128-147); None past ``quad_max``
    texels."""
    total = sum(img.shape[0] * img.shape[1] for img in images)
    if total > quad_max:
        return None
    rows = []
    for img in images:
        img = np.asarray(img, dtype=np.float32)
        c01 = np.roll(img, -1, axis=0)
        c10 = np.roll(img, -1, axis=1)
        c11 = np.roll(c01, -1, axis=1)
        rows.append(np.concatenate([img, c01, c10, c11], axis=-1).reshape(-1, 16))
    return np.concatenate(rows, axis=0)


def light_clusters(lverts: np.ndarray, count: int, cluster: int = 128):
    """Spatially clustered 128-wide light blocks (scene/accel.py:231-294):
    (cl_min, cl_max, cl_woop, cl_k) float32, NaN boxes for empty clusters."""
    lverts = np.asarray(lverts, np.float64)
    cap = lverts.shape[0]
    valid = np.zeros(cap, bool)
    valid[:count] = True
    perm = sah_chunk_order(lverts, valid, cluster)
    lv = lverts[perm]
    ok = valid[perm]
    pad = (-cap) % cluster
    if pad:
        lv = np.concatenate([lv, np.full((pad, 3, 3), 1e30)], axis=0)
        ok = np.concatenate([ok, np.zeros(pad, bool)])
    c = lv.shape[0] // cluster
    v = lv.reshape(c, cluster, 3, 3)
    okc = ok.reshape(c, cluster)
    cl_min = np.where(okc[:, :, None, None], v, np.inf).min(axis=(1, 2))
    cl_max = np.where(okc[:, :, None, None], v, -np.inf).max(axis=(1, 2))
    empty = ~okc.any(axis=1)
    cl_min[empty] = np.nan
    cl_max[empty] = np.nan
    cl_woop = build_chunk_woop(build_woop(lv, ok), cluster)
    n0 = np.cross(lv[:, 1] - lv[:, 0], lv[:, 2] - lv[:, 0])
    area = 0.5 * np.linalg.norm(n0, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = 1.0 / (2.0 * area * area)
    k = np.where(ok & np.isfinite(k), k, 0.0)
    return (
        cl_min.astype(np.float32),
        cl_max.astype(np.float32),
        cl_woop,
        k.reshape(c, cluster).astype(np.float32),
    )


# --------------------------------------------------------------------------
# glTF parsing (scene/gltf.py of the JAX package)
# --------------------------------------------------------------------------


def _load_image_rgba(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 4] float32 in [0, 1]: Radiance HDR
    through the package's own codec, everything else through PIL (u8/255,
    like stb_image)."""
    with open(path, "rb") as f:
        magic = f.read(10)
    if magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE"):
        from tpu_pathtracer.utils.hdr import load_hdr_rgba_ldr

        return load_hdr_rgba_ldr(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0


def _decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode in-memory image bytes (GLB buffer-view images) to RGBA f32."""
    import io

    if data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE"):
        import tempfile

        from tpu_pathtracer.utils.hdr import load_hdr_rgba_ldr

        with tempfile.NamedTemporaryFile(suffix=".hdr") as tmp:
            tmp.write(data)
            tmp.flush()
            return load_hdr_rgba_ldr(tmp.name)
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0


def _read_glb(path: str):
    """Parse a .glb container -> (gltf json dict, BIN chunk or None)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError(f"{path}: not a GLB container")
    if version != 2:
        raise ValueError(f"{path}: unsupported GLB version {version}")
    pos = 12
    root = None
    bin_chunk = None
    while pos + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, pos)
        pos += 8
        chunk = data[pos:pos + clen]
        pos += clen
        if ctype == 0x4E4F534A:  # 'JSON'
            root = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
    if root is None:
        raise ValueError(f"{path}: GLB has no JSON chunk")
    return root, bin_chunk


class _AtlasBuilder:
    def __init__(self) -> None:
        self.images: List[np.ndarray] = [
            np.array([[[1, 1, 1, 1]]], dtype=np.float32),  # TEX_WHITE
            np.array([[[0.5, 0.5, 1, 0]]], dtype=np.float32),  # TEX_NORMAL_UP
        ]

    def add(self, img: np.ndarray) -> int:
        self.images.append(np.asarray(img, dtype=np.float32))
        return len(self.images) - 1

    def build(self, quad_max: int = 0) -> T.TextureAtlas:
        offsets, widths, heights, chunks = [], [], [], []
        off = 0
        for img in self.images:
            h, w, _ = img.shape
            offsets.append(off)
            widths.append(w)
            heights.append(h)
            chunks.append(img.reshape(-1, 4))
            off += w * h
        quad = quad_pool(self.images, quad_max)
        return T.TextureAtlas(
            texels=torch.from_numpy(np.concatenate(chunks, axis=0)),
            offset=torch.tensor(offsets, dtype=torch.int32),
            width=torch.tensor(widths, dtype=torch.int32),
            height=torch.tensor(heights, dtype=torch.int32),
            quad=None if quad is None else torch.from_numpy(quad),
        )


def _vec_accessor(root: dict, buffers: List[bytes], accessor_idx: int, comps: int) -> np.ndarray:
    """interpret_accessor<T> (src/scene.h:118-133): bufferView byteOffset
    only, tightly packed float32 (reference quirk kept)."""
    accessor = root["accessors"][accessor_idx]
    view = root["bufferViews"][accessor["bufferView"]]
    buf = buffers[view["buffer"]]
    count = accessor["count"]
    out = np.frombuffer(buf, dtype="<f4", count=count * comps,
                        offset=view.get("byteOffset", 0))
    return out.reshape(count, comps)


def _load_indices(root: dict, buffers: List[bytes], accessor_idx: Optional[int]) -> Optional[np.ndarray]:
    """load_indices (src/scene.h:138-181): honors accessor + view byteOffset."""
    if accessor_idx is None:
        return None
    accessor = root["accessors"][accessor_idx]
    view = root["bufferViews"][accessor["bufferView"]]
    buf = buffers[view["buffer"]]
    offset = view.get("byteOffset", 0) + accessor.get("byteOffset", 0)
    ctype = accessor["componentType"]
    if ctype not in _COMPONENT_DTYPES:
        raise RuntimeError("illegal scalar type")
    return np.frombuffer(
        buf, dtype=_COMPONENT_DTYPES[ctype], count=accessor["count"], offset=offset
    ).astype(np.int64)


class _SceneAccum:
    """Triangle-soup accumulator filled during the node walk."""

    def __init__(self) -> None:
        self.verts: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.mat_rows: List[np.ndarray] = []  # [n, 14] packed scalars
        self.camera: Optional[T.Camera] = None

    def n_tris(self) -> int:
        return sum(v.shape[0] for v in self.verts)


def _material_row(mat: Dict) -> np.ndarray:
    """[color4, emission3, metallic, roughness, ior, color_tex, emissive_tex,
    mr_tex, normal_tex] as float64."""
    return np.array(
        [*mat["color"], *mat["emission"], mat["metallic"], mat["roughness"],
         mat["ior"], mat["color_tex"], mat["emissive_tex"], mat["mr_tex"],
         mat["normal_tex"]],
        dtype=np.float64,
    )


def _parse_material(root: dict, material_idx: int, tex_base: int) -> Dict:
    """Material extraction (src/scene.h:260-316); glTF texture i -> atlas id
    tex_base + i."""
    material = root["materials"][material_idx]
    mat = dict(
        color=np.array([1, 1, 1, 1], dtype=np.float64),
        emission=np.zeros(3, dtype=np.float64),
        metallic=1.0,
        roughness=1.0,
        ior=1.5,
        color_tex=T.TEX_WHITE,
        emissive_tex=T.TEX_WHITE,
        mr_tex=T.TEX_WHITE,
        normal_tex=T.TEX_NORMAL_UP,
    )
    if "emissiveFactor" in material:
        mat["emission"] = np.asarray(material["emissiveFactor"], dtype=np.float64)
    strength = material.get("extensions", {}).get(
        "KHR_materials_emissive_strength", {}
    ).get("emissiveStrength")
    if strength is not None:
        mat["emission"] = mat["emission"] * float(strength)
    if "emissiveTexture" in material:
        mat["emissive_tex"] = tex_base + material["emissiveTexture"]["index"]
    pbr = material.get("pbrMetallicRoughness")
    if pbr is not None:
        if "baseColorFactor" in pbr:
            color = pbr["baseColorFactor"]
            if color[3] < 1:
                mat["ior"] = 1.5  # src/scene.h:285-287 (kept verbatim)
            mat["color"] = np.asarray(color, dtype=np.float64)
        if "baseColorTexture" in pbr:
            mat["color_tex"] = tex_base + pbr["baseColorTexture"]["index"]
        if "metallicRoughnessTexture" in pbr:
            mat["mr_tex"] = tex_base + pbr["metallicRoughnessTexture"]["index"]
        mat["roughness"] = float(pbr.get("roughnessFactor", 1.0))
        mat["metallic"] = float(pbr.get("metallicFactor", 1.0))
    if "normalTexture" in material:
        mat["normal_tex"] = tex_base + material["normalTexture"]["index"]
    return mat


def _handle_node(root, buffers, node_idx, parent, acc: _SceneAccum, default_ar, tex_base) -> None:
    """Recursive node walk with parent * matrix * T*R*S accumulation
    (src/scene.h:224-232)."""
    node = root["nodes"][node_idx]
    rotation = np.asarray(node.get("rotation", [0, 0, 0, 1]), dtype=np.float64)
    translation = np.asarray(node.get("translation", [0, 0, 0]), dtype=np.float64)
    scale = np.asarray(node.get("scale", [1, 1, 1]), dtype=np.float64)
    if "matrix" in node:
        m = np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T  # column-major
    else:
        m = np.eye(4)
    transform = parent @ m @ np_trs_matrix(scale, rotation, translation)
    normal_transform = np_normal_transform(transform)

    if "camera" in node:
        persp = root["cameras"][node["camera"]]["perspective"]
        fov_y = float(persp["yfov"])
        aspect = float(persp.get("aspectRatio", default_ar))

        def ax(v):
            d = (transform @ np.asarray(v, dtype=np.float64))[:3]
            return d / np.linalg.norm(d)

        acc.camera = T.Camera.create(
            width=0,
            height=0,
            position=(transform @ np.array([0, 0, 0, 1.0]))[:3],
            forward=ax([0, 0, -1, 0]),
            up=ax([0, 1, 0, 0]),
            right=ax([1, 0, 0, 0]),
            fov_x=math.atan(math.tan(fov_y / 2) * aspect) * 2,
        )

    if "mesh" in node:
        for primitive in root["meshes"][node["mesh"]]["primitives"]:
            mat = _parse_material(root, primitive["material"], tex_base)
            attrs = primitive["attributes"]
            coords = _vec_accessor(root, buffers, attrs["POSITION"], 3)
            normals = (
                _vec_accessor(root, buffers, attrs["NORMAL"], 3)
                if "NORMAL" in attrs else None
            )
            # Lowercase on purpose: real glTF says TANGENT, so tangents stay
            # (1,0,0) — reference quirk (src/scene.h:336,404-407).
            tangents = (
                _vec_accessor(root, buffers, attrs["tangent"], 3)
                if "tangent" in attrs else None
            )
            texcoords = (
                _vec_accessor(root, buffers, attrs["TEXCOORD_0"], 2)
                if "TEXCOORD_0" in attrs else None
            )
            indices = _load_indices(root, buffers, primitive.get("indices"))
            cnt = coords.shape[0] if indices is None else indices.shape[0]
            mode = primitive.get("mode", 4)
            if mode == 4:
                tri_idx = np.arange(cnt - cnt % 3).reshape(-1, 3)
            elif mode == 5:
                i = np.arange(2, cnt)
                off = i & 1
                tri_idx = np.stack([i - 2, i - 1 + off, i - off], axis=-1)
            else:
                continue  # silently skipped, like the reference switch
            if indices is not None:
                tri_idx = indices[tri_idx]
            if tri_idx.size == 0:
                continue

            pos_h = np.concatenate(
                [coords.astype(np.float64), np.ones((coords.shape[0], 1))], axis=1
            )
            world = (pos_h @ transform.T)[:, :3]
            v = world[tri_idx].astype(np.float32)  # [n, 3, 3]
            if normals is not None:
                wn = normals.astype(np.float64) @ normal_transform.T
                wn /= np.linalg.norm(wn, axis=-1, keepdims=True)
                n = wn[tri_idx].astype(np.float32)
            else:
                # Missing normals -> face normal on all 3 verts.
                fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
                n = np.repeat(fn[:, None, :], 3, axis=1)
            uv = (
                texcoords[tri_idx].astype(np.float32)
                if texcoords is not None
                else np.zeros((tri_idx.shape[0], 3, 2), dtype=np.float32)
            )
            tang = (
                tangents[tri_idx].astype(np.float32)
                if tangents is not None
                else np.tile(np.array([1, 0, 0], dtype=np.float32), (tri_idx.shape[0], 3, 1))
            )
            acc.verts.append(v)
            acc.normals.append(n)
            acc.uvs.append(uv)
            acc.tangents.append(tang)
            acc.mat_rows.append(np.tile(_material_row(mat), (tri_idx.shape[0], 1)))

    for child in node.get("children", []):
        _handle_node(root, buffers, child, transform, acc, default_ar, tex_base)


def parse_gltf_scene(
    path: str, aspect_ratio: float, config: RenderConfig = DEFAULT_CONFIG
) -> T.TriangleScene:
    """Load a .gltf/.glb file into a CPU-resident ``TriangleScene`` (move it
    with ``.to(device)``)."""
    if config.use_env_map:
        raise NotImplementedError(
            "environment maps are not ported yet (ROADMAP: next slices, "
            "env maps and the light triangle)"
        )
    if config.add_light_triangle:
        raise NotImplementedError(
            "add_light_triangle is not ported yet (ROADMAP: next slices, "
            "env maps and the light triangle)"
        )
    glb_bin = None
    if path.endswith(".glb"):
        root, glb_bin = _read_glb(path)
    else:
        with open(path, "r") as f:
            root = json.load(f)
    base = os.path.dirname(path)

    buffers: List[bytes] = []
    for buf_info in root.get("buffers", []):
        if "uri" not in buf_info:
            if glb_bin is None:
                raise ValueError(f"{path}: buffer without uri outside GLB")
            data = glb_bin
        else:
            with open(os.path.join(base, buf_info["uri"]), "rb") as f:
                data = f.read()
        buffers.append(data[: buf_info["byteLength"]])

    atlas = _AtlasBuilder()
    tex_base = len(atlas.images)
    for tex_info in root.get("textures", []):
        img_info = root["images"][tex_info["source"]]
        if "uri" in img_info:
            atlas.add(_load_image_rgba(os.path.join(base, img_info["uri"])))
        else:  # GLB: image stored in a bufferView
            view = root["bufferViews"][img_info["bufferView"]]
            off = view.get("byteOffset", 0)
            atlas.add(_decode_image_bytes(
                buffers[view["buffer"]][off:off + view["byteLength"]]
            ))

    scene_idx = root.get("scene", 0)
    scenes = root.get("scenes", [])
    acc = _SceneAccum()
    if scene_idx < len(scenes) and scenes[scene_idx] is not None:
        roots = scenes[scene_idx]["nodes"]
    else:
        roots = list(range(len(root.get("nodes", []))))
    for node_idx in roots:
        _handle_node(root, buffers, node_idx, np.eye(4), acc, aspect_ratio, tex_base)

    if acc.camera is None:
        acc.camera = T.Camera.create(
            width=0, height=0, position=(0, 0, 0), right=(1, 0, 0),
            up=(0, 1, 0), forward=(0, 0, -1), fov_x=1.5708,
        )
    return _pack_triangle_scene(acc, atlas, config)


def _pack_triangle_scene(
    acc: _SceneAccum, atlas: _AtlasBuilder, config: RenderConfig
) -> T.TriangleScene:
    n = acc.n_tris()
    cap = tri_capacity(n)

    def padded(chunks, shape_tail, dtype=np.float32) -> np.ndarray:
        out = np.zeros((cap, *shape_tail), dtype=dtype)
        if chunks:
            cat = np.concatenate(chunks, axis=0)
            out[: cat.shape[0]] = cat
        return out

    verts = padded(acc.verts, (3, 3))
    verts[n:] = 1e30  # degenerate far-away padding: never a valid hit
    normals = padded(acc.normals, (3, 3))
    normals[n:, :, 2] = 1.0
    uvs = padded(acc.uvs, (3, 2))
    tangents = padded(acc.tangents, (3, 3))
    tangents[n:, :, 0] = 1.0
    mats = padded(acc.mat_rows, (14,), np.float64)
    mats[n:, 13] = T.TEX_NORMAL_UP
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True

    tuning = config.tuning.resolve()
    chunk_tris = tuning.chunk_tris
    if tuning.build == "sah":
        perm = sah_chunk_order(verts, valid, chunk_tris)
    else:
        perm = morton_order(verts, valid)
    verts = verts[perm]
    normals = normals[perm]
    uvs = uvs[perm]
    tangents = tangents[perm]
    mats = mats[perm]
    valid = valid[perm]

    # Emissive predicate: the factor decides (src/raytracer.h:444-447).
    emission = mats[:, 4:7].astype(np.float32)
    light_rows = np.nonzero(valid & np.any(emission != 0.0, axis=-1))[0]
    lcap = T.pad_to(len(light_rows), minimum=1)
    lverts = np.full((lcap, 3, 3), 1e30, dtype=np.float32)
    lverts[: len(light_rows)] = verts[light_rows]
    lcross = np.cross(lverts[:, 1] - lverts[:, 0], lverts[:, 2] - lverts[:, 0])
    larea = 0.5 * np.linalg.norm(lcross, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        lnormal = lcross / np.linalg.norm(lcross, axis=-1, keepdims=True)
    lnormal = np.nan_to_num(lnormal, nan=0.0, posinf=0.0, neginf=0.0)
    cl_min, cl_max, cl_woop, cl_k = light_clusters(lverts, len(light_rows))
    lights = T.LightSet(
        verts=torch.from_numpy(lverts),
        normal=torch.from_numpy(lnormal.astype(np.float32)),
        area=torch.from_numpy(larea.astype(np.float32)),
        count=len(light_rows),
        cluster_min=torch.from_numpy(cl_min),
        cluster_max=torch.from_numpy(cl_max),
        cluster_woop=torch.from_numpy(cl_woop),
        cluster_k=torch.from_numpy(cl_k),
    )

    woop_cols = build_woop(verts, valid)
    lmin, lmax = build_leaves(verts, valid, LEAF_SIZE)
    cmin, cmax = chunk_aabbs(lmin, lmax, chunk_tris // LEAF_SIZE)
    cw = build_chunk_woop(woop_cols, chunk_tris)
    woop_rows = np.ascontiguousarray(
        woop_cols.reshape(4, cap, 3).transpose(1, 2, 0).reshape(cap, 12)
    )

    shade_attrs = np.zeros((cap, 48), dtype=np.float32)
    shade_attrs[:, 0:9] = verts.reshape(cap, 9)
    shade_attrs[:, 9:18] = normals.reshape(cap, 9)
    shade_attrs[:, 18:24] = uvs.reshape(cap, 6)
    shade_attrs[:, 24:33] = tangents.reshape(cap, 9)
    shade_attrs[:, 33:37] = mats[:, 0:4]  # color rgba
    shade_attrs[:, 37:40] = mats[:, 4:7]  # emission
    shade_attrs[:, 40] = mats[:, 7]  # metallic
    shade_attrs[:, 41] = mats[:, 8]  # roughness
    shade_attrs[:, 42] = mats[:, 9]  # ior
    shade_attrs[:, 43:47] = mats[:, 10:14]  # texture ids (exact in f32)

    return T.TriangleScene(
        verts=torch.from_numpy(verts),
        normals=torch.from_numpy(normals),
        uvs=torch.from_numpy(uvs),
        tangents=torch.from_numpy(tangents),
        valid=torch.from_numpy(valid),
        woop=torch.from_numpy(woop_cols),
        woop_rows=torch.from_numpy(woop_rows),
        chunk_aabb_min=torch.from_numpy(cmin),
        chunk_aabb_max=torch.from_numpy(cmax),
        chunk_woop=torch.from_numpy(cw),
        shade_attrs=torch.from_numpy(shade_attrs),
        atlas=atlas.build(quad_max=tuning.quad_max),
        lights=lights,
        bg_color=torch.full((3,), config.env_map_intensity, dtype=torch.float32),
        env_tex=T.TEX_WHITE,
        camera=acc.camera,
        ray_depth=config.default_ray_depth,
        samples=1,
        has_env=False,
        tex_slots=(
            bool((mats[:n, 10] != T.TEX_WHITE).any()),
            bool((mats[:n, 11] != T.TEX_WHITE).any()),
            bool((mats[:n, 12] != T.TEX_WHITE).any()),
            bool((mats[:n, 13] != T.TEX_NORMAL_UP).any()),
        ),
    )
