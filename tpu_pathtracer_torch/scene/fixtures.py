"""Procedural glTF fixtures the port is tested, run and measured on.

The port's own copies of the generators of
``tpu_pathtracer/utils/testscenes.py`` that it uses (``make_atrium_gltf``,
``make_cornell_gltf``, ``make_env_hdr``, ``make_env_image``,
``make_sphere_field_gltf``, ``make_textured_cornell_gltf``, with the glTF
writer and mesh helpers they need), writing byte-identical files (``tests/test_torch_host.py``), plus
``make_lit_banner_atrium_gltf``, the atrium made a many-light scene.  Each
writes a self-contained glTF (JSON + .bin, plus PNG textures where asked).
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional

import numpy as np


class GltfBuilder:
    """Minimal glTF 2.0 writer: materials, meshes (one primitive each),
    nodes (instances and groups), textures by image file and one
    perspective camera."""

    def __init__(self) -> None:
        self.materials: List[dict] = []
        self.meshes: List[dict] = []
        self.nodes: List[dict] = []
        self.bin = bytearray()
        self.buffer_views: List[dict] = []
        self.accessors: List[dict] = []
        self.cameras: List[dict] = []
        self.images: List[str] = []
        self.textures: List[dict] = []
        self._children: set = set()  # nodes parented by add_group

    def add_texture(self, image_uri: str) -> int:
        """Register an image file (relative to the .gltf) as a texture."""
        self.images.append(image_uri)
        self.textures.append({"source": len(self.images) - 1})
        return len(self.textures) - 1

    def add_material(
        self,
        base_color=(1, 1, 1, 1),
        metallic: float = 0.0,
        roughness: float = 1.0,
        emissive=None,
        emissive_strength: Optional[float] = None,
        base_color_texture: Optional[int] = None,
        metallic_roughness_texture: Optional[int] = None,
        emissive_texture: Optional[int] = None,
        normal_texture: Optional[int] = None,
    ) -> int:
        pbr: dict = {
            "baseColorFactor": list(base_color),
            "metallicFactor": metallic,
            "roughnessFactor": roughness,
        }
        if base_color_texture is not None:
            pbr["baseColorTexture"] = {"index": base_color_texture}
        if metallic_roughness_texture is not None:
            pbr["metallicRoughnessTexture"] = {"index": metallic_roughness_texture}
        mat: dict = {"pbrMetallicRoughness": pbr}
        if emissive is not None:
            mat["emissiveFactor"] = list(emissive)
        if emissive_texture is not None:
            mat["emissiveTexture"] = {"index": emissive_texture}
        if normal_texture is not None:
            mat["normalTexture"] = {"index": normal_texture}
        if emissive_strength is not None:
            mat["extensions"] = {
                "KHR_materials_emissive_strength": {
                    "emissiveStrength": emissive_strength
                }
            }
        self.materials.append(mat)
        return len(self.materials) - 1

    def _push_view(self, data: bytes) -> int:
        off = len(self.bin)
        self.bin.extend(data)
        while len(self.bin) % 4:
            self.bin.append(0)
        self.buffer_views.append(
            {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        )
        return len(self.buffer_views) - 1

    def _accessor(self, view: int, count: int, ctype: int, atype: str) -> int:
        self.accessors.append(
            {"bufferView": view, "count": count, "componentType": ctype, "type": atype}
        )
        return len(self.accessors) - 1

    def add_mesh(
        self,
        positions: np.ndarray,  # [V, 3] float32
        indices: Optional[np.ndarray],  # [I] int
        material: int,
        normals: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
        node_transform: Optional[dict] = None,
        index_dtype: Optional[str] = None,  # force "u8" | "u16" | "u32"
        #   (all three are legal glTF componentTypes regardless of vertex
        #   count; the reference switches on them at src/scene.h:163-180)
        mode: Optional[int] = None,  # primitive mode (4 tris, 5 strip)
    ) -> int:
        positions = np.asarray(positions, dtype="<f4")
        pos_acc = self._accessor(
            self._push_view(positions.tobytes()), positions.shape[0], 5126, "VEC3"
        )
        prim: dict = {"attributes": {"POSITION": pos_acc}, "material": material}
        if normals is not None:
            normals = np.asarray(normals, dtype="<f4")
            prim["attributes"]["NORMAL"] = self._accessor(
                self._push_view(normals.tobytes()), normals.shape[0], 5126, "VEC3"
            )
        if uvs is not None:
            uvs = np.asarray(uvs, dtype="<f4")
            prim["attributes"]["TEXCOORD_0"] = self._accessor(
                self._push_view(uvs.tobytes()), uvs.shape[0], 5126, "VEC2"
            )
        if indices is not None:
            idx = np.asarray(indices)
            if index_dtype is None:
                index_dtype = "u2" if idx.max(initial=0) < 65536 else "u4"
            dt = {"u8": "<u1", "u16": "<u2", "u32": "<u4",
                  "u1": "<u1", "u2": "<u2", "u4": "<u4"}[index_dtype]
            ctype = {"<u1": 5121, "<u2": 5123, "<u4": 5125}[dt]
            prim["indices"] = self._accessor(
                self._push_view(idx.astype(dt).tobytes()), idx.shape[0],
                ctype, "SCALAR",
            )
        if mode is not None:
            prim["mode"] = mode
        self.meshes.append({"primitives": [prim]})
        return self.add_node(len(self.meshes) - 1, node_transform)

    def add_node(
        self, mesh: int, node_transform: Optional[dict] = None
    ) -> int:
        """Instance an existing mesh under a (possibly different) transform —
        the node-reuse shape real exporters emit (handle_node walks every
        node referencing the mesh, src/scene.h:256-258)."""
        node = {"mesh": mesh}
        if node_transform:
            node.update(node_transform)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def add_group(
        self, children: List[int], node_transform: Optional[dict] = None
    ) -> int:
        """Parent the given nodes under a new (possibly transformed) group
        node; grouped nodes leave the scene's root list, so their transforms
        accumulate through the parent exactly as the reference's recursive
        handle_node composes them (src/scene.h:224-230, 461-465)."""
        node: dict = {"children": list(children)}
        if node_transform:
            node.update(node_transform)
        self.nodes.append(node)
        self._children.update(children)
        return len(self.nodes) - 1

    def mesh_of(self, node: int) -> int:
        """Mesh index referenced by a node created with add_mesh."""
        return self.nodes[node]["mesh"]

    def add_camera(self, position, yfov: float, node_transform: Optional[dict] = None) -> int:
        self.cameras.append({"perspective": {"yfov": yfov}, "type": "perspective"})
        node = {"camera": len(self.cameras) - 1, "translation": list(position)}
        if node_transform:
            node.update(node_transform)
        self.nodes.append(node)
        return len(self.nodes) - 1

    def write(self, path: str) -> str:
        base = os.path.splitext(os.path.basename(path))[0]
        bin_name = base + ".bin"
        root = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": [i for i in range(len(self.nodes))
                                  if i not in self._children]}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "materials": self.materials,
            "buffers": [{"uri": bin_name, "byteLength": len(self.bin)}],
            "bufferViews": self.buffer_views,
            "accessors": self.accessors,
        }
        if self.cameras:
            root["cameras"] = self.cameras
        if self.textures:
            root["textures"] = self.textures
            root["images"] = [{"uri": uri} for uri in self.images]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(root, f)
        with open(os.path.join(os.path.dirname(path), bin_name), "wb") as f:
            f.write(bytes(self.bin))
        return path


def quad(p0, p1, p2, p3) -> (np.ndarray, np.ndarray):
    pos = np.array([p0, p1, p2, p3], dtype=np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], dtype=np.int64)
    return pos, idx


def make_cornell_gltf(path: str, light_strength: float = 20.0) -> str:
    """Classic Cornell box: white floor/ceiling/back, red left, green right,
    one emissive ceiling quad, two diffuse boxes."""
    b = GltfBuilder()
    white = b.add_material((0.73, 0.73, 0.73, 1))
    red = b.add_material((0.65, 0.05, 0.05, 1))
    green = b.add_material((0.12, 0.45, 0.15, 1))
    light = b.add_material(
        (0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=light_strength
    )

    # Box interior: x in [-1, 1], y in [0, 2], z in [-1, 1]; open front (+z).
    b.add_mesh(*quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)), material=white)
    b.add_mesh(*quad((-1, 2, -1), (-1, 2, 1), (1, 2, 1), (1, 2, -1)), material=white)
    b.add_mesh(*quad((-1, 0, -1), (-1, 2, -1), (1, 2, -1), (1, 0, -1)), material=white)
    b.add_mesh(*quad((-1, 0, -1), (-1, 0, 1), (-1, 2, 1), (-1, 2, -1)), material=red)
    b.add_mesh(*quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1)), material=green)
    b.add_mesh(
        *quad(
            (-0.4, 1.998, -0.4),
            (0.4, 1.998, -0.4),
            (0.4, 1.998, 0.4),
            (-0.4, 1.998, 0.4),
        ),
        material=light,
    )

    def box_mesh(cx, cz, sx, sy, sz, angle):
        c, s = math.cos(angle), math.sin(angle)
        verts = []
        for dx in (-1, 1):
            for dy in (0, 1):
                for dz in (-1, 1):
                    x, y, z = dx * sx, dy * sy, dz * sz
                    verts.append((cx + c * x + s * z, y, cz - s * x + c * z))
        v = np.array(verts, dtype=np.float32)
        # vertex order: (dx,dy,dz) lexicographic -> index dx*4 + dy*2 + dz
        faces = [
            (0, 1, 3, 2),  # -x
            (4, 6, 7, 5),  # +x
            (0, 4, 5, 1),  # -z
            (2, 3, 7, 6),  # +z
            (0, 2, 6, 4),  # y=0
            (1, 5, 7, 3),  # y=top
        ]
        idx = []
        for f in faces:
            idx += [f[0], f[1], f[2], f[0], f[2], f[3]]
        return v, np.array(idx, dtype=np.int64)

    b.add_mesh(*box_mesh(-0.35, -0.35, 0.3, 1.2, 0.3, 0.3), material=white)
    b.add_mesh(*box_mesh(0.4, 0.35, 0.3, 0.6, 0.3, -0.25), material=white)

    b.add_camera((0, 1.0, 3.8), yfov=0.62)
    return b.write(path)


def make_env_image(path: str) -> str:
    """Deterministic equirect 'sky' image (horizontal hue bands + vertical
    brightness gradient) for environment-map parity tests."""
    from PIL import Image

    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w]
    r = (255 * (0.2 + 0.8 * xx / (w - 1))).astype(np.uint8)
    g = (255 * (1.0 - yy / (h - 1))).astype(np.uint8)
    b = (255 * (0.3 + 0.7 * yy / (h - 1))).astype(np.uint8)
    img = np.stack([r, g, b], axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)
    return path


def make_env_hdr(path: str) -> str:
    """Deterministic Radiance HDR sky with true >1 dynamic range (a bright
    'sun' disk at 8x plus banded gradients) — exercises the .hdr codec and
    stb_image's HDR->LDR clamp the reference observes (``utils/hdr.py``)."""
    from ..utils.hdr import write_hdr

    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.1 + 0.6 * xx / (w - 1)
    g = 0.8 * (1.0 - yy / (h - 1))
    b = 0.2 + 0.5 * yy / (h - 1)
    rgb = np.stack([r, g, b], axis=-1)
    sun = ((xx - 16) ** 2 + (yy - 8) ** 2) < 16
    rgb[sun] = (8.0, 7.0, 5.0)  # clamps to white through the u8 bottleneck
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_hdr(path, rgb)


def make_textured_cornell_gltf(path: str, light_strength: float = 20.0) -> str:
    """Cornell variant with a checkerboard baseColor texture on the floor and
    a gradient metallic-roughness texture on the back wall — exercises the
    texture atlas, bilinear fetch, per-texel gamma decode and the glTF B=metal
    / G=rough channel convention (src/geometry.h:623-626)."""
    from PIL import Image

    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    checker = np.zeros((8, 8, 3), dtype=np.uint8)
    checker[(np.indices((8, 8)).sum(axis=0) % 2) == 0] = (230, 200, 120)
    checker[(np.indices((8, 8)).sum(axis=0) % 2) == 1] = (40, 60, 160)
    Image.fromarray(checker).save(os.path.join(d, "checker.png"))
    mr = np.zeros((8, 8, 3), dtype=np.uint8)
    mr[..., 1] = np.linspace(30, 220, 8, dtype=np.uint8)[None, :]  # roughness G
    mr[..., 2] = np.linspace(220, 30, 8, dtype=np.uint8)[:, None]  # metallic B
    Image.fromarray(mr).save(os.path.join(d, "mr.png"))

    b = GltfBuilder()
    checker_tex = b.add_texture("checker.png")
    mr_tex = b.add_texture("mr.png")
    white = b.add_material((0.73, 0.73, 0.73, 1))
    floor_mat = b.add_material((1, 1, 1, 1), base_color_texture=checker_tex)
    back_mat = b.add_material(
        (0.7, 0.7, 0.7, 1),
        metallic=1.0,
        roughness=1.0,
        metallic_roughness_texture=mr_tex,
    )
    light = b.add_material(
        (0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=light_strength
    )

    uv_quad = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], dtype=np.float32)
    pos, idx = quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1))
    b.add_mesh(pos, idx, material=floor_mat, uvs=uv_quad)
    pos, idx = quad((-1, 2, -1), (-1, 2, 1), (1, 2, 1), (1, 2, -1))
    b.add_mesh(pos, idx, material=white)
    pos, idx = quad((-1, 0, -1), (-1, 2, -1), (1, 2, -1), (1, 0, -1))
    b.add_mesh(pos, idx, material=back_mat, uvs=uv_quad / 2)
    pos, idx = quad((-1, 0, -1), (-1, 0, 1), (-1, 2, 1), (-1, 2, -1))
    b.add_mesh(pos, idx, material=white)
    pos, idx = quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1))
    b.add_mesh(pos, idx, material=white)
    pos, idx = quad(
        (-0.4, 1.998, -0.4), (0.4, 1.998, -0.4), (0.4, 1.998, 0.4), (-0.4, 1.998, 0.4)
    )
    b.add_mesh(pos, idx, material=light)
    b.add_camera((0, 1.0, 3.8), yfov=0.62)
    return b.write(path)


def make_sphere_field_gltf(
    path: str,
    n_spheres: int = 64,
    subdiv: int = 3,
    seed: int = 0,
    light_strength: float = 30.0,
    textured: bool = False,
) -> str:
    """Sponza-class synthetic benchmark scene: a floor, an emissive ceiling
    panel and a field of icosphere meshes with mixed materials.  Triangle
    count scales as n_spheres * 20 * 4^subdiv (64 spheres @ subdiv 3 ->
    ~82k tris; 160 @ 4 -> ~820k).  ``textured=True`` adds baseColor / MR /
    normal textures with real UVs (equirect on spheres, tiled on the floor)
    so the bilinear-fetch path carries bench load like the real Sponza."""
    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tex_kw = [{} for _ in range(4)]
    floor_kw = {}
    if textured:
        # Sponza-class workloads are heavily textured (README.md:4-5, fetches
        # at src/bvh.h:107-120): give the bench real bilinear traffic —
        # 4 distinct 64x64 baseColor maps, one MR map, one normal map.
        from PIL import Image

        yy, xx = np.mgrid[0:64, 0:64]
        for k in range(4):
            img = np.stack(
                [
                    ((xx * (k + 2) // 8 + yy // 8) % 2 * 160 + 60),
                    (yy * (k + 1) * 3 % 256),
                    (xx * (5 - k) * 2 % 256),
                ],
                axis=-1,
            ).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"bc{k}.png"))
            tex_kw[k]["base_color_texture"] = b.add_texture(f"bc{k}.png")
        mr = np.zeros((64, 64, 3), dtype=np.uint8)
        mr[..., 1] = (yy * 4 % 256).astype(np.uint8)  # roughness G
        mr[..., 2] = (xx * 4 % 256).astype(np.uint8)  # metallic B
        Image.fromarray(mr).save(os.path.join(d, "mr.png"))
        mr_tex = b.add_texture("mr.png")
        for k in range(4):
            tex_kw[k]["metallic_roughness_texture"] = mr_tex
        nrm = np.full((32, 32, 3), 128, dtype=np.uint8)
        nrm[..., 2] = 255
        nrm[::4, :, 0] = 180  # mild bump stripes
        Image.fromarray(nrm).save(os.path.join(d, "nrm.png"))
        floor_kw["base_color_texture"] = tex_kw[0]["base_color_texture"]
        floor_kw["normal_texture"] = b.add_texture("nrm.png")

    floor = b.add_material((0.6, 0.6, 0.6, 1), **floor_kw)
    light = b.add_material((0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=light_strength)

    ext = 14.0
    fq = quad((-ext, 0, -ext), (ext, 0, -ext), (ext, 0, ext), (-ext, 0, ext))
    floor_uvs = (
        np.array([[0, 0], [8, 0], [8, 8], [0, 8]], dtype=np.float32)
        if textured else None
    )
    b.add_mesh(*fq, material=floor, uvs=floor_uvs)
    b.add_mesh(
        *quad((-4, 11.5, -4), (4, 11.5, -4), (4, 11.5, 4), (-4, 11.5, 4)),
        material=light,
    )

    verts, faces = _icosphere(subdiv)
    sphere_uvs = None
    if textured:
        # Equirect UVs from the unit sphere directions.
        u = (np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi) + 0.5)
        v = np.arccos(np.clip(verts[:, 1], -1, 1)) / np.pi
        sphere_uvs = np.stack([u, v], axis=-1).astype(np.float32)
    for i in range(n_spheres):
        col = rng.uniform(0.2, 0.95, size=3)
        metallic = float(rng.random() < 0.35)
        rough = float(rng.uniform(0.05, 0.9))
        mat = b.add_material(
            (*col, 1.0), metallic=metallic, roughness=rough,
            **(tex_kw[i % 4] if textured else {}),
        )
        radius = float(rng.uniform(0.35, 0.9))
        pos = np.array(
            [rng.uniform(-10, 10), radius + rng.uniform(0, 2.5), rng.uniform(-10, 10)]
        )
        v = verts * radius + pos
        b.add_mesh(v.astype(np.float32), faces.reshape(-1), material=mat,
                   normals=verts.astype(np.float32), uvs=sphere_uvs)
    b.add_camera((0, 3.2, 13.0), yfov=0.8)
    return b.write(path)


def _grid_mesh(origin, du, dv, nu, nv, uv_scale=1.0, displace=None):
    """Subdivided quad patch: origin + u*du + v*dv, u in [0,1]^2 grid.

    Returns (positions [(nu+1)(nv+1), 3] f32, indices, normals, uvs).
    ``displace(u, v)`` optionally offsets each vertex (drape waves)."""
    origin = np.asarray(origin, np.float64)
    du = np.asarray(du, np.float64)
    dv = np.asarray(dv, np.float64)
    uu, vv = np.meshgrid(
        np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1), indexing="ij"
    )
    pos = origin[None, None] + uu[..., None] * du + vv[..., None] * dv
    if displace is not None:
        pos = pos + displace(uu, vv)
    pos = pos.reshape(-1, 3)
    n = np.cross(du, dv)
    n /= max(np.linalg.norm(n), 1e-20)
    normals = np.broadcast_to(n, pos.shape).copy()
    uvs = np.stack([uu * uv_scale, vv * uv_scale], axis=-1).reshape(-1, 2)
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            idx += [a, b, b + 1, a, b + 1, a + 1]
    return (
        pos.astype(np.float32),
        np.asarray(idx, np.int64),
        normals.astype(np.float32),
        uvs.astype(np.float32),
    )


def _cylinder_mesh(center_xz, y0, y1, radius, seg, rings, uv_scale=1.0):
    """Open cylinder shaft around the y axis (smooth normals, wrap UVs)."""
    cx, cz = center_xz
    th = np.linspace(0, 2 * np.pi, seg + 1)
    ys = np.linspace(y0, y1, rings + 1)
    tt, yy = np.meshgrid(th, ys, indexing="ij")
    pos = np.stack(
        [cx + radius * np.cos(tt), yy, cz + radius * np.sin(tt)], axis=-1
    ).reshape(-1, 3)
    nrm = np.stack(
        [np.cos(tt), np.zeros_like(tt), np.sin(tt)], axis=-1
    ).reshape(-1, 3)
    uvs = np.stack(
        [tt / (2 * np.pi) * 4 * uv_scale, (yy - y0) / max(y1 - y0, 1e-9) * uv_scale],
        axis=-1,
    ).reshape(-1, 2)
    idx = []
    for i in range(seg):
        for j in range(rings):
            a = i * (rings + 1) + j
            b = (i + 1) * (rings + 1) + j
            idx += [a, b, b + 1, a, b + 1, a + 1]
    return (
        pos.astype(np.float32),
        np.asarray(idx, np.int64),
        nrm.astype(np.float32),
        uvs.astype(np.float32),
    )


def make_atrium_gltf(
    path: str,
    detail: int = 2,
    seed: int = 0,
    light_strength: float = 60.0,
    textured: bool = True,
) -> str:
    """Enclosed Sponza-like benchmark scene: an atrium with long multi-bounce
    paths, heavy colonnade occlusion and no environment escape.

    * a fully walled and ceilinged hall (no ray can leave the scene);
    * ceiling light apertures: recessed emissive skylight panels with shaft
      walls, so all light enters from above;
    * a two-level colonnade of round columns along both long sides
      supporting gallery slabs (the dominant occluders);
    * wavy drapes hanging between upper columns (the banners) and a few
      statues on pedestals on the atrium floor;
    * every surface textured (baseColor tiles + MR + normal maps) when
      ``textured``.

    ``detail`` scales tessellation; at seed 0, loaded by
    ``scene/gltf.parse_gltf_scene`` into chunks of 128 (and 512-chunk
    coarse-gate blocks): detail=0 2,606 triangles (24 chunks), 1 56,542
    (448), 2 (default) 217,790 (1,704; 4 blocks), 3 460,190 (3,600; 8), 4
    797,822 (6,240; 13), 5 1,231,198 (9,624; 19).  Details 4 and 5 pass
    ``narrow_tile_chunks`` (4,096: 256-ray tiles), detail 5 also
    ``super_tbound_min`` (16 blocks: the t-bounded coarse gate at every
    recheck).  Deterministic for a given (detail, seed).
    """
    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)

    mat_kw: dict = {"floor": {}, "wall": {}, "column": {}, "drape": {}}
    if textured:
        from PIL import Image

        yy, xx = np.mgrid[0:64, 0:64]
        tiles = ((xx // 8 + yy // 8) % 2 * 120 + 90).astype(np.uint8)
        Image.fromarray(
            np.stack([tiles, (tiles * 0.9).astype(np.uint8),
                      (tiles * 0.75).astype(np.uint8)], axis=-1)
        ).save(os.path.join(d, "at_floor.png"))
        brick = (
            ((yy // 8) % 2 * 0 + ((xx + (yy // 8 % 2) * 8) // 16 + yy // 8) % 2)
            * 70 + 120
        ).astype(np.uint8)
        Image.fromarray(
            np.stack([brick, (brick * 0.8).astype(np.uint8),
                      (brick * 0.65).astype(np.uint8)], axis=-1)
        ).save(os.path.join(d, "at_wall.png"))
        marble = (
            128 + 90 * np.sin(xx * 0.35 + 3.0 * np.sin(yy * 0.12))
        ).clip(0, 255).astype(np.uint8)
        Image.fromarray(np.stack([marble] * 3, axis=-1)).save(
            os.path.join(d, "at_marble.png")
        )
        mr = np.zeros((64, 64, 3), dtype=np.uint8)
        mr[..., 1] = (120 + tiles // 2).astype(np.uint8)  # roughness G
        mr[..., 2] = (xx * 2 % 96).astype(np.uint8)  # metallic B (low)
        Image.fromarray(mr).save(os.path.join(d, "at_mr.png"))
        nrm = np.full((64, 64, 3), 128, dtype=np.uint8)
        nrm[..., 2] = 255
        nrm[(yy // 8) % 2 == 0, 0] = 160  # mortar-line bumps
        Image.fromarray(nrm).save(os.path.join(d, "at_nrm.png"))
        floor_t = b.add_texture("at_floor.png")
        wall_t = b.add_texture("at_wall.png")
        marble_t = b.add_texture("at_marble.png")
        mr_t = b.add_texture("at_mr.png")
        nrm_t = b.add_texture("at_nrm.png")
        mat_kw["floor"] = dict(
            base_color_texture=floor_t, metallic_roughness_texture=mr_t
        )
        mat_kw["wall"] = dict(base_color_texture=wall_t, normal_texture=nrm_t)
        mat_kw["column"] = dict(base_color_texture=marble_t)
        mat_kw["drape"] = dict(metallic_roughness_texture=mr_t)

    floor_m = b.add_material((0.62, 0.58, 0.52, 1), roughness=0.8, **mat_kw["floor"])
    wall_m = b.add_material((0.66, 0.6, 0.52, 1), roughness=0.95, **mat_kw["wall"])
    col_m = b.add_material((0.72, 0.7, 0.66, 1), roughness=0.55, **mat_kw["column"])
    trim_m = b.add_material((0.85, 0.7, 0.35, 1), metallic=1.0, roughness=0.25)
    light_m = b.add_material(
        (0, 0, 0, 1), emissive=(1.0, 0.96, 0.88),
        emissive_strength=light_strength,
    )
    drape_cols = [(0.55, 0.08, 0.08, 1), (0.08, 0.35, 0.1, 1), (0.1, 0.15, 0.5, 1)]
    drape_ms = [
        b.add_material(c, roughness=0.9, **mat_kw["drape"]) for c in drape_cols
    ]

    L, W, H = 28.0, 14.0, 11.0  # hall extents: x in +-L/2, z in +-W/2
    g = 16 * detail  # base grid density

    def patch(origin, du, dv, mat, nu, nv, uv=4.0, displace=None):
        p, i, n, t = _grid_mesh(origin, du, dv, nu, nv, uv, displace)
        b.add_mesh(p, i, material=mat, normals=n, uvs=t)

    # Floor + walls (normals face inward).
    patch((-L / 2, 0, -W / 2), (L, 0, 0), (0, 0, W), floor_m, 2 * g, g, uv=8)
    patch((-L / 2, 0, -W / 2), (0, 0, W), (0, H, 0), wall_m, g, g, uv=6)  # x=-L/2
    patch((L / 2, 0, W / 2), (0, 0, -W), (0, H, 0), wall_m, g, g, uv=6)  # x=+L/2
    patch((-L / 2, 0, W / 2), (L, 0, 0), (0, H, 0), wall_m, 2 * g, g, uv=6)  # z=+W/2
    patch((L / 2, 0, -W / 2), (-L, 0, 0), (0, H, 0), wall_m, 2 * g, g, uv=6)  # z=-W/2

    # Ceiling with three skylight apertures: ceiling strips around holes,
    # shaft walls rising to recessed emissive panels (the only lights).
    holes = [(-L / 3, 0.0), (0.0, 0.0), (L / 3, 0.0)]
    hx, hz = 3.2, 3.6  # aperture half-extents
    shaft = 0.9  # shaft height above ceiling
    # Ceiling strips (z-spans beside holes, x-strips between them).
    xs = [-L / 2] + [x for cx, _ in holes for x in (cx - hx, cx + hx)] + [L / 2]
    for k in range(0, len(xs) - 1, 2):
        x0, x1 = xs[k], xs[k + 1]
        if x1 > x0 + 1e-6:
            patch((x0, H, -W / 2), (x1 - x0, 0, 0), (0, 0, W), wall_m,
                  max(2, g // 2), g, uv=4)
    for cx, cz in holes:
        for z0, z1 in ((-W / 2, cz - hz), (cz + hz, W / 2)):
            patch((cx - hx, H, z0), (2 * hx, 0, 0), (0, 0, z1 - z0), wall_m,
                  max(2, g // 2), max(2, g // 2), uv=3)
        # Shaft walls (inward-facing) + emissive panel at the top.
        patch((cx - hx, H, cz - hz), (2 * hx, 0, 0), (0, shaft, 0), wall_m, 4, 2)
        patch((cx + hx, H, cz + hz), (-2 * hx, 0, 0), (0, shaft, 0), wall_m, 4, 2)
        patch((cx - hx, H, cz + hz), (0, 0, -2 * hz), (0, shaft, 0), wall_m, 4, 2)
        patch((cx + hx, H, cz - hz), (0, 0, 2 * hz), (0, shaft, 0), wall_m, 4, 2)
        pos, idx = quad(
            (cx - hx, H + shaft, cz - hz), (cx + hx, H + shaft, cz - hz),
            (cx + hx, H + shaft, cz + hz), (cx - hx, H + shaft, cz + hz),
        )
        b.add_mesh(pos, idx, material=light_m)

    # Two-level colonnade + gallery slabs along both long sides.
    ncol = 7
    col_x = np.linspace(-L / 2 + 2.5, L / 2 - 2.5, ncol)
    gal_y = H / 2  # gallery floor height
    gal_w = 3.0  # gallery slab width from each wall
    seg = 24 * detail
    sphere_v, sphere_f = _icosphere(min(2 + detail, 4))
    for zsign in (-1, 1):
        zc = zsign * (W / 2 - gal_w)  # column row at the gallery's inner edge
        # Gallery slab (top + bottom faces) spanning the hall length.
        z0 = zsign * W / 2
        patch((-L / 2, gal_y, z0), (L, 0, 0), (0, 0, zc - z0), floor_m,
              2 * g, max(2, g // 3), uv=6)
        patch((-L / 2, gal_y - 0.35, zc), (L, 0, 0), (0, 0, z0 - zc), wall_m,
              2 * g, max(2, g // 3), uv=6)
        # Slab inner edge fascia.
        patch((-L / 2, gal_y - 0.35, zc), (L, 0, 0), (0, 0.35, 0), trim_m,
              2 * g, 1, uv=12)
        for level, (y0, y1) in enumerate(((0.0, gal_y - 0.35), (gal_y, H))):
            for ci, cx in enumerate(col_x):
                p, i, n, t = _cylinder_mesh(
                    (cx, zc), y0 + 0.5, y1 - 0.45, 0.42 - 0.1 * level,
                    seg, 12 * detail,
                )
                b.add_mesh(p, i, material=col_m, normals=n, uvs=t)
                # Base + capital blocks.
                for yb, hb in ((y0, 0.5), (y1 - 0.45, 0.45)):
                    s = 0.62 - 0.08 * level
                    pos, idx = quad(
                        (cx - s, yb + hb, zc - s), (cx + s, yb + hb, zc - s),
                        (cx + s, yb + hb, zc + s), (cx - s, yb + hb, zc + s),
                    )
                    b.add_mesh(pos, idx, material=col_m)
                    for ax in range(4):
                        c0 = np.array([cx, 0, zc])
                        dirs = [
                            ((-s, 0, -s), (2 * s, 0, 0)),
                            ((s, 0, -s), (0, 0, 2 * s)),
                            ((s, 0, s), (-2 * s, 0, 0)),
                            ((-s, 0, s), (0, 0, -2 * s)),
                        ]
                        o0, du = dirs[ax]
                        patch(
                            (cx + o0[0], yb, zc + o0[2]), du, (0, hb, 0),
                            col_m, 2, 1,
                        )
        # Balustrade: small pillars along the gallery's inner edge.
        for bx in np.linspace(-L / 2 + 0.6, L / 2 - 0.6, 6 * ncol * detail):
            p, i, n, t = _cylinder_mesh(
                (bx, zc - zsign * 0.05), gal_y, gal_y + 1.0, 0.07, 6, 2
            )
            b.add_mesh(p, i, material=trim_m, normals=n, uvs=t)
        # Handrail.
        patch((-L / 2, gal_y + 1.0, zc - zsign * 0.12), (L, 0, 0),
              (0, 0, zsign * 0.14), trim_m, 2 * g, 1, uv=10)

    # Drapes between upper columns (wavy cloth patches).
    for k in range(ncol - 1):
        for zsign in (-1, 1):
            if (k + (zsign > 0)) % 3 == 2:
                continue
            zc = zsign * (W / 2 - gal_w - 0.25)
            x0, x1 = col_x[k] + 0.35, col_x[k + 1] - 0.35
            amp = 0.25 + 0.1 * ((k * 7 + zsign) % 3)

            def wave(uu, vv, amp=amp, zsign=zsign):
                off = np.zeros(uu.shape + (3,))
                off[..., 2] = (
                    zsign * amp * np.sin(uu * np.pi * 3) * np.sin(vv * np.pi)
                )
                off[..., 0] = 0.05 * np.sin(vv * np.pi * 5)
                return off

            p, i, n, t = _grid_mesh(
                (x0, H - 0.6, zc), (x1 - x0, 0, 0), (0, -(H - gal_y - 1.6), 0),
                3 * g, 2 * g, 2.0, displace=wave,
            )
            b.add_mesh(p, i, material=drape_ms[(k + zsign) % 3],
                       normals=n, uvs=t)

    # Statues: squashed icospheres on pedestals down the atrium center.
    for k, sx in enumerate(np.linspace(-L / 3, L / 3, 4)):
        sz = 1.6 * (1 if k % 2 else -1)
        pos, idx = quad(
            (sx - 0.8, 1.0, sz - 0.8), (sx + 0.8, 1.0, sz - 0.8),
            (sx + 0.8, 1.0, sz + 0.8), (sx - 0.8, 1.0, sz + 0.8),
        )
        b.add_mesh(pos, idx, material=col_m)
        for ax in range(4):
            dirs = [
                ((-0.8, 0, -0.8), (1.6, 0, 0)),
                ((0.8, 0, -0.8), (0, 0, 1.6)),
                ((0.8, 0, 0.8), (-1.6, 0, 0)),
                ((-0.8, 0, 0.8), (0, 0, -1.6)),
            ]
            o0, du = dirs[ax]
            patch((sx + o0[0], 0, sz + o0[2]), du, (0, 1.0, 0), col_m, 2, 1)
        scale = np.array([0.6, 0.9, 0.6]) * (0.9 + 0.2 * (k % 2))
        v = sphere_v * scale + np.array([sx, 1.9, sz])
        u = (np.arctan2(sphere_v[:, 2], sphere_v[:, 0]) / (2 * np.pi) + 0.5)
        vv = np.arccos(np.clip(sphere_v[:, 1], -1, 1)) / np.pi
        uvs = np.stack([u, vv], axis=-1).astype(np.float32)
        mat = trim_m if k == 1 else col_m
        b.add_mesh(v.astype(np.float32), sphere_f.reshape(-1), material=mat,
                   normals=sphere_v.astype(np.float32), uvs=uvs)

    # Camera: at one end looking down the hall (the classic Sponza view).
    b.add_camera((-L / 2 + 1.8, 4.2, 0.0), yfov=0.9,
                 node_transform={"rotation": [0.0, -0.7071068, 0.0, 0.7071068]})
    return b.write(path)


def _icosphere(subdiv: int):
    t = (1 + 5 ** 0.5) / 2
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = vlist[i] + vlist[j]
                m /= np.linalg.norm(m)
                vlist.append(m)
                cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for a, bb, c in faces:
            ab, bc, ca = midpoint(a, bb), midpoint(bb, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [bb, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)
    return verts, faces


GREEN_DRAPE = 6  # index of the green drape material in make_atrium_gltf's file
GREEN_DRAPE_COLOR = [0.08, 0.35, 0.1, 1]
BANNER_EMISSION = (0.3, 1.0, 0.4)
BANNER_STRENGTH = 4.0


def make_lit_banner_atrium_gltf(path: str, detail: int = 2, textured: bool = True) -> str:
    """The enclosed atrium with its green drapes (the banners) emissive:
    every banner triangle becomes a light (~24,600 lights at detail 2, in
    more than 190 clusters of 128), beside the six skylight triangles.  The
    geometry is ``make_atrium_gltf``'s; only the written material changes."""
    make_atrium_gltf(path, detail=detail, textured=textured)
    with open(path) as f:
        root = json.load(f)
    mat = root["materials"][GREEN_DRAPE]
    if mat["pbrMetallicRoughness"]["baseColorFactor"] != GREEN_DRAPE_COLOR:
        raise ValueError(f"{path}: material {GREEN_DRAPE} is not the green drape")
    mat["emissiveFactor"] = list(BANNER_EMISSION)
    mat.setdefault("extensions", {})["KHR_materials_emissive_strength"] = {
        "emissiveStrength": BANNER_STRENGTH
    }
    with open(path, "w") as f:
        json.dump(root, f)
    return path
