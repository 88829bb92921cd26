"""Randomized scene generators (port of ``tpu_pathtracer/utils/fuzz.py``,
writing byte-identical files).

Generates small but *mean* glTF scenes: random geometry (quads, boxes, strip
ribbons, non-indexed fans), random node transforms (TRS quaternions and raw
matrices), and random materials spanning the whole pbrMetallicRoughness space
including alpha and emissive strength.  Rendering one of these with both
implementations and comparing mean radiance catches loader/estimator
divergences that hand-written fixtures miss.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..scene.fixtures import GltfBuilder, quad


def make_fuzz_gltf(path: str, seed: int, textures: bool = True) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    b = GltfBuilder()

    tex_ids = []
    if textures:
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        for t in range(2):
            img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
            name = f"fuzz{seed}_tex{t}.png"
            Image.fromarray(img).save(os.path.join(d, name))
            tex_ids.append(b.add_texture(name))

    def rand_material():
        emissive = None
        strength = None
        if rng.random() < 0.3:
            emissive = rng.uniform(0, 1, 3).tolist()
            if rng.random() < 0.5:
                strength = float(rng.uniform(1, 20))
        alpha = 1.0 if rng.random() < 0.7 else float(rng.uniform(0.2, 1.0))
        base_tex = None
        mr_tex = None
        if tex_ids and rng.random() < 0.5:
            base_tex = int(rng.choice(tex_ids))
        if tex_ids and rng.random() < 0.3:
            mr_tex = int(rng.choice(tex_ids))
        return b.add_material(
            (*rng.uniform(0.05, 0.95, 3).tolist(), alpha),
            metallic=float(rng.choice([0.0, 1.0, rng.uniform(0, 1)])),
            roughness=float(rng.uniform(0.02, 1.0)),
            emissive=emissive,
            emissive_strength=strength,
            base_color_texture=base_tex,
            metallic_roughness_texture=mr_tex,
        )

    def rand_quat():
        q = rng.normal(size=4)
        return (q / np.linalg.norm(q)).tolist()

    def rand_transform():
        r = rng.random()
        if r < 0.35:
            return {}
        if r < 0.75:
            return {
                "translation": rng.uniform(-2, 2, 3).tolist(),
                "rotation": rand_quat(),
                "scale": rng.uniform(0.4, 1.8, 3).tolist(),
            }
        # Raw column-major matrix node (parse_mat4 path, src/scene.h:101-108)
        angle = rng.uniform(0, 2 * math.pi)
        c, s = math.cos(angle), math.sin(angle)
        sc = rng.uniform(0.5, 1.5)
        tx, ty, tz = rng.uniform(-1.5, 1.5, 3)
        m = [
            c * sc, s * sc, 0, 0,
            -s * sc, c * sc, 0, 0,
            0, 0, sc, 0,
            tx, ty, tz, 1,
        ]
        return {"matrix": m}

    # Enclosing room so paths terminate against geometry + an area light.
    room = b.add_material((0.6, 0.6, 0.62, 1))
    ext = 4.0
    for face in [
        quad((-ext, -ext, -ext), (ext, -ext, -ext), (ext, -ext, ext), (-ext, -ext, ext)),
        quad((-ext, ext, -ext), (-ext, ext, ext), (ext, ext, ext), (ext, ext, -ext)),
        quad((-ext, -ext, -ext), (-ext, ext, -ext), (ext, ext, -ext), (ext, -ext, -ext)),
        quad((-ext, -ext, -ext), (-ext, -ext, ext), (-ext, ext, ext), (-ext, ext, -ext)),
        quad((ext, -ext, -ext), (ext, ext, -ext), (ext, ext, ext), (ext, -ext, ext)),
    ]:
        b.add_mesh(*face, material=room)
    light = b.add_material(
        (0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=float(rng.uniform(10, 40))
    )
    b.add_mesh(
        *quad((-1, 3.98, -1), (1, 3.98, -1), (1, 3.98, 1), (-1, 3.98, 1)),
        material=light,
    )

    n_objects = rng.integers(2, 6)
    for _ in range(n_objects):
        mat = rand_material()
        kind = rng.random()
        if kind < 0.4:  # random quad (with UVs so textures get exercised)
            p = rng.uniform(-2, 2, (4, 3)).astype(np.float32)
            p[2] = p[1] + (p[3] - p[0])  # keep it planar-ish
            idx = np.array([0, 1, 2, 0, 2, 3])
            uv_scale = float(rng.uniform(0.5, 3.0))
            uvs = (
                np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
                * uv_scale
            )
            b.add_mesh(
                p, idx, material=mat, uvs=uvs, node_transform=rand_transform()
            )
        elif kind < 0.7:  # box via 12 tris
            s = rng.uniform(0.2, 0.9, 3)
            verts = []
            for dx in (-1, 1):
                for dy in (-1, 1):
                    for dz in (-1, 1):
                        verts.append([dx * s[0], dy * s[1], dz * s[2]])
            v = np.array(verts, dtype=np.float32)
            faces = [
                (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
            ]
            idx = []
            for f in faces:
                idx += [f[0], f[1], f[2], f[0], f[2], f[3]]
            b.add_mesh(
                v, np.array(idx), material=mat, node_transform=rand_transform()
            )
        else:  # triangle strip ribbon (mode 5)
            n = int(rng.integers(4, 9))
            p = np.zeros((n, 3), dtype=np.float32)
            p[:, 0] = np.linspace(-1, 1, n)
            p[:, 1] = rng.uniform(-0.5, 0.5, n)
            p[:, 2] = np.where(np.arange(n) % 2 == 0, -0.3, 0.3)
            # Explicit indices: the reference crashes on non-indexed
            # primitives (json null -> optional<size_t> throws before its
            # unit_t branch can trigger, src/scene.h:362-386) — we support
            # them, it does not, so parity scenes must stay indexed.
            b.add_mesh(
                p, np.arange(n), material=mat, node_transform=rand_transform()
            )
            b.meshes[-1]["primitives"][0]["mode"] = 5

    b.add_camera((0, 0.5, 3.5), yfov=float(rng.uniform(0.5, 1.0)))
    return b.write(path)


def make_maximal_gltf(path: str, seed: int = 5) -> str:
    """One real-world-shaped asset exercising every loader axis at once:
    JPEG *and* PNG textures (stb_image's two main
    decode paths, src/geometry.h:584-598), 60+ textures in one atlas, all
    three index component types u8/u16/u32 (src/scene.h:163-180), triangle
    strips (mode 5, src/scene.h:444-458), the same mesh instanced under
    different TRS nodes, nested node groups with accumulated transforms
    (src/scene.h:224-230,461-465), raw matrix nodes, normal/emissive/MR
    textures, and alpha-carrying materials (the alpha->ior reset quirk,
    src/scene.h:285-287)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)

    # --- 64 textures: even ids PNG, odd ids JPEG; varied non-pow2 sizes ---
    tex_ids = []
    for t in range(64):
        wh = (int(rng.integers(4, 17)), int(rng.integers(4, 17)))
        img = rng.integers(0, 256, size=(wh[1], wh[0], 3), dtype=np.uint8)
        if t % 2 == 0:
            name = f"max{seed}_tex{t}.png"
            Image.fromarray(img).save(os.path.join(d, name))
        else:
            name = f"max{seed}_tex{t}.jpg"
            # High quality keeps stb-vs-PIL decode drift ~1 u8 per texel.
            Image.fromarray(img).save(os.path.join(d, name), quality=95)
        tex_ids.append(b.add_texture(name))
    # A smooth normal map (PNG only: JPEG ringing through normalize() would
    # add decode-drift the parity bounds shouldn't have to absorb).
    ny, nx = 12, 12
    gx, gy = np.meshgrid(np.linspace(-1, 1, nx), np.linspace(-1, 1, ny))
    nrm = np.stack([0.5 + 0.2 * gx, 0.5 + 0.2 * gy, np.full_like(gx, 0.9)], -1)
    Image.fromarray((nrm * 255).astype(np.uint8)).save(
        os.path.join(d, f"max{seed}_nrm.png")
    )
    normal_tex = b.add_texture(f"max{seed}_nrm.png")

    def rand_material(k):
        return b.add_material(
            (*rng.uniform(0.2, 0.95, 3).tolist(),
             1.0 if k % 3 else float(rng.uniform(0.4, 1.0))),
            metallic=float(rng.choice([0.0, 1.0, rng.uniform(0, 1)])),
            roughness=float(rng.uniform(0.05, 1.0)),
            base_color_texture=int(tex_ids[k % len(tex_ids)]),
            metallic_roughness_texture=(
                int(tex_ids[(k * 7 + 1) % len(tex_ids)]) if k % 2 else None
            ),
            emissive=(rng.uniform(0, 1, 3).tolist() if k % 5 == 0 else None),
            emissive_strength=(float(rng.uniform(2, 8)) if k % 5 == 0 else None),
            emissive_texture=(
                int(tex_ids[(k * 3 + 2) % len(tex_ids)]) if k % 5 == 0 else None
            ),
            normal_texture=(normal_tex if k % 4 == 0 else None),
        )

    # Enclosing room + one area light so paths terminate on geometry.
    room = b.add_material((0.62, 0.6, 0.58, 1))
    ext = 4.0
    for face in [
        quad((-ext, -ext, -ext), (ext, -ext, -ext), (ext, -ext, ext), (-ext, -ext, ext)),
        quad((-ext, ext, -ext), (-ext, ext, ext), (ext, ext, ext), (ext, ext, -ext)),
        quad((-ext, -ext, -ext), (-ext, ext, -ext), (ext, ext, -ext), (ext, -ext, -ext)),
        quad((-ext, -ext, -ext), (-ext, -ext, ext), (-ext, ext, ext), (-ext, ext, -ext)),
        quad((ext, -ext, -ext), (ext, ext, -ext), (ext, ext, ext), (ext, -ext, ext)),
    ]:
        b.add_mesh(*face, material=room)
    light = b.add_material((0, 0, 0, 1), emissive=(1, 1, 1), emissive_strength=25.0)
    b.add_mesh(
        *quad((-1, 3.98, -1), (1, 3.98, -1), (1, 3.98, 1), (-1, 3.98, 1)),
        material=light,
    )

    uv4 = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], dtype=np.float32)
    idx_quad = np.array([0, 1, 2, 0, 2, 3])
    idx_dtypes = ["u8", "u16", "u32"]

    # A shared "statue" mesh (octahedron), instanced under 3 different TRS
    # nodes — node reuse (handle_node revisits the mesh per node).
    oct_v = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=np.float32,
    ) * 0.5
    oct_i = np.array(
        [0, 2, 4, 2, 1, 4, 1, 3, 4, 3, 0, 4, 2, 0, 5, 1, 2, 5, 3, 1, 5, 0, 3, 5]
    )
    statue_node = b.add_mesh(
        oct_v, oct_i, material=rand_material(0), index_dtype="u8",
        node_transform={"translation": [-1.5, -3.0, 0.0]},
    )
    statue_mesh = b.mesh_of(statue_node)
    b.add_node(statue_mesh, {
        "translation": [1.5, -3.0, 0.5],
        "rotation": [0.0, math.sin(0.6), 0.0, math.cos(0.6)],
        "scale": [1.4, 0.8, 1.1],
    })
    b.add_node(statue_mesh, {
        # Raw column-major matrix instance (parse_mat4, src/scene.h:101-108).
        "matrix": [0.8, 0.3, 0, 0, -0.3, 0.8, 0, 0, 0, 0, 0.9, 0,
                   0.2, -2.2, -1.4, 1],
    })

    # Textured quads under a two-deep nested group (accumulated transforms);
    # index dtype cycles u8/u16/u32.
    inner_nodes = []
    for k in range(1, 9):
        p = np.array(
            [[-0.6, 0, 0], [0.6, 0, 0], [0.6, 1.0, 0], [-0.6, 1.0, 0]],
            dtype=np.float32,
        )
        n = b.add_mesh(
            p, idx_quad, material=rand_material(k), uvs=uv4,
            index_dtype=idx_dtypes[k % 3],
            node_transform={
                "translation": [((k % 4) - 1.5) * 1.5, 0.0, -0.4 * (k // 4)],
                "rotation": [0.0, math.sin(k * 0.3), 0.0, math.cos(k * 0.3)],
            },
        )
        inner_nodes.append(n)
    inner = b.add_group(
        inner_nodes[:4],
        {"translation": [0.0, -2.6, 0.8], "scale": [0.9, 0.9, 0.9]},
    )
    b.add_group(
        [inner] + inner_nodes[4:],
        {"translation": [0.0, -0.4, -0.6],
         "rotation": [0.0, math.sin(0.15), 0.0, math.cos(0.15)]},
    )

    # Triangle-strip ribbons (mode 5) with u16/u32 indices + more textured
    # materials to push the atlas over 50 *used* textures.
    for k in range(9, 33):
        n = 8
        p = np.zeros((n, 3), dtype=np.float32)
        p[:, 0] = np.linspace(-0.8, 0.8, n)
        p[:, 1] = rng.uniform(-0.25, 0.25, n)
        p[:, 2] = np.where(np.arange(n) % 2 == 0, -0.2, 0.2)
        uvs = np.zeros((n, 2), dtype=np.float32)
        uvs[:, 0] = np.linspace(0, 3, n)
        uvs[:, 1] = np.arange(n) % 2
        b.add_mesh(
            p, np.arange(n), material=rand_material(k), uvs=uvs,
            index_dtype=("u16" if k % 2 else "u32"), mode=5,
            node_transform={
                "translation": [
                    ((k % 6) - 2.5) * 1.2,
                    -3.2 + 0.5 * ((k // 6) % 4),
                    -2.0 + 0.9 * (k % 3),
                ],
                "rotation": [0.0, math.sin(k * 0.4), 0.0, math.cos(k * 0.4)],
            },
        )

    b.add_camera((0, -1.2, 3.6), yfov=0.9)
    return b.write(path)
