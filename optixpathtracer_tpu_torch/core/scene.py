"""Scene container: host-side builder + device-side SoA tensors (port of
optixpathtracer_tpu/core/scene.py).

The host side (`Mesh`, `HostScene`, `flatten`) is the reference's numpy code.
The device side keeps the flat, sorted triangle soup and its (N, 32) packed
shade rows, so hit shading is one wide-row gather (`SceneData.take_shade`),
and every texture of the scene packed into one flat RGB pool
(`TexturePool`): a texture fetch is a gather, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .materials import MaterialTable, build_table, make_material
from .math import Vec3

Tensor = torch.Tensor


class TexturePool(NamedTuple):
    """All scene textures packed into one flat RGB pool (SoA channels)."""

    r: Tensor
    g: Tensor
    b: Tensor
    offset: Tensor
    width: Tensor
    height: Tensor

    @staticmethod
    def empty(device) -> "TexturePool":
        one = torch.ones((1,), dtype=torch.float32, device=device)
        zero_i = torch.zeros((1,), dtype=torch.int32, device=device)
        one_i = torch.ones((1,), dtype=torch.int32, device=device)
        return TexturePool(one, one, one, zero_i, one_i, one_i)

    def sample_bilinear(self, tex_id: Tensor, u: Tensor, v: Tensor) -> Vec3:
        """Bilinear fetch with wrap addressing; tex_id < 0 returns white.
        The reference's expression order: `u % 1.0` is XLA's remainder (a
        truncated fmod moved into [0, 1)), the texel wrap a floor modulo
        (x0 is -1 at u = 0)."""
        tid = torch.clamp(tex_id, min=0).to(torch.int64)
        w = self.width[tid].to(torch.float32)
        h = self.height[tid].to(torch.float32)
        off = self.offset[tid]
        uu = _wrap01(u) * w - 0.5
        vv = _wrap01(v) * h - 0.5
        x0 = torch.floor(uu)
        y0 = torch.floor(vv)
        fx = uu - x0
        fy = vv - y0
        wi = self.width[tid]
        hi = self.height[tid]

        def fetch(xi, yi):
            xi = torch.remainder(xi.to(torch.int32), wi)
            yi = torch.remainder(yi.to(torch.int32), hi)
            idx = (off + yi * wi + xi).to(torch.int64)
            return Vec3(self.r[idx], self.g[idx], self.b[idx])

        c00 = fetch(x0, y0)
        c10 = fetch(x0 + 1, y0)
        c01 = fetch(x0, y0 + 1)
        c11 = fetch(x0 + 1, y0 + 1)
        top = c00 * (1.0 - fx) + c10 * fx
        bot = c01 * (1.0 - fx) + c11 * fx
        out = top * (1.0 - fy) + bot * fy
        has = tex_id >= 0
        return Vec3(*(torch.where(has, c, 1.0) for c in out))


def _wrap01(u: Tensor) -> Tensor:
    """`jnp.remainder(u, 1.0)`: fmod, plus 1 where it is negative (-0.0
    stays -0.0). One rounding, as XLA's, for negative u and integers."""
    r = torch.fmod(u, 1.0)
    return torch.where(r < 0.0, r + 1.0, r)


def pack_textures(images: Sequence[np.ndarray], device) -> TexturePool:
    """(H, W, 3) float32 images -> one flat RGB pool on `device`, each
    texture's pixels row-major from its `offset`."""
    if not images:
        return TexturePool.empty(device)
    offsets, widths, heights, chunks = [], [], [], []
    off = 0
    for img in images:
        img = np.asarray(img, np.float32)
        h, w = img.shape[:2]
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        chunks.append(img.reshape(-1, img.shape[-1])[:, :3])
        off += h * w
    flat = np.concatenate(chunks, axis=0)

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return TexturePool(r=up(flat[:, 0], np.float32), g=up(flat[:, 1], np.float32),
                       b=up(flat[:, 2], np.float32), offset=up(offsets, np.int32),
                       width=up(widths, np.int32), height=up(heights, np.int32))


class SceneData(NamedTuple):
    """Device-resident flat triangle soup in BVH-sorted order."""

    v0: Vec3
    v1: Vec3
    v2: Vec3
    n0: Vec3  # shading normals (geometric normal where absent)
    n1: Vec3
    n2: Vec3
    uv0u: Tensor
    uv0v: Tensor
    uv1u: Tensor
    uv1v: Tensor
    uv2u: Tensor
    uv2v: Tensor
    material_id: Tensor  # (N,) int32
    has_shading_normal: Tensor  # (N,) bool
    materials: MaterialTable
    textures: TexturePool
    shade_rows: Tensor  # (N, 32) f32 packed per-triangle shade record:
    #   [v0|v1|v2 (9), n0|n1|n2 (9), uv0|uv1|uv2 (6), mat_id, has_sn, pad(6)]
    textured: bool = True  # some material has texture_id >= 0: hit shading
    #   samples the pool (where none has, the albedo is the color anyway)

    def take_shade(self, tri: Tensor):
        """One-gather fetch of the per-hit shade record. Returns
        (v0, v1, v2, n0, n1, n2, (uv0u, uv0v, uv1u, uv1v, uv2u, uv2v),
        mat_id, has_sn)."""
        r = self.shade_rows[tri]  # (N, 32)

        def v3(c):
            return Vec3(r[:, c], r[:, c + 1], r[:, c + 2])

        uv = tuple(r[:, 18 + k] for k in range(6))
        return (
            v3(0), v3(3), v3(6), v3(9), v3(12), v3(15), uv,
            r[:, 24].to(torch.int32), r[:, 25] > 0.5,
        )


@dataclasses.dataclass
class Mesh:
    """Host-side mesh: one material per mesh (Model.h TriangleMesh semantics)."""

    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (F, 3) int32
    normals: np.ndarray | None = None  # (V, 3) or None
    texcoords: np.ndarray | None = None  # (V, 2) or None
    material: dict = dataclasses.field(default_factory=make_material)


@dataclasses.dataclass
class HostScene:
    """Host staging area; `flatten()` produces numpy SoA ready for BVH build."""

    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    textures: list[np.ndarray] = dataclasses.field(default_factory=list)

    def add_mesh(self, mesh: Mesh) -> None:
        self.meshes.append(mesh)

    def add_texture(self, image: np.ndarray) -> int:
        """Register an (H, W, 3) float32 image; returns its texture id."""
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_box(self, material: dict, pos, extent) -> None:
        """Procedural axis-aligned box (Model.cpp addBox :214-286 semantics)."""
        pos = np.asarray(pos, np.float32)
        e = np.asarray(extent, np.float32)
        lo, hi = pos - e, pos + e
        corners = np.array(
            [
                [lo[0], lo[1], hi[2]],  # A
                [hi[0], lo[1], hi[2]],  # B
                [hi[0], hi[1], hi[2]],  # C
                [lo[0], hi[1], hi[2]],  # D
                [lo[0], lo[1], lo[2]],  # E
                [hi[0], lo[1], lo[2]],  # F
                [hi[0], hi[1], lo[2]],  # G
                [lo[0], hi[1], lo[2]],  # H
            ],
            np.float32,
        )
        quads = [  # (v0, v1, v2, v3, normal)
            (0, 1, 2, 3, [0, 0, 1]),  # front
            (4, 7, 6, 5, [0, 0, -1]),  # back
            (4, 0, 3, 7, [-1, 0, 0]),  # left
            (1, 5, 6, 2, [1, 0, 0]),  # right
            (3, 2, 6, 7, [0, 1, 0]),  # top
            (4, 0, 1, 5, [0, -1, 0]),  # bottom (reference uses E,A,B winding)
        ]
        verts, norms, idx = [], [], []
        for a, b, c, d, n in quads:
            base = len(verts)
            verts += [corners[a], corners[b], corners[c], corners[d]]
            norms += [n, n, n, n]
            idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        self.add_mesh(
            Mesh(
                vertices=np.asarray(verts, np.float32),
                indices=np.asarray(idx, np.int32),
                normals=np.asarray(norms, np.float32),
                material=material,
            )
        )

    def flatten(self) -> dict:
        """Fuse meshes into numpy SoA dicts (still unsorted — BVH reorders)."""
        if not self.meshes:
            raise ValueError("empty scene")
        tri_v = [[], [], []]
        tri_n = [[], [], []]
        tri_uv = [[], [], []]
        mat_ids = []
        has_sn = []
        materials = []
        for mesh in self.meshes:
            mid = len(materials)
            materials.append(mesh.material)
            v = np.asarray(mesh.vertices, np.float32)
            f = np.asarray(mesh.indices, np.int32)
            corners = [v[f[:, k]] for k in range(3)]
            for k in range(3):
                tri_v[k].append(corners[k])
            if mesh.normals is not None and len(mesh.normals):
                n = np.asarray(mesh.normals, np.float32)
                for k in range(3):
                    tri_n[k].append(n[f[:, k]])
                has_sn.append(np.ones(len(f), bool))
            else:
                # geometric normal fallback (04HelloRaytracing deviceProgram.cu:86-91)
                e1 = corners[1] - corners[0]
                e2 = corners[2] - corners[0]
                gn = np.empty_like(e1)
                gn[:, 0] = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
                gn[:, 1] = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
                gn[:, 2] = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
                gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
                for k in range(3):
                    tri_n[k].append(gn)
                has_sn.append(np.zeros(len(f), bool))
            if mesh.texcoords is not None and len(mesh.texcoords):
                t = np.asarray(mesh.texcoords, np.float32)
                for k in range(3):
                    tri_uv[k].append(t[f[:, k]])
            else:
                for k in range(3):
                    tri_uv[k].append(np.zeros((len(f), 2), np.float32))
            mat_ids.append(np.full(len(f), mid, np.int32))

        return dict(
            v=[np.concatenate(tri_v[k]) for k in range(3)],
            n=[np.concatenate(tri_n[k]) for k in range(3)],
            uv=[np.concatenate(tri_uv[k]) for k in range(3)],
            material_id=np.concatenate(mat_ids),
            has_shading_normal=np.concatenate(has_sn),
            materials=materials,
            textures=self.textures,
        )


def pack_shade_rows(flat: dict, order: np.ndarray, pad_to: int) -> np.ndarray:
    """(pad_to, 32) float32 shade rows of the flattened scene in `order`,
    padded with degenerate triangles at a far point (never hit)."""
    n = len(order)
    far = 3.0e37
    out = np.zeros((pad_to, 32), np.float32)
    for k in range(3):
        out[:n, 3 * k : 3 * k + 3] = flat["v"][k][order]
        out[n:, 3 * k : 3 * k + 3] = far
        out[:n, 9 + 3 * k : 12 + 3 * k] = flat["n"][k][order]
        out[:n, 18 + 2 * k : 20 + 2 * k] = flat["uv"][k][order]
    out[:n, 24] = flat["material_id"][order]
    out[:n, 25] = flat["has_shading_normal"][order]
    return out


def scene_from_shade_rows(shade: np.ndarray, materials: MaterialTable, device,
                          textures: TexturePool | None = None) -> SceneData:
    """SceneData on `device` from packed (N, 32) shade rows (and the texture
    pool, empty if None); the per-field tensors are column views of the one
    uploaded row table."""
    rows = torch.as_tensor(np.array(shade, np.float32), device=device)

    def v3(c):
        return Vec3(rows[:, c], rows[:, c + 1], rows[:, c + 2])

    return SceneData(
        v0=v3(0), v1=v3(3), v2=v3(6), n0=v3(9), n1=v3(12), n2=v3(15),
        uv0u=rows[:, 18], uv0v=rows[:, 19], uv1u=rows[:, 20],
        uv1v=rows[:, 21], uv2u=rows[:, 22], uv2v=rows[:, 23],
        material_id=rows[:, 24].to(torch.int32),
        has_shading_normal=rows[:, 25] > 0.5,
        materials=materials,
        textures=TexturePool.empty(device) if textures is None else textures,
        shade_rows=rows,
        textured=bool((materials.texture_id >= 0).any()),
    )


def device_scene_from_sorted(flat: dict, order: np.ndarray, pad_to: int, device) -> SceneData:
    """Upload the flattened host scene in BVH order onto `device`."""
    shade = pack_shade_rows(flat, order, pad_to)
    return scene_from_shade_rows(shade, build_table(flat["materials"], device), device,
                                 pack_textures(flat["textures"], device))
