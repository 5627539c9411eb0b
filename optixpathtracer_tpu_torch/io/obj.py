"""Wavefront OBJ + MTL scene ingest (port of optixpathtracer_tpu/io/obj.py).

Reference behavior reproduced (HelloPathtracing_original/Model.cpp):
loadOBJ (:137-212) — triangulating parse, shapes split into one mesh PER
MATERIAL ID (:166-201), vertices deduplicated by (v, vn, vt) index triplet
(addVertex :51-84); materials take only diffuse + emission from the MTL
(:189-190, everything else keeps Disney defaults); diffuse textures loaded
with a vertical flip (loadTexture :88-135, backslash fixing :100-103)
through the port's own image decoders (io/image.py `load_image`).

`load_obj` tokenizes with the native C++ parser (io/native.py, the port's
copy of the reference's objparser.cpp) and assembles the meshes in numpy,
as the reference does; `_load_obj_python` is the reference's pure-Python
parser with the same semantics, taken under OPTIX_TPU_NO_NATIVE=1, with
`prefer_native=False`, or where the native parse fails on a file.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.materials import make_material
from ..core.scene import HostScene, Mesh
from .image import load_image, save_png


def _parse_mtl(path: str) -> dict[str, dict]:
    """MTL -> {name: {kd, ke, map_kd}}; silently skips what it can't read."""
    mats: dict[str, dict] = {}
    cur: dict | None = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = {"kd": (0.6, 0.6, 0.6), "ke": (0.0, 0.0, 0.0), "map_kd": ""}
                mats[" ".join(parts[1:])] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur["kd"] = tuple(float(x) for x in parts[1:4])
            elif key == "ke" and len(parts) >= 4:
                cur["ke"] = tuple(float(x) for x in parts[1:4])
            elif key == "map_kd" and len(parts) >= 2:
                cur["map_kd"] = parts[-1]
    return mats


def _parse_index(token: str, nv: int, nt: int, nn: int) -> tuple[int, int, int]:
    """'v/vt/vn' with OBJ 1-based and negative indices -> 0-based triplet."""
    comps = token.split("/")
    def fix(s: str, n: int) -> int:
        if not s:
            return -1
        i = int(s)
        return i - 1 if i > 0 else n + i

    v = fix(comps[0], nv)
    vt = fix(comps[1], nt) if len(comps) > 1 else -1
    vn = fix(comps[2], nn) if len(comps) > 2 else -1
    return v, vt, vn


def save_obj(path: str, scene: HostScene) -> None:
    """Write a HostScene back to OBJ+MTL (test fixtures / interchange).

    Textures referenced by mesh materials are written as PNGs next to the
    MTL and declared with map_Kd, so textured scenes round-trip through
    load_obj (which reads map_Kd + stb-style y-flip, like Model.cpp:88-135).
    """
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    stem = os.path.splitext(os.path.basename(path))[0]
    tex_files: dict[int, str] = {}
    for mesh in scene.meshes:
        tid = int(mesh.material.get("texture_id", -1))
        if tid >= 0 and tid not in tex_files:
            tex_name = f"{stem}_tex{tid}.png"
            # stored row 0 = bottom (load_image flips); write top-first
            save_png(
                os.path.join(os.path.dirname(os.path.abspath(path)), tex_name),
                scene.textures[tid][::-1],
            )
            tex_files[tid] = tex_name
    with open(mtl_path, "w") as mf, open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        base = 1
        tbase = 1
        nbase = 1
        for i, mesh in enumerate(scene.meshes):
            name = f"mat{i}"
            c = mesh.material["color"]
            e = mesh.material["emission"]
            mf.write(f"newmtl {name}\nKd {c[0]} {c[1]} {c[2]}\nKe {e[0]} {e[1]} {e[2]}\n")
            tid = int(mesh.material.get("texture_id", -1))
            if tid >= 0:
                mf.write(f"map_Kd {tex_files[tid]}\n")
            f.write(f"o mesh{i}\nusemtl {name}\n")
            for v in mesh.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            has_n = mesh.normals is not None and len(mesh.normals)
            has_t = mesh.texcoords is not None and len(mesh.texcoords)
            if has_n:
                for n in mesh.normals:
                    f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            if has_t:
                for t in mesh.texcoords:
                    f.write(f"vt {t[0]} {t[1]}\n")
            for tri in mesh.indices:
                toks = []
                for k in tri:
                    vi = base + int(k)
                    ti = f"{tbase + int(k)}" if has_t else ""
                    ni = f"{nbase + int(k)}" if has_n else ""
                    toks.append(f"{vi}/{ti}/{ni}" if (has_t or has_n) else f"{vi}")
                f.write("f " + " ".join(toks) + "\n")
            base += len(mesh.vertices)
            if has_t:
                tbase += len(mesh.texcoords)
            if has_n:
                nbase += len(mesh.normals)


def _find_mtllibs(path: str) -> list[str]:
    """Cheap byte-level scan for mtllib declarations (native path helper)."""
    libs = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while True:
        idx = data.find(b"mtllib", pos)
        if idx < 0:
            break
        if idx == 0 or data[idx - 1 : idx] in (b"\n", b"\r"):
            eol = data.find(b"\n", idx)
            eol = len(data) if eol < 0 else eol
            libs += data[idx + 6 : eol].decode(errors="replace").split()
        pos = idx + 6
    return libs


class _TextureError(Exception):
    """A map_Kd that does not decode, carried past the native path's
    fallback (its cause is the decoder's own error)."""


def _load_obj_native(path: str) -> HostScene | None:
    """C++ tokenizer + vectorised numpy assembly (the Python parser's
    semantics: per-(shape, material) split, triplet dedupe); None under
    OPTIX_TPU_NO_NATIVE=1."""
    from .native import parse_obj_native

    parsed = parse_obj_native(path)
    if parsed is None:
        return None
    pos, nrm, uv, tris, names = parsed
    obj_dir = os.path.dirname(os.path.abspath(path))
    mtl: dict[str, dict] = {}
    for lib in _find_mtllibs(path):
        mtl.update(_parse_mtl(os.path.join(obj_dir, lib)))

    scene = HostScene()
    known_textures: dict[str, int] = {}
    if len(tris) == 0:
        return scene

    for g, (shape_name, mat_name) in enumerate(names):
        sel = tris[tris[:, 9] == g]
        if len(sel) == 0:
            continue
        corners = np.stack(
            [sel[:, [0, 3, 6]], sel[:, [1, 4, 7]], sel[:, [2, 5, 8]]], axis=1
        ).reshape(-1, 3)  # (3F, [v, vt, vn])
        uniq, inverse = np.unique(corners, axis=0, return_inverse=True)
        faces = inverse.reshape(-1, 3).astype(np.int32)
        verts = pos[uniq[:, 0]]
        any_uv = (uniq[:, 1] >= 0).any() and len(uv)
        any_n = (uniq[:, 2] >= 0).any() and len(nrm)
        uv_out = uv[np.maximum(uniq[:, 1], 0)] * (uniq[:, 1] >= 0)[:, None] if any_uv else None
        n_out = nrm[np.maximum(uniq[:, 2], 0)] * (uniq[:, 2] >= 0)[:, None] if any_n else None
        # geometric-normal fallback for corners without a vn (as the
        # Python parser does)
        if n_out is not None:
            missing = uniq[:, 2] < 0
            if missing.any():
                gn = np.cross(
                    verts[faces[:, 1]] - verts[faces[:, 0]],
                    verts[faces[:, 2]] - verts[faces[:, 0]],
                )
                gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
                for corner in range(3):
                    idxs = faces[:, corner]
                    fill = missing[idxs]
                    n_out[idxs[fill]] = gn[fill]

        m = mtl.get(mat_name, {"kd": (0.6, 0.6, 0.6), "ke": (0.0, 0.0, 0.0), "map_kd": ""})
        tex_id = -1
        tex_name = m.get("map_kd", "")
        if tex_name:
            if tex_name in known_textures:
                tex_id = known_textures[tex_name]
            else:
                tex_path = os.path.join(obj_dir, tex_name.replace("\\", "/"))
                if os.path.exists(tex_path):
                    try:
                        tex_id = scene.add_texture(load_image(tex_path, flip_y=True))
                    except Exception as e:
                        raise _TextureError from e
                known_textures[tex_name] = tex_id
        scene.add_mesh(
            Mesh(
                vertices=verts.astype(np.float32),
                indices=faces,
                normals=n_out.astype(np.float32) if n_out is not None else None,
                texcoords=uv_out.astype(np.float32) if uv_out is not None else None,
                material=make_material(color=m["kd"], emission=m["ke"], texture_id=tex_id),
            )
        )
    return scene


def load_obj(path: str, prefer_native: bool = True) -> HostScene:
    """OBJ file -> HostScene with per-(shape, material) meshes.

    Tokenizes with the native C++ parser (built at first use; a failed build
    raises) unless OPTIX_TPU_NO_NATIVE=1 or `prefer_native=False`; a file
    the native path cannot assemble falls back to the Python parser, as in
    the reference. A texture that does not decode raises the decoder's own
    error (as the reference's PIL does) on either path, decoded once."""
    if prefer_native:
        from .native import get_lib

        get_lib()  # build outside the fallback below: a missing compiler raises
        try:
            scene = _load_obj_native(path)
            if scene is not None:
                return scene
        except FileNotFoundError:
            raise
        except _TextureError as e:
            raise e.__cause__ from None  # the decoder's error, once: no second decode in Python
        except Exception:
            pass  # any other native-path problem falls back to the Python parser
    return _load_obj_python(path)


def _load_obj_python(path: str) -> HostScene:
    """The reference's pure-Python OBJ parser."""
    obj_dir = os.path.dirname(os.path.abspath(path))
    positions: list = []
    normals: list = []
    texcoords: list = []
    mtl: dict[str, dict] = {}

    # faces grouped by (shape, material): list of triangles of index triplets
    groups: dict[tuple[str, str], list] = {}
    shape = "default"
    material = ""

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif key in ("o", "g"):
                shape = " ".join(parts[1:]) or "default"
            elif key == "usemtl":
                material = " ".join(parts[1:])
            elif key == "mtllib":
                for lib in parts[1:]:
                    mtl.update(_parse_mtl(os.path.join(obj_dir, lib)))
            elif key == "f":
                nv, nt, nn = len(positions), len(texcoords), len(normals)
                idx = [_parse_index(t, nv, nt, nn) for t in parts[1:]]
                tris = groups.setdefault((shape, material), [])
                # fan-triangulate polygons (the reference asks tinyobj to
                # triangulate; fan is its default for convex faces)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32) if normals else np.zeros((0, 3), np.float32)
    uv = np.asarray(texcoords, np.float32) if texcoords else np.zeros((0, 2), np.float32)

    scene = HostScene()
    known_textures: dict[str, int] = {}

    for (shape_name, mat_name), tris in groups.items():
        if not tris:
            continue
        # vertex dedupe by index triplet (addVertex semantics)
        remap: dict[tuple[int, int, int], int] = {}
        v_out: list = []
        n_out: list = []
        t_out: list = []
        f_out: list = []
        any_normal = False
        any_uv = False
        for tri in tris:
            face = []
            for trip in tri:
                if trip not in remap:
                    remap[trip] = len(v_out)
                    v_out.append(pos[trip[0]])
                    if trip[2] >= 0 and len(nrm):
                        n_out.append(nrm[trip[2]])
                        any_normal = True
                    else:
                        n_out.append(np.zeros(3, np.float32))
                    if trip[1] >= 0 and len(uv):
                        t_out.append(uv[trip[1]])
                        any_uv = True
                    else:
                        t_out.append(np.zeros(2, np.float32))
                face.append(remap[trip])
            f_out.append(face)

        # mixed normal presence: corners without a vn would otherwise stay
        # zero vectors while the mesh advertises shading normals, and
        # normalize(0) breaks shading — fall back to the face's geometric
        # normal for those corners (ADVICE r1)
        if any_normal:
            varr = np.asarray(v_out, np.float32)
            narr = np.asarray(n_out, np.float32)
            farr = np.asarray(f_out, np.int32)
            missing = np.abs(narr).sum(axis=1) == 0.0
            if missing.any():
                gn = np.cross(
                    varr[farr[:, 1]] - varr[farr[:, 0]],
                    varr[farr[:, 2]] - varr[farr[:, 0]],
                )
                gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
                for corner in range(3):
                    idxs = farr[:, corner]
                    fill = missing[idxs]
                    narr[idxs[fill]] = gn[fill]
                n_out = narr

        m = mtl.get(mat_name, {"kd": (0.6, 0.6, 0.6), "ke": (0.0, 0.0, 0.0), "map_kd": ""})
        tex_id = -1
        tex_name = m.get("map_kd", "")
        if tex_name:
            tex_key = tex_name
            if tex_key in known_textures:
                tex_id = known_textures[tex_key]
            else:
                tex_path = os.path.join(obj_dir, tex_name.replace("\\", "/"))
                if os.path.exists(tex_path):
                    tex_id = scene.add_texture(load_image(tex_path, flip_y=True))
                known_textures[tex_key] = tex_id

        mat = make_material(color=m["kd"], emission=m["ke"], texture_id=tex_id)
        scene.add_mesh(
            Mesh(
                vertices=np.asarray(v_out, np.float32),
                indices=np.asarray(f_out, np.int32),
                normals=np.asarray(n_out, np.float32) if any_normal else None,
                texcoords=np.asarray(t_out, np.float32) if any_uv else None,
                material=mat,
            )
        )
    return scene
