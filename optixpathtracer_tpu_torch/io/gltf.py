"""glTF 2.0 scene ingest (port of optixpathtracer_tpu/io/gltf.py, the
sutil/Scene.cpp loadScene equivalent).

Buffers, bufferViews and accessors are decoded, base-color textures and
factors map onto the Disney material set (metallic / roughness kept),
KHR_lights_punctual point lights map to the light dicts, and the node
hierarchy's transforms are baked into world-space meshes. Supports .gltf
(JSON + external or base64 buffers) and .glb; triangle meshes with
POSITION / NORMAL / TEXCOORD_0 and scalar indices.

Images decode through the port's own PNG decoder (io/image.py). An image
the reference's PIL could not decode either (an unsupported codec, a data
URI that is not base64, a missing file) degrades to the factor-only
material with a warning, as in the reference; a JPEG, a 16-bit or an
interlaced PNG is a gap of the port and raises NotImplementedError
(ROADMAP A.1). Node instancing (`load_gltf_tlas`) is ROADMAP A.9.
"""
from __future__ import annotations

import base64
import json
import os
import struct
import warnings

import numpy as np

from ..core.materials import make_material
from ..core.scene import HostScene, Mesh
from ..lights.lights import make_ambient_light, make_point_light
from .image import rgb8_from_png

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(path: str) -> tuple[dict, bytes | None]:
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
            raise ValueError("not a GLB file")
        gltf = None
        binary = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            clen, ctype = struct.unpack("<II", header)
            data = f.read(clen)
            if ctype == 0x4E4F534A:  # JSON
                gltf = json.loads(data)
            elif ctype == 0x004E4942:  # BIN
                binary = data
        return gltf, binary


def _buffers(gltf: dict, base_dir: str, glb_bin: bytes | None) -> list[bytes]:
    out = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(gltf: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    count = acc["count"]
    ncomp = _TYPE_COUNT[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    data = buffers[view["buffer"]]
    stride = view.get("byteStride") or dtype().itemsize * ncomp
    itemsize = dtype().itemsize * ncomp
    if stride == itemsize:
        arr = np.frombuffer(data, dtype, count * ncomp, offset).reshape(count, ncomp)
    else:
        raw = np.frombuffer(data, np.uint8)
        rows = [
            np.frombuffer(raw, dtype, ncomp, offset + i * stride) for i in range(count)
        ]
        arr = np.stack(rows)
    return arr.squeeze() if ncomp == 1 else arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def load_gltf(path: str) -> tuple[HostScene, list[dict]]:
    """Load a .gltf/.glb -> (HostScene, lights). Transforms baked to world."""
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        gltf, glb_bin = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_bin = None
    buffers = _buffers(gltf, base_dir, glb_bin)

    scene = HostScene()
    tex_cache: dict[int, int] = {}

    def image_bytes(img: dict) -> bytes | None:
        """The encoded bytes of a glTF image: a file, a base64 data URI or
        GLB bufferView bytes (tinygltf decodes all three; Scene.cpp:292-316)."""
        uri = img.get("uri", "")
        if uri and not uri.startswith("data:"):
            with open(os.path.join(base_dir, uri), "rb") as f:
                return f.read()
        if uri.startswith("data:"):
            meta, _, payload = uri.partition(",")
            if not meta.endswith(";base64"):
                raise ValueError(f"unsupported data URI: {meta}")
            return base64.b64decode(payload)
        if "bufferView" in img:
            bv = gltf["bufferViews"][img["bufferView"]]
            buf = buffers[bv.get("buffer", 0)]
            off = bv.get("byteOffset", 0)
            return bytes(buf[off : off + bv["byteLength"]])
        return None

    def material_for(mi: int | None) -> dict:
        if mi is None:
            return make_material()
        m = gltf.get("materials", [])[mi]
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        emissive = m.get("emissiveFactor", [0, 0, 0])
        tex_id = -1
        if "baseColorTexture" in pbr:
            ti = pbr["baseColorTexture"]["index"]
            if ti not in tex_cache:
                # an undecodable image degrades to the factor-only material
                # instead of failing the whole load, as in the reference;
                # what the port cannot decode but PIL could (JPEG, 16-bit or
                # interlaced PNG) raises NotImplementedError (ROADMAP A.1)
                try:
                    raw = image_bytes(gltf["images"][gltf["textures"][ti]["source"]])
                    tex_cache[ti] = -1 if raw is None else scene.add_texture(
                        rgb8_from_png(raw).astype(np.float32) / 255.0)
                except NotImplementedError:
                    raise
                except Exception as e:  # noqa: BLE001 — any decode failure, as the reference
                    warnings.warn(f"glTF texture {ti} undecodable, using "
                                  f"material factors only: {e}")
                    tex_cache[ti] = -1
            tex_id = tex_cache[ti]
        return make_material(
            color=tuple(base[:3]),
            emission=tuple(emissive),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            texture_id=tex_id,
        )

    def emit_mesh(mesh_idx: int, world: np.ndarray) -> None:
        mesh = gltf["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            pos_w = pos @ world[:3, :3].T + world[:3, 3]
            nrm = None
            if "NORMAL" in attrs:
                n = _accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                nrm_m = np.linalg.inv(world[:3, :3]).T
                nrm = n @ nrm_m.T
                nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
            if "indices" in prim:
                idx = _accessor(gltf, buffers, prim["indices"]).astype(np.int32)
                idx = idx.reshape(-1, 3)
            else:
                idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            scene.add_mesh(
                Mesh(
                    vertices=pos_w.astype(np.float32),
                    indices=idx,
                    normals=nrm,
                    texcoords=uv,
                    material=material_for(prim.get("material")),
                )
            )

    lights: list[dict] = []
    khr = gltf.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])

    def walk(node_idx: int, parent: np.ndarray) -> None:
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world)  # transforms baked to world
        li = node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        if li is not None and li < len(khr):
            spec = khr[li]
            color = tuple(spec.get("color", [1, 1, 1]))
            intensity = spec.get("intensity", 1.0)
            if spec.get("type") == "point":
                lights.append(make_point_light(tuple(world[:3, 3]), color, intensity))
        for child in node.get("children", []):
            walk(child, world)

    scene_idx = gltf.get("scene", 0)
    roots = gltf.get("scenes", [{"nodes": []}])[scene_idx].get("nodes", [])
    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))

    if not lights:
        lights.append(make_ambient_light((1.0, 1.0, 1.0), 0.8))
    return scene, lights


def load_gltf_tlas(path: str):
    """Node instancing (each glTF mesh once, in local space, with one
    transform per referencing node) feeds `compile_tlas`: ROADMAP A.9."""
    raise NotImplementedError("load_gltf_tlas (glTF node instancing) is not ported yet (ROADMAP A.9)")
