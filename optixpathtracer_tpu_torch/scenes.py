"""Procedural scenes, scenes from files and render setups, rebuilt without jax.

`build_city_scene` is the bench's 150k-triangle city (bench.py
`build_city_scene`, `_unit_box`) and `build_big_scene` its terrain-apron
scale scene (bench.py `build_big_scene`), made from the same seeds with the
same numpy calls, so they are the same triangle soups. `loft_config` is
bench.py's `--scene loft` setup (camera, probe, flags) for the textured
interior `scenes/loft.obj`. The `open_*`, `cornell_*`, `loft` and `gltf`
functions are the golden setups of tests/golden_scenes.py (`_open_scene`,
`_cornell_scene`, `_sky_probe`, `_cam`/`_cam_s`, `render_disney_open*`,
`render_disney_cornell*`, `render_loft*`, `render_gltf`,
`render_foveated*`) with the cluster traversal in place of the reference's
CPU lockstep backend (both are exact).
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import NamedTuple

import numpy as np

from .builder import compile_scene
from .core.camera import Camera
from .core.materials import make_material
from .core.scene import HostScene, Mesh
from .engine.foveated import FoveatedRenderer, FoveationConfig
from .engine.renderer import Renderer
from .engine.wavefront import RenderConfig
from .io.gltf import load_gltf
from .io.obj import load_obj
from .lights.lights import QuadLight
from .lights.probe import Probe, build_probe

LOFT_OBJ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scenes", "loft.obj")


def _unit_box():
    v = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
        np.float32,
    )
    f = np.array(
        [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
         [3, 2, 6], [3, 6, 7], [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2]],
        np.int32,
    )
    return v, f


def build_city_scene(n_boxes=12500, seed=0) -> HostScene:
    """~12.5k boxes x 12 tris = 150k triangles, lost_empire scale."""
    rng = np.random.default_rng(seed)
    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.5, 0), extent=(60, 0.5, 60))

    centers = rng.uniform(-50, 50, size=(n_boxes, 2)).astype(np.float32)
    heights = rng.gamma(2.0, 1.2, size=n_boxes).astype(np.float32) + 0.3
    widths = rng.uniform(0.2, 0.9, size=(n_boxes, 2)).astype(np.float32)

    n_buckets = 8
    bucket = rng.integers(0, n_buckets, n_boxes)
    base = np.array(
        [[0.8, 0.3, 0.2], [0.2, 0.7, 0.3], [0.25, 0.35, 0.8], [0.8, 0.75, 0.3],
         [0.6, 0.6, 0.6], [0.8, 0.5, 0.2], [0.4, 0.2, 0.6], [0.7, 0.7, 0.9]],
        np.float32,
    )
    unit_v, unit_f = _unit_box()
    for b in range(n_buckets):
        idx = np.nonzero(bucket == b)[0]
        if len(idx) == 0:
            continue
        k = len(idx)
        scale = np.stack([widths[idx, 0], heights[idx] * 0.5, widths[idx, 1]], -1)
        offset = np.stack([centers[idx, 0], heights[idx] * 0.5, centers[idx, 1]], -1)
        verts = unit_v[None] * scale[:, None, :] + offset[:, None, :]
        faces = unit_f[None] + (np.arange(k)[:, None, None] * len(unit_v))
        mat = make_material(color=tuple(base[b]), roughness=float(rng.uniform(0.3, 0.9)))
        hs.add_mesh(Mesh(
            vertices=verts.reshape(-1, 3).astype(np.float32),
            indices=faces.reshape(-1, 3).astype(np.int32),
            material=mat,
        ))
    return hs


BIG8X_TERRAIN_GRID = (2048, 2048)  # build_big_scene at ~8.68M triangles,
#   4239 entries at cluster_size 256: the scale point where hier=None takes
#   the node walk (experiments/flat_scale_probe.py "big8x-8.7M")


def build_big_scene(n_boxes=12500, seed=0, terrain_grid=(1024, 512), extra_rings=2) -> HostScene:
    """bench.py `build_big_scene`: the city plus a finely tessellated
    multi-octave terrain apron (unique geometry, no instancing) and
    `extra_rings` suburb rings of smaller boxes. Default ~1.35M triangles;
    BIG8X_TERRAIN_GRID gives ~8.68M."""
    rng = np.random.default_rng(seed + 100)
    hs = build_city_scene(n_boxes=n_boxes, seed=seed)

    # fine terrain apron around the city (which sits on its own ground slab)
    gx, gz = terrain_grid
    xs = np.linspace(-220, 220, gx, dtype=np.float32)
    zs = np.linspace(-220, 220, gz, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs, indexing="ij")
    h = np.zeros_like(xg)
    for octave in range(5):
        f = 0.012 * (2 ** octave)
        px = rng.uniform(0, 100)
        pz = rng.uniform(0, 100)
        h += (np.sin(xg * f + px) * np.cos(zg * f * 1.6 + pz)) * (3.0 / (octave + 1))
    # depress the terrain under the city footprint (|x|, |z| < 62)
    inside = (np.abs(xg) < 62) & (np.abs(zg) < 62)
    h = np.where(inside, -2.5, h - 3.0).astype(np.float32)
    verts = np.stack([xg, h, zg], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(gx - 1), np.arange(gz - 1), indexing="ij")
    q = (ii * gz + jj).ravel()
    quads = np.stack([q, q + 1, q + gz, q + gz + 1], -1)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [2, 1, 3]]], 0).astype(np.int32)
    hs.add_mesh(Mesh(vertices=verts, indices=tris,
                     material=make_material(color=(0.4, 0.45, 0.3), roughness=0.85)))

    # suburb rings: unique small boxes on the terrain apron
    unit_v, unit_f = _unit_box()
    for ring in range(extra_rings):
        k = n_boxes // 2
        r0, r1 = 70 + 60 * ring, 120 + 60 * ring
        rad = rng.uniform(r0, r1, k).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
        cx = rad * np.cos(ang)
        cz = rad * np.sin(ang)
        hh = rng.gamma(2.0, 0.6, k).astype(np.float32) + 0.2
        ww = rng.uniform(0.15, 0.6, (k, 2)).astype(np.float32)
        # ground height via nearest grid sample
        gix = np.clip(np.rint((cx - xs[0]) / (xs[1] - xs[0])).astype(np.int64), 0, gx - 1)
        giz = np.clip(np.rint((cz - zs[0]) / (zs[1] - zs[0])).astype(np.int64), 0, gz - 1)
        base_y = h[gix, giz]
        scale = np.stack([ww[:, 0], hh * 0.5, ww[:, 1]], -1)
        offset = np.stack([cx, base_y + hh * 0.5, cz], -1)
        verts = unit_v[None] * scale[:, None, :] + offset[:, None, :]
        faces = unit_f[None] + (np.arange(k)[:, None, None] * len(unit_v))
        hs.add_mesh(Mesh(
            vertices=verts.reshape(-1, 3).astype(np.float32),
            indices=faces.reshape(-1, 3).astype(np.int32),
            material=make_material(color=(0.55 + 0.1 * ring, 0.5, 0.45), roughness=0.7),
        ))
    return hs


def city_camera(width: int, height: int) -> Camera:
    """The bench's city camera (bench.py main)."""
    return Camera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0),
                  fov_y=45, aspect_ratio=width / height)


def city_sky(device):
    """The bench's sky probe with a sun."""
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    return build_probe(sky, device)


def sky_probe(device):
    """tests/golden_scenes.py `_sky_probe`."""
    sky = np.full((32, 64, 3), 0.35, np.float32)
    sky[4:7, 12:16] = (40.0, 36.0, 30.0)  # sun block
    sky[20:, :] = 0.08  # dark ground hemisphere
    return build_probe(sky, device)


def open_scene() -> HostScene:
    """tests/golden_scenes.py `_open_scene`: ground, three boxes, one glass."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
    hs.add_box(make_material(color=(0.7, 0.25, 0.2), roughness=0.4), pos=(-0.9, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(make_material(color=(0.9, 0.8, 0.25), metallic=1.0, roughness=0.15), pos=(0.9, 0.4, 0.3), extent=(0.4, 0.4, 0.4))
    hs.add_box(make_material(color=(0.9, 0.9, 0.9), transmission=1.0, eta=1.5), pos=(0.0, 0.45, 1.3), extent=(0.35, 0.45, 0.35))
    return hs


def open_camera(width: int, height: int) -> Camera:
    """tests/golden_scenes.py `_cam`/`_cam_s` for the open scene."""
    return Camera(eye=(3.2, 2.2, 4.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                  aspect_ratio=width / height)


# golden name -> (width, height, spp, max_depth, frames)
OPEN_GOLDENS = {
    "disney_open_s": (48, 32, 2, 2, 1),
    "disney_open": (96, 64, 4, 3, 2),
}


def render_open_golden(name: str, device) -> np.ndarray:
    """Render a `disney_open*` golden setup; returns the (H, W, 3) accum image."""
    w, h, spp, depth, frames = OPEN_GOLDENS[name]
    cs = compile_scene(open_scene(), device)
    cfg = RenderConfig(width=w, height=h, samples_per_launch=spp, max_depth=depth,
                       traversal="cluster")
    r = Renderer(cs, sky_probe(device), cfg, open_camera(w, h))
    r.render_n(frames)
    return r.accum_image()


# golden name -> (width, height, max_depth, frames, (inner, outer) radius)
FOVEATED_GOLDENS = {
    "foveated_s": (48, 32, 1, 1, (8, 16)),
    "foveated": (96, 64, 2, 2, (157, 515)),
}


def render_foveated_golden(name: str, device) -> np.ndarray:
    """Render a `foveated*` golden setup (tests/golden_scenes.py
    `render_foveated_small` / `render_foveated`: the open scene, 1 spp
    config, gaze at the centre); returns the (H, W, 3) accum image."""
    w, h, depth, frames, (inner, outer) = FOVEATED_GOLDENS[name]
    cs = compile_scene(open_scene(), device)
    cfg = RenderConfig(width=w, height=h, samples_per_launch=1, max_depth=depth,
                       traversal="cluster")
    r = FoveatedRenderer(cs, sky_probe(device), cfg, open_camera(w, h),
                         FoveationConfig(inner_radius=inner, outer_radius=outer))
    for _ in range(frames):
        r.render()
    return r.accum_image()


def dark_probe(device) -> Probe:
    """The closed rooms' 1e-6 probe: lit by their emitters, not the sky
    (bench.py `--scene loft`, tests/golden_scenes.py)."""
    return build_probe(np.full((8, 16, 3), 1e-6, np.float32), device)


def cornell_scene() -> HostScene:
    """tests/golden_scenes.py `_cornell_scene`: a closed box, two blocks and
    an emissive slab under the ceiling (96 triangles)."""
    hs = HostScene()
    e = 1.5
    hs.add_box(make_material(color=(0.73, 0.73, 0.73)), pos=(0, -0.05, 0), extent=(e, 0.05, e))  # floor
    hs.add_box(make_material(color=(0.73, 0.73, 0.73)), pos=(0, 2 * e + 0.05, 0), extent=(e, 0.05, e))  # ceiling
    hs.add_box(make_material(color=(0.65, 0.05, 0.05)), pos=(-e - 0.05, e, 0), extent=(0.05, e, e))  # red left
    hs.add_box(make_material(color=(0.12, 0.45, 0.15)), pos=(e + 0.05, e, 0), extent=(0.05, e, e))  # green right
    hs.add_box(make_material(color=(0.73, 0.73, 0.73)), pos=(0, e, -e - 0.05), extent=(e, e, 0.05))  # back
    hs.add_box(make_material(color=(0.73, 0.73, 0.73), roughness=0.5), pos=(-0.5, 0.6, -0.4), extent=(0.35, 0.6, 0.35))
    hs.add_box(make_material(color=(0.73, 0.73, 0.73), metallic=1.0, roughness=0.1), pos=(0.55, 0.35, 0.35), extent=(0.35, 0.35, 0.35))
    # emissive quad light geometry near the ceiling
    hs.add_box(make_material(color=(0, 0, 0), emission=(15.0, 13.0, 10.0)), pos=(0, 2 * e - 0.02, 0), extent=(0.5, 0.02, 0.5))
    return hs


def cornell_light(device) -> QuadLight:
    """The cornell golden's parallelogram light, the slab's underside."""
    return QuadLight.make(corner=(-0.5, 2.96, -0.5), v1=(1.0, 0, 0), v2=(0, 0, 1.0),
                          emission=(15.0, 13.0, 10.0), device=device)


def cornell_camera(width: int, height: int) -> Camera:
    return Camera(eye=(0, 1.5, 5.6), lookat=(0, 1.4, 0), up=(0, 1, 0), fov_y=45,
                  aspect_ratio=width / height)


def loft_camera(width: int, height: int, fov_y: float = 45) -> Camera:
    """The loft's view: fov 45 in the goldens, 55 in bench.py."""
    return Camera(eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0), fov_y=fov_y,
                  aspect_ratio=width / height)


class SceneSetup(NamedTuple):
    camera: Camera
    probe: Probe
    flags: dict  # RenderConfig fields beyond size, spp and depth


def loft_config(width: int, height: int, device) -> SceneSetup:
    """bench.py `--scene loft` (bench.py:1258-1300): the loft camera at fov
    55, the 1e-6 probe, and the city slice's flags plus emitter lighting
    through BSDF paths and shading normals."""
    return SceneSetup(loft_camera(width, height, fov_y=55), dark_probe(device),
                      dict(sort_rays=True, batch_spp=True, nee_final_bounce=False,
                           emission_all_bounces=True, use_shading_normals=True))


# golden name -> (width, height, spp, max_depth, frames)
CORNELL_GOLDENS = {
    "disney_cornell_s": (48, 32, 2, 2, 1),
    "disney_cornell": (96, 64, 4, 3, 2),
}
LOFT_GOLDENS = {
    "loft_s": (48, 32, 2, 2, 1),
    "loft": (96, 64, 4, 3, 2),
}


def render_cornell_golden(name: str, device) -> np.ndarray:
    """Render a `disney_cornell*` golden setup: the cornell scene under its
    quad light with emission on every bounce."""
    w, h, spp, depth, frames = CORNELL_GOLDENS[name]
    cfg = RenderConfig(width=w, height=h, samples_per_launch=spp, max_depth=depth,
                       traversal="cluster", emission_all_bounces=True)
    r = Renderer(compile_scene(cornell_scene(), device), dark_probe(device), cfg,
                 cornell_camera(w, h), area_light=cornell_light(device))
    r.render_n(frames)
    return r.accum_image()


def render_loft_golden(name: str, device) -> np.ndarray:
    """Render a `loft*` golden setup: scenes/loft.obj, textured, lit by its
    emissive panels, shading normals on."""
    w, h, spp, depth, frames = LOFT_GOLDENS[name]
    cfg = RenderConfig(width=w, height=h, samples_per_launch=spp, max_depth=depth,
                       traversal="cluster", emission_all_bounces=True, use_shading_normals=True)
    r = Renderer(compile_scene(load_obj(LOFT_OBJ), device), dark_probe(device), cfg,
                 loft_camera(w, h))
    r.render_n(frames)
    return r.accum_image()


def golden_glb() -> bytes:
    """The `gltf` golden's .glb (tests/golden_scenes.py `render_gltf`): one
    quad mesh referenced by two nodes with different transforms."""
    pos = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    bin_pos = pos.tobytes()
    blob = bin_pos + idx.tobytes() + b"\x00\x00"  # indices padded to 4
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0},
            {"mesh": 0, "translation": [0.0, 1.0, 0.0], "scale": [0.5, 0.5, 0.5]},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 1}, "indices": 0, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.3, 0.2, 1.0], "metallicFactor": 0.0, "roughnessFactor": 0.6}}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": len(bin_pos), "byteLength": 12},
            {"buffer": 0, "byteOffset": 0, "byteLength": len(bin_pos)},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
        ],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    return (struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(blob))
            + struct.pack("<I4s", len(js), b"JSON") + js
            + struct.pack("<I4s", len(blob), b"BIN\x00") + blob)


def render_gltf_golden(device) -> np.ndarray:
    """Render the `gltf` golden: `golden_glb` loaded from a file, 96x64,
    2 spp, depth 2, 2 frames under the open scene's sky."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "golden.glb")
        with open(path, "wb") as f:
            f.write(golden_glb())
        hs, _lights = load_gltf(path)
    cfg = RenderConfig(width=96, height=64, samples_per_launch=2, max_depth=2, traversal="cluster")
    r = Renderer(compile_scene(hs, device), sky_probe(device), cfg,
                 Camera(eye=(3.0, 2.5, 3.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                        aspect_ratio=96 / 64))
    r.render_n(2)
    return r.accum_image()


def golden_rmse(got: np.ndarray, want: np.ndarray) -> float:
    """tests/test_goldens.py metric: RMSE in sqrt (tone-mapped) space."""
    a = np.sqrt(np.clip(np.asarray(got, np.float32), 0, None))
    b = np.sqrt(np.clip(np.asarray(want, np.float32), 0, None))
    return float(np.sqrt(np.mean((a - b) ** 2)))
