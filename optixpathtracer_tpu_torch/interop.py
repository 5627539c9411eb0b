"""State carried across from the JAX package: its CompiledScene (texture
pool included), Probe and QuadLight as plain numpy arrays, turned into the
port's structures.

`compiled_scene_arrays` / `probe_arrays` / `quad_light_arrays` read the
reference's objects attribute by attribute with `np.asarray` (this module
imports no jax; the caller holds the JAX objects). The `*_from_arrays`
functions rebuild the port's `CompiledScene`, `Probe` and `QuadLight` on a
device. The round trip moves identical bits, so both packages can be fed
the same scene state.
"""
from __future__ import annotations

import numpy as np
import torch

from .builder import CompiledScene
from .bvh.clusters import cluster_set_from_numpy
from .core.materials import table_from_rows
from .core.math import Vec3
from .core.scene import TexturePool, scene_from_shade_rows
from .lights.lights import QuadLight
from .lights.probe import Probe, probe_from_tables

_CLUSTER_FIELDS = ("rows", "spheres", "super_spheres", "scene_aabb", "entry_row",
                   "entry_xf", "xf_inv", "xf_fwd", "xf_invt")
_PROBE_FIELDS = ("r", "g", "b", "pdf_x", "cdf_x", "pdf_y", "cdf_y", "rgbp")
_QUAD_FIELDS = ("corner", "v1", "v2", "emission", "normal")


def compiled_scene_arrays(cs) -> dict[str, np.ndarray]:
    """A (reference or port) CompiledScene as a dict of numpy arrays."""
    cl = cs.clusters
    if cl is None or cl.instanced:
        raise NotImplementedError("only non-instanced cluster scenes carry across (ROADMAP A.9)")
    out = {f"clusters.{k}": _np(getattr(cl, k)) for k in _CLUSTER_FIELDS}
    if cl.tri_map is not None:
        out["clusters.tri_map"] = _np(cl.tri_map)
    out["clusters.cluster_size"] = np.asarray(cl.cluster_size)
    out["scene.shade_rows"] = _np(cs.scene.shade_rows)
    out["scene.materials.rows"] = _np(cs.scene.materials.rows)
    pool = getattr(cs.scene, "textures", None)  # a bare cluster set's view has none
    if pool is not None:
        out.update({f"scene.textures.{k}": _np(v) for k, v in pool._asdict().items()})
    out["num_triangles"] = np.asarray(cs.num_triangles)
    return out


def compiled_scene_from_arrays(arrays: dict[str, np.ndarray], device) -> CompiledScene:
    """The port's CompiledScene on `device` from `compiled_scene_arrays`."""
    tables = {k.split(".", 1)[1]: v for k, v in arrays.items() if k.startswith("clusters.")}
    c = int(tables.pop("cluster_size"))
    clusters = cluster_set_from_numpy(tables, c, device)
    materials = table_from_rows(arrays["scene.materials.rows"], device)
    textures = None  # arrays without a pool rebuild with the empty one
    if "scene.textures.r" in arrays:
        textures = TexturePool(**{
            k: torch.as_tensor(np.array(arrays[f"scene.textures.{k}"]), device=device)
            for k in TexturePool._fields})
    scene = scene_from_shade_rows(arrays["scene.shade_rows"], materials, device, textures)
    return CompiledScene(scene=scene, bvh=None, num_triangles=int(arrays["num_triangles"]),
                         wide=None, clusters=clusters)


def probe_arrays(p) -> dict[str, np.ndarray]:
    """A (reference or port) Probe as a dict of numpy arrays."""
    out = {k: _np(getattr(p, k)) for k in _PROBE_FIELDS}
    out["offset"] = np.array([float(_np(c)) for c in p.offset], np.float32)
    return out


def probe_from_arrays(arrays: dict[str, np.ndarray], device) -> Probe:
    """The port's Probe on `device` from `probe_arrays`."""
    t = {k: torch.as_tensor(np.array(arrays[k], np.float32), device=device)
         for k in _PROBE_FIELDS}
    return probe_from_tables(t["r"], t["g"], t["b"], t["pdf_x"], t["cdf_x"], t["pdf_y"],
                             t["cdf_y"], arrays["offset"], t["rgbp"])


def quad_light_arrays(light) -> dict[str, np.ndarray]:
    """A (reference or port) QuadLight as a dict of numpy arrays: (3,)
    float32 vectors and the float32 `area`."""
    out = {k: np.array([float(_np(c)) for c in getattr(light, k)], np.float32)
           for k in _QUAD_FIELDS}
    out["area"] = np.float32(_np(light.area))
    return out


def quad_light_from_arrays(arrays: dict[str, np.ndarray], device) -> QuadLight:
    """The port's QuadLight on `device` from `quad_light_arrays`."""
    return QuadLight(*(Vec3.of(*(float(c) for c in arrays[k]), device=device) for k in _QUAD_FIELDS),
                     area=torch.tensor(float(arrays["area"]), dtype=torch.float32, device=device))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
