"""State carried across from the JAX package: its CompiledScene (texture
pool included), Probe and QuadLight as plain numpy arrays, turned into the
port's structures.

`compiled_scene_arrays` / `probe_arrays` / `quad_light_arrays` read the
reference's objects attribute by attribute with `np.asarray` (this module
imports no jax; the caller holds the JAX objects). The `*_from_arrays`
functions rebuild the port's `CompiledScene`, `Probe` and `QuadLight` on a
device. The round trip moves identical bits, so both packages can be fed
the same scene state; a scene's LBVH and wide BVH (the lockstep, BFS and
dense backends' structures) carry across where it has them. Instanced and TLAS scenes carry their `instanced`
flag (their scene arrays are in slot order: no `tri_map`), and
`proto_tables` carries a TLAS compile's per-prototype host tables for
`bvh.clusters.update_tlas_transforms`. `demand_pool_arrays` /
`demand_pool_from_arrays` carry a demand-loaded texture pool (io/demand):
its tile rows, page table and layout tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .builder import CompiledScene
from .bvh.clusters import cluster_set_from_numpy
from .bvh.lbvh import BVH
from .bvh.wide import WideBVH
from .core.materials import table_from_rows
from .core.math import Vec3
from .core.scene import TexturePool, scene_from_shade_rows
from .io.demand import DemandTexturePool
from .lights.lights import QuadLight
from .lights.probe import Probe, probe_from_tables

_CLUSTER_FIELDS = ("rows", "spheres", "super_spheres", "scene_aabb", "entry_row",
                   "entry_xf", "xf_inv", "xf_fwd", "xf_invt")
_PROBE_FIELDS = ("r", "g", "b", "pdf_x", "cdf_x", "pdf_y", "cdf_y", "rgbp")
_QUAD_FIELDS = ("corner", "v1", "v2", "emission", "normal")
_PROTO_FIELDS = ("rows", "spheres", "super_spheres", "scene_aabb", "local_aabb")
_BVH_BOXES = ("left_min", "left_max", "right_min", "right_max")
_WIDE_FIELDS = ("table", "leaf_rows", "leaf_tri0")
_WIDE_META = ("width", "leaf_size", "depth", "compressed")


def compiled_scene_arrays(cs) -> dict[str, np.ndarray]:
    """A (reference or port) CompiledScene as a dict of numpy arrays."""
    cl = cs.clusters
    if cl is None:
        raise ValueError("only cluster scenes carry across")
    out = {f"clusters.{k}": _np(getattr(cl, k)) for k in _CLUSTER_FIELDS}
    if cl.tri_map is not None:
        out["clusters.tri_map"] = _np(cl.tri_map)
    out["clusters.cluster_size"] = np.asarray(cl.cluster_size)
    out["clusters.instanced"] = np.asarray(bool(cl.instanced))
    out["scene.shade_rows"] = _np(cs.scene.shade_rows)
    out["scene.materials.rows"] = _np(cs.scene.materials.rows)
    pool = getattr(cs.scene, "textures", None)  # a bare cluster set's view has none
    if pool is not None:
        out.update({f"scene.textures.{k}": _np(v) for k, v in pool._asdict().items()})
    out["num_triangles"] = np.asarray(cs.num_triangles)
    bvh, wide = getattr(cs, "bvh", None), getattr(cs, "wide", None)  # a bare cluster set has neither
    if bvh is not None:
        out["bvh.child_left"] = _np(bvh.child_left)
        out["bvh.child_right"] = _np(bvh.child_right)
        out.update({f"bvh.{k}": np.stack([_np(c) for c in getattr(bvh, k)], 1) for k in _BVH_BOXES})
        out["bvh.leaf_size"] = np.asarray(bvh.leaf_size)
    if wide is not None:
        out.update({f"wide.{k}": _np(getattr(wide, k)) for k in _WIDE_FIELDS})
        out.update({f"wide.{k}": np.asarray(getattr(wide, k)) for k in _WIDE_META})
    return out


def compiled_scene_from_arrays(arrays: dict[str, np.ndarray], device) -> CompiledScene:
    """The port's CompiledScene on `device` from `compiled_scene_arrays`."""
    tables = {k.split(".", 1)[1]: v for k, v in arrays.items() if k.startswith("clusters.")}
    c = int(tables.pop("cluster_size"))
    instanced = bool(tables.pop("instanced", False))
    clusters = cluster_set_from_numpy(tables, c, device, instanced=instanced)
    materials = table_from_rows(arrays["scene.materials.rows"], device)
    textures = None  # arrays without a pool rebuild with the empty one
    if "scene.textures.r" in arrays:
        textures = TexturePool(**{
            k: torch.as_tensor(np.array(arrays[f"scene.textures.{k}"]), device=device)
            for k in TexturePool._fields})
    scene = scene_from_shade_rows(arrays["scene.shade_rows"], materials, device, textures)

    def up(a):
        return torch.as_tensor(np.array(a), device=device)

    bvh = wide = None
    if "bvh.child_left" in arrays:
        bvh = BVH(child_left=up(arrays["bvh.child_left"]), child_right=up(arrays["bvh.child_right"]),
                  **{k: Vec3(*(up(arrays[f"bvh.{k}"][:, i]) for i in range(3))) for k in _BVH_BOXES},
                  leaf_size=int(arrays["bvh.leaf_size"]))
    if "wide.table" in arrays:
        wide = WideBVH(**{k: up(arrays[f"wide.{k}"]) for k in _WIDE_FIELDS},
                       width=int(arrays["wide.width"]), leaf_size=int(arrays["wide.leaf_size"]),
                       depth=int(arrays["wide.depth"]), compressed=bool(arrays["wide.compressed"]))
    return CompiledScene(scene=scene, bvh=bvh, num_triangles=int(arrays["num_triangles"]),
                         wide=wide, clusters=clusters)


def proto_tables(tables: list) -> list[dict[str, np.ndarray]]:
    """The per-prototype host tables of a (reference or port)
    `compile_tlas(..., return_tables=True)`, as the port's
    `update_tlas_transforms` reads them."""
    return [{k: np.array(tb[k]) for k in _PROTO_FIELDS} for tb in tables]


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


def demand_pool_arrays(pool) -> dict[str, np.ndarray]:
    """A (reference or port) DemandTexturePool as a dict of numpy arrays."""
    return {k: _np(getattr(pool, k)) for k in DemandTexturePool._fields}


def demand_pool_from_arrays(arrays: dict[str, np.ndarray], device) -> DemandTexturePool:
    """The port's DemandTexturePool on `device` from `demand_pool_arrays`."""
    return DemandTexturePool(**{k: torch.as_tensor(np.array(arrays[k]), device=device)
                                for k in DemandTexturePool._fields})


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
