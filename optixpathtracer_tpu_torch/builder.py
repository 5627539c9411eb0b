"""Scene compilation: host meshes -> (device SceneData, acceleration
structures). Port of optixpathtracer_tpu/builder.py.

Three structures serve the traversal backends (ops/):
  bvh      — binary LBVH for the lockstep walk (ops/traverse.py)
  wide     — W-wide collapsed BVH for the BFS walk and the dense scan
  clusters — treelet clusters for the cluster walk (kernels K1-K4)
All three index the same Morton-sorted triangle order of the shading soup:
the clusters use their own treelet order with `tri_map` translating slots
back, so HitRecord.tri is interchangeable across backends.
`compile_instanced` / `compile_tlas`: each prototype is stored once in
local space, in treelet order and padded with its last triangle to the
SUPER * cluster_size slot granule; the scene arrays are in slot order, so
there is no `tri_map`, and `engine/wavefront._hit_geometry` resolves a
hit's entry slot to (triangle, instance). Instanced scenes carry only the
cluster structure (`bvh` and `wide` are None), as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .bvh.clusters import (
    SUPER,
    ClusterSet,
    _cluster_tables,
    build_clusters,
    build_instanced_clusters,
    build_tlas_clusters,
    treelet_order,
)
from .bvh.lbvh import BVH, build_bvh
from .bvh.wide import WideBVH, build_wide
from .core.scene import HostScene, SceneData, device_scene_from_sorted


class CompiledScene(NamedTuple):
    scene: SceneData
    bvh: Optional[BVH]  # None for instanced scenes (cluster walk only)
    num_triangles: int  # real (unpadded) triangle count
    wide: Optional[WideBVH] = None  # the BFS walk's and dense scan's structure
    clusters: Optional[ClusterSet] = None

    @property
    def device(self) -> torch.device:
        return self.scene.shade_rows.device


def compile_scene(
    host: HostScene,
    device,
    leaf_size: int = 4,
    wide_width: int = 8,
    build_wide_bvh: bool = True,
    compressed_nodes: bool = False,
    build_cluster_set: bool = True,
    cluster_size: int = 128,
) -> CompiledScene:
    """Build the shading soup and the acceleration structures on `device`,
    with the reference's parameters and defaults: the LBVH always, the wide
    BVH unless `build_wide_bvh=False`, the clusters unless
    `build_cluster_set=False`."""
    flat = host.flatten()
    v0, v1, v2 = flat["v"]
    res = build_bvh(v0, v1, v2, leaf_size=leaf_size, device=device)
    scene = device_scene_from_sorted(flat, res.order, res.padded_count, device)

    wide = None
    if build_wide_bvh:
        h = res.host
        wide = build_wide(
            h["left"], h["right"], h["lmin"], h["lmax"], h["rmin"], h["rmax"],
            np.asarray(v0)[res.order], np.asarray(v1)[res.order], np.asarray(v2)[res.order],
            leaf_size=leaf_size, device=device, width=wide_width, compressed=compressed_nodes,
        )

    clusters = None
    if build_cluster_set:
        # centroids are per triangle, so compute them unsorted and gather once
        ctr = v0.astype(np.float64)
        ctr += v1
        ctr += v2
        ctr /= 3.0
        tp = treelet_order(ctr[res.order], cluster_size)
        tri_map = res.order[tp]
        clusters = build_clusters(
            v0[tri_map], v1[tri_map], v2[tri_map], num_real=res.padded_count,
            device=device, cluster_size=cluster_size, tri_map=tp,
        )
    return CompiledScene(scene=scene, bvh=res.bvh, num_triangles=len(v0), wide=wide,
                         clusters=clusters)


def _slot_order(ctr: np.ndarray, ids: np.ndarray, cluster_size: int) -> tuple[np.ndarray, int]:
    """Treelet order of the triangles `ids` (centroids `ctr`), padded with
    its last triangle to whole SUPER * cluster_size slot blocks (a duplicate
    yields identical hits, never wrong ones). Returns (order, padded count)."""
    slot = SUPER * int(cluster_size)
    t = len(ids)
    pad_to = max(slot, -(-t // slot) * slot)
    order = ids[treelet_order(ctr, cluster_size)]
    if pad_to > t:
        order = np.concatenate([order, np.repeat(order[-1:], pad_to - t)])
    return order, pad_to


def compile_instanced(host: HostScene, transforms: np.ndarray, device,
                      cluster_size: int = 128) -> CompiledScene:
    """One prototype (all of `host`), stored once in local space, under the
    (I, 4, 4) local->world `transforms`. Move the instances later with
    `bvh.clusters.update_instance_transforms` (no geometry rebuild)."""
    flat = host.flatten()
    v0, v1, v2 = flat["v"]
    t = len(v0)
    ctr = (np.asarray(v0, np.float64) + v1 + v2) / 3.0
    order, pad_to = _slot_order(ctr, np.arange(t), cluster_size)
    scene = device_scene_from_sorted(flat, order, pad_to, device)
    clusters = build_instanced_clusters(
        np.asarray(v0)[order], np.asarray(v1)[order], np.asarray(v2)[order], num_real=pad_to,
        transforms=np.asarray(transforms), device=device, cluster_size=cluster_size)
    return CompiledScene(scene=scene, bvh=None, num_triangles=t * len(np.asarray(transforms)),
                         wide=None, clusters=clusters)


def compile_tlas(host: HostScene, groups: list, instances: list, device,
                 cluster_size: int = 128, return_tables: bool = False):
    """Several prototypes under one TLAS. `host` holds every prototype's
    meshes (one material and texture table); `groups` lists each
    prototype's `host.meshes` indices; `instances` are (prototype,
    (4, 4) local->world) pairs. The scene's slots are the prototypes'
    padded slot ranges end to end. With return_tables=True also returns
    the prototypes' local tables, for `bvh.clusters.update_tlas_transforms`."""
    flat = host.flatten()
    v0, v1, v2 = (np.asarray(flat["v"][k]) for k in range(3))
    counts = [len(np.asarray(m.indices).reshape(-1, 3)) for m in host.meshes]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    orders, tables, real_counts = [], [], []
    for meshes in groups:
        gids = np.concatenate([np.arange(starts[mi], starts[mi + 1]) for mi in meshes])
        if len(gids) == 0:
            raise ValueError("empty prototype group")
        ctr = (v0[gids].astype(np.float64) + v1[gids] + v2[gids]) / 3.0
        op, pad_to = _slot_order(ctr, gids, cluster_size)
        orders.append(op)
        real_counts.append(len(gids))
        tables.append(_cluster_tables(v0[op], v1[op], v2[op], pad_to, cluster_size))

    order = np.concatenate(orders)
    scene = device_scene_from_sorted(flat, order, len(order), device)
    inst_proto = np.asarray([p for p, _ in instances], np.int64)
    xfs = np.stack([np.asarray(m, np.float64) for _, m in instances])
    clusters = build_tlas_clusters(tables, inst_proto, xfs, device, cluster_size=cluster_size)
    cs = CompiledScene(scene=scene, bvh=None,
                       num_triangles=int(sum(real_counts[p] for p in inst_proto)),
                       wide=None, clusters=clusters)
    return (cs, tables) if return_tables else cs
