"""Scene compilation: host meshes -> (device SceneData, ClusterSet).

Port of optixpathtracer_tpu/builder.py `compile_scene`, cluster path only:
the LBVH Morton order orders the shading soup, a treelet repacking orders
the clusters, and `tri_map` translates cluster slots back to scene
triangles. `bvh` and `wide` (the lockstep and BFS backends) are None: the
port does not carry those backends (ROADMAP "not to port").
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .bvh.clusters import ClusterSet, build_clusters, treelet_order
from .bvh.lbvh import build_bvh
from .core.scene import HostScene, SceneData, device_scene_from_sorted


class CompiledScene(NamedTuple):
    scene: SceneData
    bvh: None  # the lockstep backend is not ported
    num_triangles: int  # real (unpadded) triangle count
    wide: None = None  # the BFS backend is not ported
    clusters: Optional[ClusterSet] = None

    @property
    def device(self) -> torch.device:
        return self.scene.shade_rows.device


def compile_scene(
    host: HostScene,
    device,
    leaf_size: int = 4,
    cluster_size: int = 128,
) -> CompiledScene:
    """Build the shading soup and the cluster structure on `device`."""
    flat = host.flatten()
    v0, v1, v2 = flat["v"]
    res = build_bvh(v0, v1, v2, leaf_size=leaf_size)
    scene = device_scene_from_sorted(flat, res.order, res.padded_count, device)
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
    return CompiledScene(scene=scene, bvh=None, num_triangles=len(v0),
                         wide=None, clusters=clusters)
