"""Backend-dispatching trace entry points (port of
optixpathtracer_tpu/ops/dispatch.py): every preset that needs a
closest-hit or occlusion query calls these instead of binding a backend.

`traversal` is "cluster" (the cluster walk, kernels K1-K4 on the card),
"lockstep" (ops/traverse.py over `cs.bvh`), "bfs" (ops/traverse_bfs.py over
`cs.wide`), "dense" (ops/dense.py over `cs.wide`), "oracle" (the dense
no-cull scan over the clusters, `reference_closest`), or None for the
device's default: the cluster walk on a CUDA device (the reference's rule
for an accelerator) and the lockstep walk on a CPU. `default_backend`
replaces that default within a scope (the presets that take no traversal,
hello and whitted, rendered on a chosen walk).
"""
from __future__ import annotations

import contextlib

from ..core.math import Vec3
from .dense import any_hit_dense, closest_hit_dense
from .traverse import any_hit, closest_hit
from .traverse_bfs import any_hit_bfs, closest_hit_bfs
from .traverse_cluster import HitRecord, any_hit_cluster, closest_hit_cluster, reference_closest


_scoped: list = []


@contextlib.contextmanager
def default_backend(traversal: str):
    """Within the block, `traversal=None` means `traversal`."""
    _scoped.append(traversal)
    try:
        yield
    finally:
        _scoped.pop()


def default_traversal(cs) -> str:
    """The device's exact backend for a CompiledScene."""
    if _scoped:
        return _scoped[-1]
    if cs.device.type == "cuda" and getattr(cs, "clusters", None) is not None:
        return "cluster"
    return "lockstep"


def trace_closest(cs, o: Vec3, d: Vec3, t_min=1e-3, t_max=1e16,
                  traversal: str | None = None) -> HitRecord:
    """Closest hit on the chosen backend (optixTrace role)."""
    tr = traversal or default_traversal(cs)
    if tr == "cluster":
        return closest_hit_cluster(cs.clusters, o, d, t_min, t_max)
    if tr == "oracle":
        return reference_closest(cs.clusters, o, d, t_min, t_max)
    if tr == "bfs":
        return closest_hit_bfs(cs.wide, o, d, t_min, t_max).record
    if tr == "dense":
        return closest_hit_dense(cs.wide, o, d, t_min, t_max)
    return closest_hit(cs.bvh, cs.scene, o, d, t_min, t_max)


def trace_occluded(cs, o: Vec3, d: Vec3, t_min=1e-2, t_max=1e16,
                   traversal: str | None = None):
    """Terminate-on-first-hit occlusion on the chosen backend: (N,) bool."""
    tr = traversal or default_traversal(cs)
    if tr == "cluster":
        return any_hit_cluster(cs.clusters, o, d, t_min, t_max)[0]
    if tr == "oracle":
        return reference_closest(cs.clusters, o, d, t_min, t_max).hit
    if tr == "bfs":
        return any_hit_bfs(cs.wide, o, d, t_min, t_max)[0]
    if tr == "dense":
        return any_hit_dense(cs.wide, o, d, t_min, t_max)
    return any_hit(cs.bvh, cs.scene, o, d, t_min, t_max)
