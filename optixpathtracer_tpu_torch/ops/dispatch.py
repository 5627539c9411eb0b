"""Trace entry points the presets call (port of
optixpathtracer_tpu/ops/dispatch.py).

The port carries one traversal backend, the cluster walk
(`ops/traverse_cluster`, kernels K1-K4 on the card), so `traversal` is
"cluster" or None. The reference's platform switch (the lockstep walk on a
CPU) does not apply; "lockstep", "bfs" and "dense" raise, as
`engine/wavefront._check_supported` does.
"""
from __future__ import annotations

from ..core.math import Vec3
from .traverse_cluster import HitRecord, any_hit_cluster, closest_hit_cluster


def default_traversal(cs) -> str:
    """The port's one exact backend, on every device."""
    return "cluster"


def _check(traversal: str | None) -> None:
    if traversal not in (None, "cluster"):
        raise NotImplementedError(
            f"traversal={traversal!r} is not ported (ROADMAP A 'not to port'): the port "
            "carries only the cluster walk")


def trace_closest(cs, o: Vec3, d: Vec3, t_min=1e-3, t_max=1e16,
                  traversal: str | None = None) -> HitRecord:
    """Closest hit over the scene's cluster walk (optixTrace role)."""
    _check(traversal)
    return closest_hit_cluster(cs.clusters, o, d, t_min, t_max)


def trace_occluded(cs, o: Vec3, d: Vec3, t_min=1e-2, t_max=1e16,
                   traversal: str | None = None):
    """Terminate-on-first-hit occlusion over the cluster walk: (N,) bool."""
    _check(traversal)
    return any_hit_cluster(cs.clusters, o, d, t_min, t_max)[0]
