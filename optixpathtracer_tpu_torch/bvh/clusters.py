"""Triangle clusters — the acceleration structure of the cluster traversal
(port of optixpathtracer_tpu/bvh/clusters.py, non-instanced path).

CLUSTER: C consecutive triangles of the treelet order, stored pre-differenced
as rows [v0 | e1 | e2] with an AABB (center, half extent) and a bounding
sphere. SUPERCLUSTER: SUPER consecutive clusters, the unit the per-block
cull sorts and the sweep walks ("entries"). The host build is the
reference's numpy code, so every table is bit-identical to the JAX build's
numpy path. Instancing and the TLAS wait for ROADMAP A.9.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

Tensor = torch.Tensor

STORE_ROWS = 16  # storage rows (the JAX layout pads 9 rows to 16)
SUPER = 8  # clusters per supercluster


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Device-resident two-level cluster structure (all tensors on one device)."""

    rows: Tensor  # (S, 16, SUPER*C) f32 triangle rows [v0 | e1 | e2 | pad]
    spheres: Tensor  # (E*SUPER, 8) f32 per-member [cx cy cz r hx hy hz 0]
    super_spheres: Tensor  # (E, 8) f32 per-entry bounds
    scene_aabb: Tensor  # (8,) f32 [lox loy loz hix hiy hiz 0 0]
    entry_row: Tensor  # (E,) i32 rows index of each entry
    entry_xf: Tensor  # (E,) i32 transform id of each entry
    xf_inv: Tensor  # (I, 16) f32 world->local [A row-major 9 | b 3 | pad]
    xf_fwd: Tensor  # (I, 16) f32 local->world
    xf_invt: Tensor  # (I, 16) f32 inverse-transpose 3x3
    cluster_size: int
    instanced: bool = False
    tri_map: Tensor | None = None  # (num_slots,) i32 slot -> scene triangle

    @property
    def num_entries(self) -> int:
        return self.super_spheres.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.spheres.shape[0]

    @property
    def num_slots(self) -> int:
        return self.num_clusters * self.cluster_size

    @functools.cached_property
    def cull_tables(self):
        """The flat cull's (member table, group boxes), built once per set."""
        from ..ops.traverse_cluster import group_boxes, sphere_table

        sph_t = sphere_table(self)
        return sph_t, group_boxes(sph_t)

    @functools.cached_property
    def node_tables(self):
        """The hierarchical walk's `NodeTables`, built once per set."""
        from ..ops.traverse_cluster import _node_tables

        return _node_tables(self)


def treelet_order(centroids: np.ndarray, cluster_size: int, group: int = SUPER) -> np.ndarray:
    """Spatial repacking permutation: every aligned `cluster_size` run is a
    spatially tight treelet (recursive longest-axis median partition with
    cluster-aligned split points). The reference's numpy path, verbatim."""
    n = len(centroids)
    ctr = np.asarray(centroids, np.float64)
    out = np.empty(n, np.int64)
    pos = 0
    big = int(cluster_size) * int(group)
    c = int(cluster_size)
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        k = len(ids)
        if k <= c:
            out[pos : pos + k] = ids
            pos += k
            continue
        sub = ctr[ids]
        ax = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
        align = big if k > big else c
        split = int(round((k / 2) / align)) * align
        split = max(align, min(split, ((k - 1) // align) * align))
        part = np.argpartition(sub[:, ax], split)
        stack.append(ids[part[split:]])  # right — emitted after left
        stack.append(ids[part[:split]])  # left — popped (emitted) first
    return out


def _identity_xf():
    ident = np.zeros((1, 16), np.float32)
    ident[0, 0] = ident[0, 4] = ident[0, 8] = 1.0
    return ident


def _bounds(v0, v1, v2, real_mask):
    """Per-group AABB center/half/radius over real triangles only."""
    allv = np.concatenate([v0, v1, v2], axis=1)  # (G, 3K, 3)
    vm = np.concatenate([real_mask] * 3, axis=1)
    big = 3.0e37
    lo = np.where(vm[:, :, None], allv, big).min(axis=1)
    hi = np.where(vm[:, :, None], allv, -big).max(axis=1)
    anyreal = real_mask.any(axis=1)
    lo = np.where(anyreal[:, None], lo, 0.0)
    hi = np.where(anyreal[:, None], hi, 0.0)
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    radius = np.sqrt((half * half).sum(axis=1))
    # dilate so float32 rounding of centers/radii stays conservative
    radius = np.where(anyreal, radius * (1.0 + 1e-5) + 1e-30, 0.0)
    return center, half, radius


def _cluster_tables_np(sorted_v0, sorted_v1, sorted_v2, num_real, cluster_size):
    """Numpy table stage: rows, spheres, super_spheres, scene_aabb."""
    c = int(cluster_size)
    v0 = np.asarray(sorted_v0, np.float64)
    v1 = np.asarray(sorted_v1, np.float64)
    v2 = np.asarray(sorted_v2, np.float64)
    t_real = int(num_real)
    m = max(1, -(-t_real // c))
    s = -(-m // SUPER)
    m_pad = s * SUPER
    t_pad = m_pad * c

    def pad(v):
        out = np.zeros((t_pad, 3), np.float64)
        n = min(t_real, len(v))
        out[:n] = v[:n]
        return out

    v0, v1, v2 = pad(v0), pad(v1), pad(v2)

    cv0 = v0.reshape(m_pad, c, 3)
    cv1 = v1.reshape(m_pad, c, 3)
    cv2 = v2.reshape(m_pad, c, 3)
    real_mask = np.arange(t_pad).reshape(m_pad, c) < t_real  # (M, C)

    ctr, half, rad = _bounds(cv0, cv1, cv2, real_mask)
    spheres = np.zeros((m_pad, 8), np.float32)
    spheres[:, 0:3] = ctr
    spheres[:, 3] = rad
    spheres[:, 4:7] = half * (1.0 + 1e-5)

    sctr, shalf, srad = _bounds(
        cv0.reshape(s, SUPER * c, 3),
        cv1.reshape(s, SUPER * c, 3),
        cv2.reshape(s, SUPER * c, 3),
        real_mask.reshape(s, SUPER * c),
    )
    super_spheres = np.zeros((s, 8), np.float32)
    super_spheres[:, 0:3] = sctr
    super_spheres[:, 3] = srad
    super_spheres[:, 4:7] = shalf * (1.0 + 1e-5)

    real_any = real_mask.reshape(-1)
    allpts = np.concatenate([v0[real_any], v1[real_any], v2[real_any]], axis=0)
    if len(allpts) == 0:
        slo = np.zeros(3)
        shi = np.zeros(3)
    else:
        slo = allpts.min(axis=0)
        shi = allpts.max(axis=0)
    pad_abs = 1e-5 * max(1.0, float(np.abs(np.concatenate([slo, shi])).max()))
    scene_aabb = np.zeros(8, np.float32)
    scene_aabb[0:3] = slo - pad_abs
    scene_aabb[3:6] = shi + pad_abs

    rows = np.zeros((m_pad, STORE_ROWS, c), np.float32)
    rows[:, 0:3, :] = cv0.transpose(0, 2, 1)
    rows[:, 3:6, :] = (cv1 - cv0).transpose(0, 2, 1)
    rows[:, 6:9, :] = (cv2 - cv0).transpose(0, 2, 1)
    # group SUPER consecutive clusters' columns into one row block
    rows = rows.reshape(s, SUPER, STORE_ROWS, c).transpose(0, 2, 1, 3)
    rows = rows.reshape(s, STORE_ROWS, SUPER * c)
    return dict(rows=rows, spheres=spheres, super_spheres=super_spheres,
                scene_aabb=scene_aabb)


def cluster_set_from_numpy(tables: dict, cluster_size: int, device) -> ClusterSet:
    """ClusterSet on `device` from host tables (`_cluster_tables_np` output,
    plus optional entry_row/entry_xf/xf_*/tri_map arrays)."""

    def up(name, dtype, default=None):
        a = tables.get(name)
        if a is None:
            a = default
        return torch.as_tensor(np.array(a, dtype), device=device)

    sn = tables["super_spheres"].shape[0]
    ident = _identity_xf()
    tm = tables.get("tri_map")
    return ClusterSet(
        rows=up("rows", np.float32),
        spheres=up("spheres", np.float32),
        super_spheres=up("super_spheres", np.float32),
        scene_aabb=up("scene_aabb", np.float32),
        entry_row=up("entry_row", np.int32, np.arange(sn)),
        entry_xf=up("entry_xf", np.int32, np.zeros(sn)),
        xf_inv=up("xf_inv", np.float32, ident),
        xf_fwd=up("xf_fwd", np.float32, ident),
        xf_invt=up("xf_invt", np.float32, ident),
        cluster_size=int(cluster_size),
        tri_map=None if tm is None else up("tri_map", np.int32),
    )


def build_clusters(
    sorted_v0: np.ndarray,
    sorted_v1: np.ndarray,
    sorted_v2: np.ndarray,
    num_real: int,
    device,
    cluster_size: int = 128,
    tri_map: np.ndarray | None = None,
) -> ClusterSet:
    """Build the ClusterSet on `device` from spatially sorted triangles.

    Triangles at index >= num_real are padding and become degenerate
    never-hit triangles (zero edges => det == 0)."""
    tb = _cluster_tables_np(sorted_v0, sorted_v1, sorted_v2, num_real, cluster_size)
    if tri_map is not None:
        full = np.zeros(tb["spheres"].shape[0] * int(cluster_size), np.int32)
        full[: len(tri_map)] = np.asarray(tri_map, np.int32)
        tb["tri_map"] = full
    return cluster_set_from_numpy(tb, cluster_size, device)
