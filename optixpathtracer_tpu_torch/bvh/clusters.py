"""Triangle clusters — the acceleration structure of the cluster traversal
(port of optixpathtracer_tpu/bvh/clusters.py).

CLUSTER: C consecutive triangles of the treelet order, stored pre-differenced
as rows [v0 | e1 | e2] with an AABB (center, half extent) and a bounding
sphere. SUPERCLUSTER: SUPER consecutive clusters, the unit the per-block
cull sorts and the sweep walks ("entries"). The host build is the port's
copy of the reference's native C++ builder (bvh/native.py), or its numpy
code under OPTIX_TPU_NO_NATIVE=1, so every table is bit-identical to the
JAX build's on the same path.

INSTANCING (the original's per-mesh GAS pool plus IAS, the cluster way):
the triangle rows of each prototype are stored once in local space; every
(instance, prototype supercluster) pair is an ENTRY with world-space bounds,
the row index of its supercluster and a transform id. The sweeps move each
ray into the instance's frame per entry (`xf_inv`); shading moves vertices
out with `xf_fwd` and normals with `xf_invt`. A non-instanced set is the
identity special case. `update_tlas_transforms` / `update_instance_transforms`
replace only the entry tables and the transforms, never `rows`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

Tensor = torch.Tensor

NUM_ROWS = 9  # [v0x v0y v0z e1x e1y e1z e2x e2y e2z]
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
    cluster-aligned split points). The native C++ builder (bvh/native.py)
    where it is on, as in the reference; it takes the same recursion and
    split points but orders triangles within a partition its own way, so
    the cluster order differs from the numpy path below (the reference's,
    verbatim), which runs under OPTIX_TPU_NO_NATIVE=1."""
    from . import native as _native

    nat = _native.treelet_order(centroids, cluster_size, group)
    if nat is not None:
        return nat
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


def _cluster_tables(sorted_v0, sorted_v1, sorted_v2, num_real, cluster_size):
    """Table stage shared by the plain and instanced builders: the native
    C++ build (bit-exact) where it is on and the vertices are float32, as
    in the reference, else `_cluster_tables_np`."""
    from . import native as _native

    if all(np.asarray(v).dtype == np.float32 for v in (sorted_v0, sorted_v1, sorted_v2)):
        nat = _native.cluster_tables(sorted_v0, sorted_v1, sorted_v2, int(num_real),
                                     int(cluster_size))
        if nat is not None:
            return nat
    return _cluster_tables_np(sorted_v0, sorted_v1, sorted_v2, num_real, cluster_size)


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
    lo6 = np.concatenate([scene_aabb[0:3], scene_aabb[3:6]])
    return dict(rows=rows, spheres=spheres, super_spheres=super_spheres,
                scene_aabb=scene_aabb, local_aabb=lo6)


def cluster_set_from_numpy(tables: dict, cluster_size: int, device,
                           instanced: bool = False) -> ClusterSet:
    """ClusterSet on `device` from host tables (`_cluster_tables` output,
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
        instanced=bool(instanced),
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
    tb = _cluster_tables(sorted_v0, sorted_v1, sorted_v2, num_real, cluster_size)
    if tri_map is not None:
        full = np.zeros(tb["spheres"].shape[0] * int(cluster_size), np.int32)
        full[: len(tri_map)] = np.asarray(tri_map, np.int32)
        tb["tri_map"] = full
    return cluster_set_from_numpy(tb, cluster_size, device)


def _pack_xf(mat3: np.ndarray, trans: np.ndarray | None) -> np.ndarray:
    """(I, 16) f32 transform rows [A row-major 9 | b 3 | pad 4]."""
    i_n = mat3.shape[0]
    out = np.zeros((i_n, 16), np.float32)
    out[:, 0:9] = mat3.reshape(i_n, 9)
    if trans is not None:
        out[:, 9:12] = trans
    return out


def _xf_tables(a: np.ndarray, b: np.ndarray) -> dict:
    """xf_inv / xf_fwd / xf_invt of (I, 3, 3) matrices and (I, 3) offsets."""
    a_inv = np.linalg.inv(a)
    b_inv = -np.einsum("iab,ib->ia", a_inv, b)
    return dict(xf_inv=_pack_xf(a_inv, b_inv), xf_fwd=_pack_xf(a, b),
                xf_invt=_pack_xf(np.linalg.inv(a).transpose(0, 2, 1), None))


def _padded_aabb(wlo: np.ndarray, whi: np.ndarray) -> np.ndarray:
    pad_abs = 1e-5 * max(1.0, float(np.abs(np.concatenate([wlo, whi])).max()))
    aabb = np.zeros(8, np.float32)
    aabb[0:3] = wlo - pad_abs
    aabb[3:6] = whi + pad_abs
    return aabb


def _aabb_corners(local_aabb: np.ndarray) -> np.ndarray:
    lo, hi = local_aabb[0:3], local_aabb[3:6]
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])])  # (8, 3)


def _entry_tables(tb: dict, transforms: np.ndarray) -> dict:
    """World-space per-instance entry tables of one prototype's local
    tables. transforms: (I, 4, 4) local->world. Conservative world bounds:
    sphere radius scaled by each matrix's largest singular value (and
    1 + 1e-6), half extents by |A|. Entries are instance-major."""
    xf = np.asarray(transforms, np.float64)
    i_n = xf.shape[0]
    a = xf[:, :3, :3]
    b = xf[:, :3, 3]
    sigma = np.linalg.svd(a, compute_uv=False)[:, 0]  # (I,)

    def world_spheres(local):  # (G, 8) -> (I*G, 8), instance-major
        ctr = local[:, 0:3]
        cw = np.einsum("iab,gb->iga", a, ctr) + b[:, None, :]
        rw = local[None, :, 3] * sigma[:, None] * (1.0 + 1e-6)
        hw = np.einsum("iab,gb->iga", np.abs(a), local[:, 4:7])
        g = local.shape[0]
        out = np.zeros((i_n * g, 8), np.float32)
        out[:, 0:3] = cw.reshape(-1, 3)
        out[:, 3] = rw.reshape(-1)
        out[:, 4:7] = hw.reshape(-1, 3)
        return out

    wc = np.einsum("iab,gb->iga", a, _aabb_corners(tb["local_aabb"])) + b[:, None, :]
    sn = tb["super_spheres"].shape[0]
    return dict(
        spheres=world_spheres(tb["spheres"]),
        super_spheres=world_spheres(tb["super_spheres"]),
        scene_aabb=_padded_aabb(wc.reshape(-1, 3).min(axis=0), wc.reshape(-1, 3).max(axis=0)),
        entry_row=np.tile(np.arange(sn, dtype=np.int32), i_n),
        entry_xf=np.repeat(np.arange(i_n, dtype=np.int32), sn),
        **_xf_tables(a, b),
    )


def _instance_world_tables(tbs: list, inst_proto: np.ndarray, transforms: np.ndarray) -> dict:
    """TLAS entry tables over several prototypes: tbs are the prototypes'
    local tables, inst_proto (I,) each instance's prototype, transforms
    (I, 4, 4) local->world. Entries are instance-major (every supercluster
    of instance 0, then of instance 1, ...); `_entry_tables` is the
    one-prototype case."""
    xf = np.asarray(transforms, np.float64)
    i_n = xf.shape[0]
    inst_proto = np.asarray(inst_proto, np.int64)
    a = xf[:, :3, :3]
    b = xf[:, :3, 3]
    sigma = np.linalg.svd(a, compute_uv=False)[:, 0]  # (I,)
    row_off = np.concatenate([[0], np.cumsum([tb["rows"].shape[0] for tb in tbs])]).astype(np.int64)

    esph, esup, erow, exf = [], [], [], []
    wlo = np.full(3, np.inf)
    whi = np.full(3, -np.inf)
    for i in range(i_n):
        p = int(inst_proto[i])
        tb = tbs[p]
        ai, bi, si = a[i], b[i], sigma[i]

        def ws(local, ai=ai, bi=bi, si=si):  # (G, 8) local -> (G, 8) world
            out = np.zeros((local.shape[0], 8), np.float32)
            out[:, 0:3] = local[:, 0:3] @ ai.T + bi
            out[:, 3] = local[:, 3] * si * (1.0 + 1e-6)
            out[:, 4:7] = local[:, 4:7] @ np.abs(ai).T
            return out

        esph.append(ws(tb["spheres"]))
        esup.append(ws(tb["super_spheres"]))
        sn = tb["super_spheres"].shape[0]
        erow.append(row_off[p] + np.arange(sn, dtype=np.int64))
        exf.append(np.full(sn, i, np.int32))
        wc = _aabb_corners(tb["local_aabb"]) @ ai.T + bi
        wlo = np.minimum(wlo, wc.min(axis=0))
        whi = np.maximum(whi, wc.max(axis=0))

    return dict(
        spheres=np.concatenate(esph, axis=0),
        super_spheres=np.concatenate(esup, axis=0),
        scene_aabb=_padded_aabb(wlo, whi),
        entry_row=np.concatenate(erow).astype(np.int32),
        entry_xf=np.concatenate(exf),
        **_xf_tables(a, b),
    )


def build_instanced_clusters(
    sorted_v0: np.ndarray,
    sorted_v1: np.ndarray,
    sorted_v2: np.ndarray,
    num_real: int,
    transforms: np.ndarray,
    device,
    cluster_size: int = 128,
) -> ClusterSet:
    """Instanced ClusterSet on `device`: one prototype's rows stored once in
    local space, one entry per (instance, supercluster) with world bounds
    and a transform id. Move the instances with `update_instance_transforms`."""
    tb = _cluster_tables(sorted_v0, sorted_v1, sorted_v2, num_real, cluster_size)
    et = _entry_tables(tb, transforms)
    return cluster_set_from_numpy(dict(et, rows=tb["rows"]), cluster_size, device, instanced=True)


def build_tlas_clusters(
    proto_tables: list,
    inst_proto: np.ndarray,
    transforms: np.ndarray,
    device,
    cluster_size: int = 128,
) -> ClusterSet:
    """TLAS ClusterSet on `device`: a pool of prototype row blocks (each
    prototype's `_cluster_tables`, stored once) and one entry per
    (instance, prototype supercluster). Move the instances with
    `update_tlas_transforms`."""
    rows = np.concatenate([tb["rows"] for tb in proto_tables], axis=0)
    et = _instance_world_tables(proto_tables, inst_proto, transforms)
    return cluster_set_from_numpy(dict(et, rows=rows), cluster_size, device, instanced=True)


_MOVED = ("spheres", "super_spheres", "scene_aabb", "xf_inv", "xf_fwd", "xf_invt")


def _moved(cs: ClusterSet, et: dict) -> ClusterSet:
    """cs with new entry bounds and transforms; rows, entry_row and entry_xf
    stay the same tensors."""
    dev = cs.rows.device
    return dataclasses.replace(cs, **{
        k: torch.as_tensor(np.array(et[k], np.float32), device=dev) for k in _MOVED})


def update_tlas_transforms(cs: ClusterSet, proto_tables: list, inst_proto: np.ndarray,
                           transforms: np.ndarray) -> ClusterSet:
    """New per-instance transforms over the same prototype rows."""
    return _moved(cs, _instance_world_tables(proto_tables, inst_proto, transforms))


def update_instance_transforms(cs: ClusterSet, local_tables: dict,
                               transforms: np.ndarray) -> ClusterSet:
    """New transforms of a `build_instanced_clusters` set, same geometry:
    only the entry bounds and the transform tables are rebuilt."""
    return _moved(cs, _entry_tables(local_tables, transforms))
