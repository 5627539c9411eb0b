"""Level-synchronous BFS walk over the wide BVH (port of
optixpathtracer_tpu/ops/traverse_bfs.py).

A worklist of (ray, node-ref) pairs of fixed capacity C = cap_factor * N
(rounded up to 1024) walks the wide tree one level per step, for
`wb.depth` steps: one gather of node rows, one of leaf rows and one of the
pairs' ray rows (rebuilt each level, so pruning uses the fresh best t);
slab tests of all W children and Möller–Trumbore on all K leaf triangles;
leaf hits scatter-min into the per-ray best t; child candidates are
compacted by a sort into the next level's worklist.

Exact PROVIDED the worklist never overflows; `overflow` counts the
candidates dropped at capacity (0 == exact). The compaction keeps, for
every pair, its nearest children before any pair's next-nearest (primary
key: the candidate's near-rank within its pair; secondary: its entry t),
so under overflow the far subtrees go first.

Two orders the reference leaves to XLA are defined here:
- The compaction sorts stably by (rank, near): among equal keys the
  candidates keep their worklist order (pair-major, child slot minor). The
  reference's `lax.sort` is not stable.
- Where two pairs of one ray tie on the winning t in a level, the LAST of
  them in worklist order sets (tri, u, v), chosen by a `scatter_reduce`
  amax on the pair's position (XLA on a CPU applies duplicate scatter
  writes in order, so its last write wins too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bvh.wide import EMPTY as _EMPTY_NP, WideBVH
from ..core.math import Vec3
from .intersect import BIG_T
from .traverse_cluster import HitRecord

Tensor = torch.Tensor
EMPTY = int(_EMPTY_NP)


class BFSResult(NamedTuple):
    record: HitRecord
    overflow: Tensor  # f32 scalar: candidates dropped at capacity (0 == exact)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _f32(x, n: int, dev) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(n).contiguous()


def _node_boxes(wb: WideBVH, refs: Tensor):
    """(C, W, 6) child boxes [minx, miny, minz, maxx, maxy, maxz] and
    (C, W) int32 child refs of the pairs' node rows."""
    w = wb.width
    nrows = wb.table[torch.clamp(refs, 0, wb.num_nodes - 1).to(torch.int64)]
    if wb.compressed:
        child_refs = nrows[:, 3 * w:].contiguous().view(torch.int32)
        bits = nrows[:, : 3 * w].contiguous().view(torch.int32).reshape(-1, w, 3)
        hi = (bits & -65536).view(torch.float32)  # 0xFFFF0000: minx, minz, maxy
        lo = (bits << 16).view(torch.float32)  # miny, maxx, maxz
        bb = torch.stack([hi[..., 0], lo[..., 0], hi[..., 1], lo[..., 1], hi[..., 2],
                          lo[..., 2]], dim=-1)
    else:
        child_refs = nrows[:, 6 * w:].contiguous().view(torch.int32)
        bb = nrows[:, : 6 * w].reshape(-1, w, 6)
    return bb, child_refs


def _traverse_bfs(wb: WideBVH, o: Vec3, d: Vec3, t_min, t_max, any_hit: bool,
                  cap_factor: int) -> BFSResult:
    n = o.x.shape[0]
    dev = o.x.device
    w = wb.width
    k = wb.leaf_size
    cap = _round_up(cap_factor * n, 1024)
    t_min = _f32(t_min, n, dev)
    t_max = _f32(t_max, n, dev)

    # worklist: one root entry per ray
    ray_ids = torch.zeros((cap,), dtype=torch.int64, device=dev)
    ray_ids[:n] = torch.arange(n, device=dev)
    refs = torch.full((cap,), EMPTY, dtype=torch.int32, device=dev)
    refs[:n] = 0

    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.float32, device=dev)
    pos = torch.arange(cap, device=dev)
    nl = wb.num_leaves

    for _level in range(wb.depth):
        valid = refs != EMPTY
        is_leaf = valid & (refs < 0)
        is_node = valid & (refs >= 0)

        # per-pair ray rows (fresh best t for pruning)
        p_max_ray = torch.where(occluded, -1.0, best_t) if any_hit else best_t
        rr = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, t_min, p_max_ray], dim=1)[ray_ids]
        ox, oy, oz = rr[:, 0:1], rr[:, 1:2], rr[:, 2:3]
        dxl, dyl, dzl = rr[:, 3:4], rr[:, 4:5], rr[:, 5:6]
        p_tmin, p_tmax = rr[:, 6:7], rr[:, 7:8]
        ix = 1.0 / torch.where(dxl.abs() > 1e-20, dxl, 1e-20)
        iy = 1.0 / torch.where(dyl.abs() > 1e-20, dyl, 1e-20)
        iz = 1.0 / torch.where(dzl.abs() > 1e-20, dzl, 1e-20)

        # internal nodes: W slab tests
        bb, child_refs = _node_boxes(wb, refs)
        t0x = (bb[:, :, 0] - ox) * ix
        t1x = (bb[:, :, 3] - ox) * ix
        t0y = (bb[:, :, 1] - oy) * iy
        t1y = (bb[:, :, 4] - oy) * iy
        t0z = (bb[:, :, 2] - oz) * iz
        t1z = (bb[:, :, 5] - oz) * iz
        near = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.maximum(torch.minimum(t0z, t1z), p_tmin))
        far = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), p_tmax))
        cand_ok = is_node[:, None] & (near <= far) & (child_refs != EMPTY)

        # leaves: K triangle tests
        leaf_id = torch.clamp(-(refs + 1), 0, nl - 1).to(torch.int64)
        tv = wb.leaf_rows[leaf_id].reshape(-1, k, 9)
        e1x = tv[:, :, 3] - tv[:, :, 0]
        e1y = tv[:, :, 4] - tv[:, :, 1]
        e1z = tv[:, :, 5] - tv[:, :, 2]
        e2x = tv[:, :, 6] - tv[:, :, 0]
        e2y = tv[:, :, 7] - tv[:, :, 1]
        e2z = tv[:, :, 8] - tv[:, :, 2]
        px = dyl * e2z - dzl * e2y
        py = dzl * e2x - dxl * e2z
        pz = dxl * e2y - dyl * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = det.abs() > 1e-12
        inv_det = torch.where(det_ok, 1.0 / det, 0.0)
        tx = ox - tv[:, :, 0]
        ty = oy - tv[:, :, 1]
        tz = oz - tv[:, :, 2]
        uu = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (dxl * qx + dyl * qy + dzl * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        tri_hit = (is_leaf[:, None] & det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                   & (tt > p_tmin) & (tt < p_tmax))
        tt = torch.where(tri_hit, tt, BIG_T)
        jbest = torch.argmin(tt, dim=1, keepdim=True)  # first of equal t
        t_pair = torch.gather(tt, 1, jbest)[:, 0]
        hit_pair = t_pair < BIG_T

        if any_hit:
            occ_i = torch.zeros((n,), dtype=torch.int32, device=dev).scatter_reduce(
                0, ray_ids, hit_pair.to(torch.int32), "amax")
            occluded = occluded | (occ_i > 0)
        else:
            best_t = best_t.scatter_reduce(0, ray_ids, torch.where(hit_pair, t_pair, BIG_T),
                                           "amin")
            won = hit_pair & (t_pair <= best_t[ray_ids])
            # the last winning pair of each ray in worklist order sets the payload
            last = torch.full((n,), -1, dtype=torch.int64, device=dev).scatter_reduce(
                0, ray_ids, torch.where(won, pos, -1), "amax")
            got = last >= 0
            src = torch.clamp(last, min=0)
            tri_pair = wb.leaf_tri0[leaf_id[src]] + jbest[src, 0].to(torch.int32)
            best_tri = torch.where(got, tri_pair, best_tri)
            best_u = torch.where(got, torch.gather(uu, 1, jbest)[src, 0], best_u)
            best_v = torch.where(got, torch.gather(vv, 1, jbest)[src, 0], best_v)

        # compaction: (C*W) candidates -> C slots, nearest-rank first
        near_masked = torch.where(cand_ok, near, torch.inf)
        rank = torch.argsort(torch.argsort(near_masked, dim=1, stable=True), dim=1, stable=True)
        cand_refs = torch.where(cand_ok, child_refs, EMPTY).reshape(-1)
        cand_rays = ray_ids[:, None].expand(cap, w).reshape(-1)
        cand_near = near_masked.reshape(-1)
        cand_rank = torch.where(cand_ok, rank, w).reshape(-1)
        perm = torch.argsort(cand_near, stable=True)
        perm = perm[torch.argsort(cand_rank[perm], stable=True)]
        srt_refs = cand_refs[perm]
        refs = srt_refs[:cap]
        ray_ids = cand_rays[perm[:cap]]
        n_valid = (srt_refs != EMPTY).sum().to(torch.float32)
        overflow = overflow + torch.clamp(n_valid - cap, min=0.0)

    if any_hit:
        rec = HitRecord(t=torch.where(occluded, t_min, t_max),
                        tri=torch.where(occluded, 0, -1).to(torch.int32),
                        u=torch.zeros_like(t_min), v=torch.zeros_like(t_min))
    else:
        rec = HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)
    return BFSResult(record=rec, overflow=overflow)


def closest_hit_bfs(wb: WideBVH, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16,
                    cap_factor: int = 4) -> BFSResult:
    return _traverse_bfs(wb, o, d, t_min, t_max, any_hit=False, cap_factor=cap_factor)


def any_hit_bfs(wb: WideBVH, o: Vec3, d: Vec3, t_min=0.01, t_max=1e16,
                cap_factor: int = 4) -> tuple[Tensor, Tensor]:
    """Returns (occluded bool (N,), overflow scalar)."""
    res = _traverse_bfs(wb, o, d, t_min, t_max, any_hit=True, cap_factor=cap_factor)
    return res.record.hit, res.overflow
