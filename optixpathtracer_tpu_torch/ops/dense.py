"""Dense (no-BVH) traversal for small scenes (port of
optixpathtracer_tpu/ops/dense.py): every ray against every triangle, the
triangles of the wide BVH's leaf rows streamed in blocks of BLOCK.

Exact by construction. Each block makes (rays, BLOCK) f32 temporaries, so
the rays go through in chunks of at most DENSE_CHUNK_ELEMS // BLOCK (32768
rays: 64 MiB a temporary); a ray's result does not depend on its chunk.
"""
from __future__ import annotations

import torch

from ..bvh.wide import WideBVH
from ..core.math import Vec3
from .intersect import BIG_T
from .traverse_cluster import HitRecord

Tensor = torch.Tensor

BLOCK = 512
DENSE_CHUNK_ELEMS = 1 << 24  # (rays, BLOCK) elements per temporary


def _tri_blocks(wb: WideBVH) -> Tensor:
    """(L, K*9) leaf rows -> (nblocks, BLOCK, 9) triangle blocks, padded by
    repeating the last triangle (harmless for closest and any hit)."""
    tris = wb.leaf_rows.reshape(-1, 9)  # (T, 9) in sorted order
    t = tris.shape[0]
    nb = -(-t // BLOCK)
    pad = nb * BLOCK - t
    if pad:
        tris = torch.cat([tris, tris[-1:].expand(pad, 9)])
    return tris.reshape(nb, BLOCK, 9)


def _scan(blocks: Tensor, o: Vec3, d: Vec3, t_min: Tensor, t_max: Tensor) -> HitRecord:
    n = o.x.shape[0]
    dev = o.x.device
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    tmin = t_min[:, None]
    for b in range(blocks.shape[0]):
        tv = blocks[b]  # (BLOCK, 9)
        e1x = tv[:, 3] - tv[:, 0]
        e1y = tv[:, 4] - tv[:, 1]
        e1z = tv[:, 5] - tv[:, 2]
        e2x = tv[:, 6] - tv[:, 0]
        e2y = tv[:, 7] - tv[:, 1]
        e2z = tv[:, 8] - tv[:, 2]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = det.abs() > 1e-12
        inv_det = torch.where(det_ok, 1.0 / det, 0.0)
        tx = ox - tv[:, 0]
        ty = oy - tv[:, 1]
        tz = oz - tv[:, 2]
        uu = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > tmin)
              & (tt < torch.minimum(t_max, best_t)[:, None]))
        tt = torch.where(ok, tt, BIG_T)
        j = torch.argmin(tt, dim=1, keepdim=True)
        tb = torch.gather(tt, 1, j)[:, 0]
        better = tb < best_t
        best_t = torch.where(better, tb, best_t)
        best_tri = torch.where(better, (b * BLOCK + j[:, 0]).to(torch.int32), best_tri)
        best_u = torch.where(better, torch.gather(uu, 1, j)[:, 0], best_u)
        best_v = torch.where(better, torch.gather(vv, 1, j)[:, 0], best_v)
    return HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)


def closest_hit_dense(wb: WideBVH, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16) -> HitRecord:
    n = o.x.shape[0]
    dev = o.x.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    blocks = _tri_blocks(wb)
    chunk = DENSE_CHUNK_ELEMS // BLOCK
    parts = [_scan(blocks, Vec3(*(c[s:s + chunk] for c in o)), Vec3(*(c[s:s + chunk] for c in d)),
                   t_min[s:s + chunk], t_max[s:s + chunk]) for s in range(0, max(n, 1), chunk)]
    if len(parts) == 1:
        return parts[0]
    return HitRecord(*(torch.cat(f) for f in zip(*parts)))


def any_hit_dense(wb: WideBVH, o: Vec3, d: Vec3, t_min=0.01, t_max=1e16) -> Tensor:
    return closest_hit_dense(wb, o, d, t_min, t_max).hit
