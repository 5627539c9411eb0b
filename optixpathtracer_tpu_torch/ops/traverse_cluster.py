"""Cluster traversal — exact closest-hit and any-hit for ray wavefronts
(port of optixpathtracer_tpu/ops/traverse_cluster.py, flat path).

Rays go in blocks of 128 through two stages:

  1. CULL (kernel K1, `cull_blocks`): per block, an exact slab test of each
     live ray's [0, t_max] against every cluster AABB; per supercluster
     ("entry") a near-to-far key (box-to-box distance lower bound) and
     per-(16-ray sub-block, member cluster) hit bits. `block_cull` then
     sorts each block's entries by key (stable).
  2. SWEEP (kernels K2 `closest_sweep`, K3 `any_sweep`): per block, walk the
     surviving entries near to far, evaluating exact f32 Moller-Trumbore for
     the (sub-block, member) pairs the cull allowed.

Each kernel has a plain PyTorch version here (`_cull_torch`,
`_closest_torch`, `_any_torch`) with the same arithmetic, op for op. A
wrapper takes the plain version for CPU tensors and launches its CUDA
kernel (csrc/traverse_cluster.cu) for CUDA tensors, or raises; there is no
fallback from one to the other. `launch_counts` counts kernel launches.

The hierarchical (node) walk of the reference (kernel K4) is ROADMAP A.12;
`hier=True` raises NotImplementedError.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from ..bvh.clusters import STORE_ROWS, SUPER, ClusterSet
from ..core.math import Vec3
from ..core.rng import M32, as_i32_bits

Tensor = torch.Tensor

BIG_T = 1e30  # miss sentinel of HitRecord.t (ops/intersect.py)
BLOCK = 128  # rays per block: the lo/hi layout is 8 sub-blocks of 16 (kBlock)
_BIG = 3.0e37
_MT_ELEMS = 1 << 21  # ray-triangle pairs per plain-sweep chunk (memory bound)

# kernel name -> launches since the last clear()
launch_counts: collections.Counter = collections.Counter()


class HitRecord(NamedTuple):
    """SoA closest-hit payload."""

    t: Tensor  # (N,) BIG_T on miss
    tri: Tensor  # (N,) int32 scene triangle id, -1 on miss
    u: Tensor  # (N,) barycentrics
    v: Tensor

    @property
    def hit(self) -> Tensor:
        return self.tri >= 0


class CullResult(NamedTuple):
    ids: Tensor  # (NR, E) int32 entry ids, survivors first, near-to-far
    keys: Tensor  # (NR, E) f32 sorted distance lower bounds (BIG for misses)
    bits_lo: Tensor  # (NR, E) int32 bit pattern of the uint32 member masks of
    #   sub-blocks 0-3: member k of sub-block s at bit (s%4)*8 + k
    bits_hi: Tensor  # (NR, E) same for sub-blocks 4-7
    rowix: Tensor  # (NR, E) int32 triangle-rows index per entry
    xfix: Tensor  # (NR, E) int32 transform id per entry
    count: Tensor  # (NR, 1) int32 number of surviving entries
    rays8: Tensor  # (NR*B, 8) f32 [o(3), d(3), t_min, t_max]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad1(a: Tensor, n8: int, fill: float) -> Tensor:
    n = a.shape[0]
    if n8 == n:
        return a
    return torch.cat([a, torch.full((n8 - n,), fill, dtype=a.dtype, device=a.device)])


def _safe_recip(d: Tensor) -> Tensor:
    """Robust reciprocal: degenerate components get a huge-but-finite slope."""
    return 1.0 / torch.where(d.abs() > 1e-30, d, 1e-30)


# --------------------------------------------------------------------------
# Stage 1: cull
# --------------------------------------------------------------------------

def _pack_rays8(cs: ClusterSet, o: Vec3, d: Vec3, t_min, t_max) -> Tensor:
    """Pad rays to whole 8-block groups (padding rays are dead) and cap every
    ray's reach at the scene-AABB exit, so the sweeps' early exit fires even
    in blocks holding sky rays. Returns (NB, 8) f32."""
    n = o.x.shape[0]
    dev = o.x.device
    nb = _round_up(max(n, 8 * BLOCK), 8 * BLOCK)
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    ox, oy, oz = (_pad1(a, nb, 0.0) for a in o)
    dx, dy, dz = (_pad1(a, nb, 1.0) for a in d)
    tm = _pad1(t_min, nb, 1.0)
    tM = _pad1(t_max, nb, 0.0)
    bb = cs.scene_aabb
    ix, iy, iz = _safe_recip(dx), _safe_recip(dy), _safe_recip(dz)
    t0x = (bb[0] - ox) * ix
    t1x = (bb[3] - ox) * ix
    t0y = (bb[1] - oy) * iy
    t1y = (bb[4] - oy) * iy
    t0z = (bb[2] - oz) * iz
    t1z = (bb[5] - oz) * iz
    entry = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp(torch.minimum(t0z, t1z), min=0.0),
    )
    exit_ = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z),
    )
    reach_cap = torch.where(exit_ >= entry, torch.clamp(exit_, min=0.0), 0.0)
    tM = torch.minimum(tM, reach_cap * (1.0 + 1e-5) + 1e-6)
    return torch.stack([ox, oy, oz, dx, dy, dz, tm, tM], dim=1)


def sphere_table(cs: ClusterSet) -> Tensor:
    """(8, M) member-major cluster-bounds table: cluster k of super s at
    column k*S + s, rows [cx cy cz r hx hy hz .]."""
    m = cs.spheres.shape[0]
    sn = m // SUPER
    return cs.spheres.reshape(sn, SUPER, 8).transpose(0, 1).reshape(m, 8).T.contiguous()


def _cull_torch(rays8: Tensor, sph_t: Tensor):
    """Plain PyTorch version of kernel K1 (`_cull_math` of the reference,
    vectorised over blocks and chunked to bound memory).

    Returns key (NR, S) f32, lo/hi (NR, S) int32 bit patterns, count (NR, 1)."""
    nr = rays8.shape[0] // BLOCK
    m = sph_t.shape[1]
    s = m // SUPER
    sb = BLOCK // 8
    dev = rays8.device
    rb = rays8.reshape(nr, BLOCK, 8)
    q = [sph_t[a].reshape(1, 1, m) for a in range(3)]
    h = [sph_t[4 + a].reshape(1, 1, m) for a in range(3)]
    # weight of (sub-block s8, member k) in the packed words: bit (s8%4)*8 + k
    shifts = (torch.arange(8, device=dev)[:, None] % 4) * 8 + torch.arange(SUPER, device=dev)
    weights = (torch.ones((), dtype=torch.int64, device=dev) << shifts).reshape(1, 8, SUPER, 1)
    keys, los, his, counts = [], [], [], []
    chunk = max(1, (1 << 22) // (BLOCK * m))
    for c0 in range(0, nr, chunk):
        r = rb[c0 : c0 + chunk]  # (b, B, 8)
        nb_ = r.shape[0]
        o = [r[:, :, a : a + 1] for a in range(3)]
        tm, tM = r[:, :, 6:7], r[:, :, 7:8]
        alive = tM > tm  # (b, B, 1)
        t0, t1 = [], []
        for a in range(3):
            iv = _safe_recip(r[:, :, 3 + a : 4 + a])
            mid = (q[a] - o[a]) * iv
            rad = h[a] * iv.abs()
            t0.append(mid - rad)
            t1.append(mid + rad)
        tn = torch.maximum(torch.maximum(t0[0], t0[1]), torch.clamp(t0[2], min=0.0))
        tf = torch.minimum(torch.minimum(t1[0], t1[1]), torch.minimum(t1[2], tM))
        hit = alive & (tn <= tf + tf.abs() * 4e-7 + 1e-30)  # (b, B, M)
        mask = hit.any(dim=1)  # (b, M)

        alive_any = alive.any(dim=1)  # (b, 1)
        sep2 = []
        for a in range(3):
            lo = torch.where(alive, o[a], _BIG).amin(dim=1)
            hi = torch.where(alive, o[a], -_BIG).amax(dim=1)
            lo = torch.where(alive_any, lo, 0.0)
            hi = torch.where(alive_any, hi, 0.0)
            ob, hb = 0.5 * (lo + hi), 0.5 * (hi - lo)
            sa = torch.clamp((q[a][0] - ob).abs() - (h[a][0] + hb), min=0.0)
            sep2.append(sa * sa)
        dist = torch.sqrt(sep2[0] + sep2[1] + sep2[2]) * (1.0 - 4e-7)  # (b, M)
        ckey = torch.where(mask, dist, _BIG)
        key = ckey.reshape(nb_, SUPER, s).amin(dim=1)  # member-major columns

        sub_hit = hit.reshape(nb_, 8, sb, SUPER, s).any(dim=2)  # (b, 8, SUPER, S)
        packed = sub_hit.to(torch.int64) * weights
        lo_w = packed[:, :4].sum(dim=(1, 2))
        hi_w = packed[:, 4:].sum(dim=(1, 2))
        any_bits = (lo_w | hi_w) != 0
        keys.append(torch.where(any_bits, key, _BIG))
        los.append(as_i32_bits(lo_w))
        his.append(as_i32_bits(hi_w))
        counts.append(any_bits.sum(dim=1, keepdim=True).to(torch.int32))
    return torch.cat(keys), torch.cat(los), torch.cat(his), torch.cat(counts)


def _check(t: Tensor, name: str, dtype, device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _lib():
    from .cuda_build import load

    lib = load("traverse_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cull_launch.argtypes = [i, p, p, i, i, p, p, p, p, p]
    lib.closest_launch.argtypes = [i] + [p] * 10 + [i, i, i] + [p] * 4
    lib.any_launch.argtypes = [i] + [p] * 9 + [i, i, i] + [p] * 2
    for fn in (lib.cull_launch, lib.closest_launch, lib.any_launch):
        fn.restype = ctypes.c_int
    return lib


def _launch_env(x: Tensor):
    """(device index, stream handle) for a launch on x's CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


def cull_blocks(rays8: Tensor, sph_t: Tensor):
    """Kernel K1. Returns (key (NR, S) f32, lo (NR, S) int32, hi, count (NR, 1))."""
    if rays8.device.type == "cpu":
        return _cull_torch(rays8, sph_t)
    dev_idx, stream = _launch_env(rays8)
    nr = rays8.shape[0] // BLOCK
    m = sph_t.shape[1]
    s = m // SUPER
    _check(rays8, "rays8", torch.float32, rays8.device, (nr * BLOCK, 8))
    _check(sph_t, "sph_t", torch.float32, rays8.device, (8, s * SUPER))
    key = torch.empty((nr, s), dtype=torch.float32, device=rays8.device)
    lo = torch.empty((nr, s), dtype=torch.int32, device=rays8.device)
    hi = torch.empty_like(lo)
    count = torch.empty((nr, 1), dtype=torch.int32, device=rays8.device)
    _raise_on(_lib().cull_launch(
        dev_idx, rays8.data_ptr(), sph_t.data_ptr(), nr, m, key.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), count.data_ptr(), stream), "cull")
    launch_counts["cull"] += 1
    return key, lo, hi, count


def block_cull(cs: ClusterSet, o: Vec3, d: Vec3, t_min, t_max) -> CullResult:
    """Stage 1: the per-block cull, then a stable sort of each block's
    entries near-to-far (ties keep entry order, as lax.sort does)."""
    rays8 = _pack_rays8(cs, o, d, t_min, t_max)
    key, lo, hi, count = cull_blocks(rays8, sphere_table(cs))
    keys, order = torch.sort(key, dim=1, stable=True)
    return CullResult(
        ids=order.to(torch.int32),
        keys=keys,
        bits_lo=torch.gather(lo, 1, order),
        bits_hi=torch.gather(hi, 1, order),
        rowix=cs.entry_row[order],
        xfix=cs.entry_xf[order],
        count=count,
        rays8=rays8,
    )


# --------------------------------------------------------------------------
# Stage 2: sweep
# --------------------------------------------------------------------------

def _xform_ray(o3, d3, xf):
    """Affine world->instance map; xf rows [A row-major 9 | b 3 | pad].
    o3/d3: 3-tuples of (P, 16) tensors, xf: (P, 16). t is invariant."""
    a = [xf[:, i : i + 1] for i in range(12)]
    ox, oy, oz = o3
    dx, dy, dz = d3
    lo = (a[0] * ox + a[1] * oy + a[2] * oz + a[9],
          a[3] * ox + a[4] * oy + a[5] * oz + a[10],
          a[6] * ox + a[7] * oy + a[8] * oz + a[11])
    ld = (a[0] * dx + a[1] * dy + a[2] * dz,
          a[3] * dx + a[4] * dy + a[5] * dz,
          a[6] * dx + a[7] * dy + a[8] * dz)
    return lo, ld


def _mt_block(oc, dc, tri9):
    """Moller-Trumbore numerators for rays x triangles.

    oc/dc: 3-tuples of (P, R, 1) ray components; tri9: (P, 9, C) rows
    [v0 | e1 | e2]. Returns (det, u*det, v*det, t*det), each (P, R, C)."""
    ox, oy, oz = oc
    dx, dy, dz = dc
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri9[:, r : r + 1, :] for r in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    up = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vp = dx * qx + dy * qy + dz * qz
    tp = e2x * qx + e2y * qy + e2z * qz
    return det, up, vp, tp


def _mt_sign_inv(det):
    """(sign s, |det|, |det| > 0 mask, guarded 1/|det|) of M-T determinants."""
    s = torch.where(det >= 0.0, 1.0, -1.0)
    ad = det * s
    pos = ad > 0.0
    invd = torch.where(pos, 1.0 / torch.where(pos, ad, 1.0), 0.0)
    return s, ad, pos, invd


def _mt_t(det, up, vp, tp):
    """(edge-test mask, t) from M-T numerators, t = (tp*s) * (1/|det|)."""
    s, ad, pos, invd = _mt_sign_inv(det)
    us = up * s
    vs = vp * s
    return pos & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad), (tp * s) * invd


def _gated_pairs(cr: CullResult, live: Tensor, i: int, k: int):
    """(block, sub-block) pairs among `live` blocks whose cull bit for member
    k of their i-th entry is set."""
    lo = cr.bits_lo[live, i].to(torch.int64) & M32
    hi = cr.bits_hi[live, i].to(torch.int64) & M32
    sh = torch.arange(4, device=live.device) * 8 + k
    bits = torch.cat([(lo[:, None] >> sh) & 1, (hi[:, None] >> sh) & 1], dim=1)  # (nl, 8)
    blk, sub = torch.nonzero(bits, as_tuple=True)
    return live[blk], sub


def _walk(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int, visit):
    """Shared plain walk of `_closest_torch` / `_any_torch`: for each sorted
    position i and member k, gather the gated (block, 16-ray sub-block)
    pairs, transform their rays, compute M-T against the member's C
    triangles and hand the results to `visit(ray_idx, tm, tM, det, up, vp,
    tp, blk, i, k)`. Skips the early exit, which never changes a result."""
    sb = BLOCK // 8
    dev = cr.rays8.device
    cnt = cr.count[:, 0]
    lane = torch.arange(sb, device=dev)
    pair_chunk = max(1, _MT_ELEMS // (sb * c))
    for i in range(cr.ids.shape[1]):
        live = torch.nonzero(cnt > i)[:, 0]
        if live.numel() == 0:
            break
        for k in range(SUPER):
            blk_all, sub_all = _gated_pairs(cr, live, i, k)
            tri_rows = rows[:, :9, k * c : (k + 1) * c]
            for p0 in range(0, blk_all.numel(), pair_chunk):
                blk = blk_all[p0 : p0 + pair_chunk]
                ray_idx = blk[:, None] * BLOCK + sub_all[p0 : p0 + pair_chunk, None] * sb + lane
                r = cr.rays8[ray_idx]  # (P, 16, 8)
                oc, dc = _xform_ray(
                    (r[..., 0], r[..., 1], r[..., 2]), (r[..., 3], r[..., 4], r[..., 5]),
                    xf_inv[cr.xfix[blk, i]],
                )
                det, up, vp, tp = _mt_block(
                    tuple(x[..., None] for x in oc), tuple(x[..., None] for x in dc),
                    tri_rows[cr.rowix[blk, i]],
                )
                visit(ray_idx, r[..., 6:7], r[..., 7:8], det, up, vp, tp, blk, i, k)


def _closest_torch(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int):
    """Plain PyTorch version of kernel K2. Returns (t (NB,), tri (NB,) slot
    ids, -1 on miss). Within a member the lowest column wins among equal t;
    across members and entries the first visited wins (strict <)."""
    best = cr.rays8[:, 7].clone()
    tri = torch.full_like(best, -1, dtype=torch.int32)
    iota = torch.arange(c, device=best.device, dtype=torch.int32)

    def visit(ray_idx, tm, tM, det, up, vp, tp, blk, i, k):
        ok, t = _mt_t(det, up, vp, tp)
        cur = best[ray_idx]  # (P, 16)
        tcand = torch.where(ok & (t > tm) & (t < cur[..., None]), t, BIG_T)
        tbest = tcand.amin(dim=-1)
        jbest = torch.where(tcand == tbest[..., None], iota, c).amin(dim=-1)
        better = tbest < cur
        cid = (cr.ids[blk, i] * SUPER + k)[:, None]
        best[ray_idx] = torch.where(better, tbest, cur)
        tri[ray_idx] = torch.where(better, cid * c + jbest, tri[ray_idx])

    _walk(rows, xf_inv, cr, c, visit)
    return best, tri


def _any_torch(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int):
    """Plain PyTorch version of kernel K3. Returns occ (NB,) int32."""
    occ = torch.zeros(cr.rays8.shape[0], dtype=torch.bool, device=cr.rays8.device)

    def visit(ray_idx, tm, tM, det, up, vp, tp, blk, i, k):
        ok, t = _mt_t(det, up, vp, tp)
        hit = (ok & (t > tm) & (t < tM)).any(dim=-1)
        occ[ray_idx] = occ[ray_idx] | hit

    _walk(rows, xf_inv, cr, c, visit)
    return occ.to(torch.int32)


def _check_sweep(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int):
    dev = cr.rays8.device
    nr, e = cr.ids.shape
    if c > 1024:
        raise ValueError(f"cluster_size {c} exceeds the sweep kernels' 1024 (shared memory)")
    _check(cr.rays8, "rays8", torch.float32, dev, (nr * BLOCK, 8))
    for name in ("ids", "bits_lo", "bits_hi", "rowix", "xfix"):
        _check(getattr(cr, name), name, torch.int32, dev, (nr, e))
    _check(cr.keys, "keys", torch.float32, dev, (nr, e))
    _check(cr.count, "count", torch.int32, dev, (nr, 1))
    _check(xf_inv, "xf_inv", torch.float32, dev, (xf_inv.shape[0], 16))
    _check(rows, "rows", torch.float32, dev, (rows.shape[0], STORE_ROWS, SUPER * c))
    return nr, e


def closest_sweep(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int):
    """Kernel K2. Returns (t (NB,) f32, tri (NB,) int32 slot, vis (NR,) int32
    executed (sub-block, member) visits; vis is None on the CPU)."""
    if cr.rays8.device.type == "cpu":
        t, tri = _closest_torch(rows, xf_inv, cr, c)
        return t, tri, None
    dev_idx, stream = _launch_env(cr.rays8)
    nr, e = _check_sweep(rows, xf_inv, cr, c)
    t = torch.empty((nr * BLOCK,), dtype=torch.float32, device=rows.device)
    tri = torch.empty((nr * BLOCK,), dtype=torch.int32, device=rows.device)
    vis = torch.empty((nr,), dtype=torch.int32, device=rows.device)
    _raise_on(_lib().closest_launch(
        dev_idx, cr.rays8.data_ptr(), cr.ids.data_ptr(), cr.keys.data_ptr(),
        cr.bits_lo.data_ptr(), cr.bits_hi.data_ptr(), cr.rowix.data_ptr(),
        cr.xfix.data_ptr(), cr.count.data_ptr(), xf_inv.data_ptr(), rows.data_ptr(),
        nr, e, c, t.data_ptr(), tri.data_ptr(), vis.data_ptr(), stream), "closest")
    launch_counts["closest"] += 1
    return t, tri, vis


def any_sweep(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int) -> Tensor:
    """Kernel K3. Returns occ (NB,) int32 (1 = occluded)."""
    if cr.rays8.device.type == "cpu":
        return _any_torch(rows, xf_inv, cr, c)
    dev_idx, stream = _launch_env(cr.rays8)
    nr, e = _check_sweep(rows, xf_inv, cr, c)
    occ = torch.empty((nr * BLOCK,), dtype=torch.int32, device=rows.device)
    _raise_on(_lib().any_launch(
        dev_idx, cr.rays8.data_ptr(), cr.keys.data_ptr(), cr.bits_lo.data_ptr(),
        cr.bits_hi.data_ptr(), cr.rowix.data_ptr(), cr.xfix.data_ptr(),
        cr.count.data_ptr(), xf_inv.data_ptr(), rows.data_ptr(), nr, e, c,
        occ.data_ptr(), stream), "any")
    launch_counts["any"] += 1
    return occ


def _no_hier(hier: bool) -> None:
    if hier:
        raise NotImplementedError(
            "the hierarchical (node) cluster walk, kernel K4, is ROADMAP A.12")


def closest_hit_cluster(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16,
                        hier: bool = False) -> HitRecord:
    """Exact closest hit for a ray wavefront (cluster backend)."""
    _no_hier(hier)
    n = o.x.shape[0]
    cr = block_cull(cs, o, d, t_min, t_max)
    t, tri, _ = closest_sweep(cs.rows, cs.xf_inv, cr, cs.cluster_size)
    t = t[:n]
    tri = tri[:n]
    miss = tri < 0
    u, v = _recover_uv(cs, o, d, tri, miss)
    if cs.tri_map is not None:  # slot id -> scene triangle id
        tri = cs.tri_map[torch.clamp(tri, min=0)]
    return HitRecord(t=torch.where(miss, BIG_T, t), tri=torch.where(miss, -1, tri), u=u, v=v)


def any_hit_cluster(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.01, t_max=1e16,
                    hier: bool = False):
    """Occlusion query: (occluded (N,) bool, overflow scalar == 0 always)."""
    _no_hier(hier)
    n = o.x.shape[0]
    cr = block_cull(cs, o, d, t_min, t_max)
    occ = any_sweep(cs.rows, cs.xf_inv, cr, cs.cluster_size)
    return occ[:n] > 0, torch.zeros((), dtype=torch.float32, device=occ.device)


def _recover_uv(cs: ClusterSet, o: Vec3, d: Vec3, tri_slot: Tensor, miss: Tensor):
    """Barycentrics of each ray's winning triangle, re-derived from the same
    Cramer formulas the sweep used (the sweep keeps only t and the slot)."""
    c = cs.cluster_size
    ce = SUPER * c
    slot = torch.clamp(tri_slot, min=0).to(torch.int64)
    eid = slot // ce
    within = slot % ce
    row = cs.entry_row[eid].to(torch.int64)
    g = cs.rows[row, :9, within]  # (N, 9) [v0 | e1 | e2]
    xf = cs.xf_inv[cs.entry_xf[eid]]
    ox = xf[:, 0] * o.x + xf[:, 1] * o.y + xf[:, 2] * o.z + xf[:, 9]
    oy = xf[:, 3] * o.x + xf[:, 4] * o.y + xf[:, 5] * o.z + xf[:, 10]
    oz = xf[:, 6] * o.x + xf[:, 7] * o.y + xf[:, 8] * o.z + xf[:, 11]
    dx = xf[:, 0] * d.x + xf[:, 1] * d.y + xf[:, 2] * d.z
    dy = xf[:, 3] * d.x + xf[:, 4] * d.y + xf[:, 5] * d.z
    dz = xf[:, 6] * d.x + xf[:, 7] * d.y + xf[:, 8] * d.z
    det, up, vp, _ = _mt_block(
        (ox[:, None, None], oy[:, None, None], oz[:, None, None]),
        (dx[:, None, None], dy[:, None, None], dz[:, None, None]),
        g[:, :, None],
    )
    s, _, _, invd = _mt_sign_inv(det[:, 0, 0])
    u = torch.where(miss, 0.0, up[:, 0, 0] * s * invd)
    v = torch.where(miss, 0.0, vp[:, 0, 0] * s * invd)
    return u, v


def reference_closest(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16) -> HitRecord:
    """Dense no-cull oracle: the same M-T math scanned over every entry
    (one entry = one SUPER*C-column cluster here). Independent of the cull
    and the sweep kernels; the exactness gate holds them against it."""
    n = o.x.shape[0]
    dev = o.x.device
    ce = SUPER * cs.cluster_size
    tm = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    tM = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    best = tM.clone()
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    btri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(ce, device=dev, dtype=torch.int32)
    chunk = max(1, _MT_ELEMS // ce)
    for e in range(cs.entry_row.shape[0]):
        tri9 = cs.rows[cs.entry_row[e], :9][None]  # (1, 9, ce)
        xf = cs.xf_inv[cs.entry_xf[e]][None]
        for r0 in range(0, n, chunk):
            sl = slice(r0, r0 + chunk)
            oc, dc = _xform_ray(
                tuple(c[sl][None] for c in o), tuple(c[sl][None] for c in d), xf)
            det, up, vp, tp = _mt_block(
                tuple(x[..., None] for x in oc), tuple(x[..., None] for x in dc), tri9)
            det, up, vp, tp = det[0], up[0], vp[0], tp[0]  # (R, ce)
            s = torch.where(det >= 0.0, 1.0, -1.0)
            ad, us, vs, ts = det * s, up * s, vp * s, tp * s
            pos = ad > 0.0
            invd = torch.where(pos, 1.0 / torch.where(pos, ad, 1.0), 0.0)
            t = ts * invd
            cur = best[sl][:, None]
            cond = (pos & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad)
                    & (t > tm[sl][:, None]) & (t < cur))
            tcand = torch.where(cond, t, BIG_T)
            tbest = tcand.amin(dim=1)
            jbest = torch.where(tcand == tbest[:, None], iota, ce).amin(dim=1)
            better = tbest < best[sl]
            jb = jbest.clamp(max=ce - 1)[:, None].to(torch.int64)
            selu = torch.gather(us * invd, 1, jb)[:, 0]
            selv = torch.gather(vs * invd, 1, jb)[:, 0]
            best[sl] = torch.where(better, tbest, best[sl])
            bu[sl] = torch.where(better, selu, bu[sl])
            bv[sl] = torch.where(better, selv, bv[sl])
            btri[sl] = torch.where(better, e * ce + jbest, btri[sl])
    miss = btri < 0
    tri = btri
    if cs.tri_map is not None:
        tri = cs.tri_map[torch.clamp(btri, min=0)]
    return HitRecord(
        t=torch.where(miss, BIG_T, best),
        tri=torch.where(miss, -1, tri),
        u=torch.where(miss, 0.0, bu),
        v=torch.where(miss, 0.0, bv),
    )
