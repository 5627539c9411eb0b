"""Cluster traversal — exact closest-hit and any-hit for ray wavefronts
(port of optixpathtracer_tpu/ops/traverse_cluster.py).

Rays go in blocks of 128 through two stages, on one of two paths.

Flat path (scenes below HIER_MIN_ENTRIES entries):

  1. CULL (kernel K1, `cull_blocks`): per block, an exact slab test of each
     live ray's [0, t_max] against every cluster AABB; per supercluster
     ("entry") a near-to-far key (box-to-box distance lower bound) and
     per-(16-ray sub-block, member cluster) hit bits. The kernel tests a
     sub-block's rays against an entry's own box first (`group_boxes`,
     `_group_pretest_torch`) and against its members only where that may
     hit, which changes no output. `block_cull` then sorts each block's
     entries by key (stable).
  2. SWEEP (kernels K2 `closest_sweep`, K3 `any_sweep`): per block, walk the
     surviving entries near to far, evaluating exact f32 Moller-Trumbore for
     the (sub-block, member) pairs the cull allowed.

Hierarchical (node) path (K4): NODE entries form a node.

  1. NODE CULL (`block_cull_nodes`): kernel K1 again, with nodes as the
     groups and entries as the members, then the same stable sort.
  2. NODE SWEEP (kernels K4a `closest_hier_sweep`, K4b `any_hier_sweep`):
     per block, walk the surviving nodes near to far; at each node re-cull
     every ray against the node's 64 cluster boxes on its current
     [t_min, t] interval, then run M-T on the clusters each ray still
     reaches, entry k2 = 0..7 and within it member k = 0..7. The kernels
     read staged rows four columns at once and copy 16-byte words, so the
     cluster size must be a multiple of 4 (`_check_hier_sweep`).

Each kernel has a plain PyTorch version here (`_cull_torch`,
`_closest_torch`, `_any_torch`, `_closest_hier_torch`, `_any_hier_torch`)
with the same arithmetic, op for op. A wrapper takes the plain version for
CPU tensors and launches its CUDA kernel (csrc/traverse_cluster.cu) for
CUDA tensors, or raises; there is no fallback from one to the other.
`launch_counts` counts kernel launches. `cull_work`, `sweep_work` and
`sweep_work_hier` count the slab tests and ray-triangle pairs the kernels'
inputs need, the operand of each kernel's compute bound, and for the node
walk the members a block must stage, the operand of its bytes bound.
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
from .cuda_build import check_tensor, launch_env, load, raise_on

Tensor = torch.Tensor

BIG_T = 1e30  # miss sentinel of HitRecord.t (ops/intersect.py)
BLOCK = 128  # rays per block: the lo/hi layout is 8 sub-blocks of 16 (kBlock)
NODE = 8  # entries per node of the hierarchical walk (kNode)
assert NODE == SUPER  # the node cull is K1, whose layout packs groups of 8
HIER_MIN_ENTRIES = 8  # hier=None takes the node walk from this many entries
#   on (read at call time). Measured on the H100 (PERF.md §6, table "C.3
#   (b)"): the node walk rendered every scene of 8 to 4239 entries faster
#   (0.192 against 0.213 s a frame at 8 entries, 0.227 against 0.512 s at
#   4239); at one entry the two walks tie (0.179 against 0.178 s). The
#   reference's 3072 is a TPU-compiler limit.
_BIG = 3.0e37
_MT_ELEMS = 1 << 21  # ray-triangle pairs per plain-sweep chunk (memory bound)
_MT_ELEMS_CUDA = 1 << 24  # the same on a card: 64 MiB a temporary, 8x fewer
#   launches (no ray appears twice in one chunk's pass, so a ray's result and
#   the counted work do not depend on the chunking)


def _mt_elems(dev: torch.device) -> int:
    """Ray-triangle pairs per chunk of the plain walks and the oracle on dev."""
    return _MT_ELEMS_CUDA if dev.type == "cuda" else _MT_ELEMS


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
    # the three axes as rows of one tensor: a third of the launches
    o3 = torch.stack([ox, oy, oz])
    iv = _safe_recip(torch.stack([dx, dy, dz]))
    t0 = (bb[0:3, None] - o3) * iv
    t1 = (bb[3:6, None] - o3) * iv
    entry = torch.clamp(torch.minimum(t0, t1).amax(dim=0), min=0.0)
    exit_ = torch.maximum(t0, t1).amin(dim=0)
    reach_cap = torch.where(exit_ >= entry, torch.clamp(exit_, min=0.0), 0.0)
    tM = torch.minimum(tM, reach_cap * (1.0 + 1e-5) + 1e-6)
    return torch.stack([ox, oy, oz, dx, dy, dz, tm, tM], dim=1)


def sphere_table(cs: ClusterSet) -> Tensor:
    """(8, M) member-major cluster-bounds table: cluster k of super s at
    column k*S + s, rows [cx cy cz r hx hy hz .]."""
    m = cs.spheres.shape[0]
    sn = m // SUPER
    return cs.spheres.reshape(sn, SUPER, 8).transpose(0, 1).reshape(m, 8).T.contiguous()


def group_boxes(sph_t: Tensor) -> Tensor:
    """(8, S) boxes of the groups of a member-major (8, S*8) table, rows
    [cx cy cz . hx hy hz .] like the table's: each contains its 8 member
    boxes in real arithmetic, which the kernel's group pre-test builds on.
    The union is taken in float64; the half extent takes up what rounding
    the centre to float32 moved it, and the float64 roundings, and is
    rounded up."""
    m = sph_t.shape[1]
    t = sph_t.double().reshape(8, SUPER, m // SUPER)
    lo = (t[0:3] - t[4:7]).amin(dim=1)
    hi = (t[0:3] + t[4:7]).amax(dim=1)
    mid = 0.5 * (lo + hi)
    ctr = mid.float()
    half = 0.5 * (hi - lo) + (ctr.double() - mid).abs() + 1e-15 * (lo.abs() + hi.abs())
    half = torch.nextafter(half.float(), torch.full_like(ctr, torch.inf))
    out = torch.zeros((8, m // SUPER), dtype=torch.float32, device=sph_t.device)
    out[0:3] = ctr
    out[4:7] = half
    return out


def _group_pretest_torch(rays8: Tensor, grp_t: Tensor) -> Tensor:
    """Plain PyTorch version of kernel K1's first level, op for op
    (`slab_may_hit`): (NR, 8, S) bool, sub-block s8 of block b holds a live
    ray that may hit a box inside group g's. Conservative: wherever
    `_cull_torch` sets a bit of (s8, member k of g) this is true; false
    lets the kernel skip the group's 8 member tests for the sub-block."""
    nr = rays8.shape[0] // BLOCK
    s = grp_t.shape[1]
    rb = rays8.reshape(nr, BLOCK, 8)
    out = []
    chunk = max(1, (1 << 22) // (BLOCK * s))
    for c0 in range(0, nr, chunk):
        r = rb[c0 : c0 + chunk]
        alive = r[:, :, 7:8] > r[:, :, 6:7]
        t0, t1, mg = [], [], []
        for a in range(3):
            iv = _safe_recip(r[:, :, 3 + a : 4 + a])
            mid = (grp_t[a].reshape(1, 1, s) - r[:, :, a : a + 1]) * iv
            rad = grp_t[4 + a].reshape(1, 1, s) * iv.abs()
            t0.append(mid - rad)
            t1.append(mid + rad)
            mg.append(mid.abs() + rad)
        tn = torch.maximum(torch.maximum(t0[0], t0[1]), torch.clamp(t0[2], min=0.0))
        tf = torch.minimum(torch.minimum(t1[0], t1[1]), torch.minimum(t1[2], r[:, :, 7:8]))
        mag = (mg[0] + mg[1]) + mg[2]
        may = alive & ~(tn > tf + (mag * 1e-5 + 1e-29))
        out.append(may.reshape(-1, 8, BLOCK // 8, s).any(dim=2))
    return torch.cat(out)


def cull_work(rays8: Tensor, sph_t: Tensor, grp_t: Tensor) -> "SweepWork":
    """K1's work on these rays, as slab tests: a group test of every live ray
    against every group, and the 8 member tests of a sub-block's live rays
    for each group its pre-test passes (`SweepWork.slab_tests`). A test of
    every live ray against every member would be live rays x sph_t.shape[1]."""
    nr = rays8.shape[0] // BLOCK
    live = (rays8[:, 7] > rays8[:, 6]).reshape(nr, 8, BLOCK // 8).sum(dim=2)  # (NR, 8)
    passed = _group_pretest_torch(rays8, grp_t).sum(dim=2)  # (NR, 8) groups per sub-block
    return SweepWork(0, 0, int(live.sum()) * grp_t.shape[1] + int((live * passed).sum()) * SUPER)


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


@functools.cache
def _lib():
    lib = load("traverse_cluster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cull_launch.argtypes = [i, p, p, p, i, i, p, p, p, p, p]
    lib.closest_launch.argtypes = [i] + [p] * 10 + [i, i, i] + [p] * 4
    lib.any_launch.argtypes = [i] + [p] * 9 + [i, i, i] + [p] * 2
    lib.closest_hier_launch.argtypes = [i] + [p] * 9 + [i, i, i] + [p] * 4
    lib.any_hier_launch.argtypes = [i] + [p] * 9 + [i, i, i] + [p] * 2
    for fn in (lib.cull_launch, lib.closest_launch, lib.any_launch,
               lib.closest_hier_launch, lib.any_hier_launch):
        fn.restype = ctypes.c_int
    return lib


def cull_blocks(rays8: Tensor, sph_t: Tensor, grp_t: Tensor):
    """Kernel K1 on the member table sph_t and its groups' boxes grp_t
    (`group_boxes(sph_t)`, which only the kernel reads). Returns (key (NR, S)
    f32, lo (NR, S) int32, hi, count (NR, 1))."""
    nr = rays8.shape[0] // BLOCK
    m = sph_t.shape[1]
    s = m // SUPER
    check_tensor(grp_t, "grp_t", torch.float32, rays8.device, (8, s))
    if rays8.device.type == "cpu":
        return _cull_torch(rays8, sph_t)
    dev_idx, stream = launch_env(rays8)
    check_tensor(rays8, "rays8", torch.float32, rays8.device, (nr * BLOCK, 8))
    check_tensor(sph_t, "sph_t", torch.float32, rays8.device, (8, s * SUPER))
    if rays8.data_ptr() % 16:
        raise ValueError("rays8 must start on a 16-byte boundary (the cull reads a ray as two 16-byte words)")
    key = torch.empty((nr, s), dtype=torch.float32, device=rays8.device)
    lo = torch.empty((nr, s), dtype=torch.int32, device=rays8.device)
    hi = torch.empty_like(lo)
    count = torch.empty((nr, 1), dtype=torch.int32, device=rays8.device)
    raise_on(_lib().cull_launch(
        dev_idx, rays8.data_ptr(), sph_t.data_ptr(), grp_t.data_ptr(), nr, m, key.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), count.data_ptr(), stream), "cull")
    launch_counts["cull"] += 1
    return key, lo, hi, count


def _sort_cull(key: Tensor, lo: Tensor, hi: Tensor):
    """Each block's groups near to far: a stable sort of the keys (ties keep
    group order, as lax.sort does) and the bit words moved along. Returns
    (order (NR, S) int64, keys, lo, hi)."""
    keys, order = torch.sort(key, dim=1, stable=True)
    return order, keys, torch.gather(lo, 1, order), torch.gather(hi, 1, order)


def block_cull(cs: ClusterSet, o: Vec3, d: Vec3, t_min, t_max) -> CullResult:
    """Stage 1: the per-block cull, then each block's entries sorted
    near-to-far (`_sort_cull`)."""
    rays8 = _pack_rays8(cs, o, d, t_min, t_max)
    key, lo, hi, count = cull_blocks(rays8, *cs.cull_tables)
    order, keys, lo, hi = _sort_cull(key, lo, hi)
    return CullResult(
        ids=order.to(torch.int32),
        keys=keys,
        bits_lo=lo,
        bits_hi=hi,
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
    pair_chunk = max(1, _mt_elems(dev) // (sb * c))
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


class SweepWork(NamedTuple):
    """The work a sweep's inputs need, counted by `sweep_work` /
    `sweep_work_hier`: the operands of each kernel's compute bound and of
    the node walk's bytes bound."""

    pairs: int  # ray-triangle pairs a running ray evaluates (any-hit: up to
    #   and including its first hit in the member's column order)
    visits: int  # executed (16-ray sub-block, member) visits: Σ vis of K2/K4a
    slab_tests: int = 0  # ray-box slab tests of the node walk's re-cull
    lane_pairs: int = 0  # pairs at sub-block granularity: per visit, 16 lanes x
    #   the columns its longest-running ray needs (C for closest-hit)
    nodes: int = 0  # node walk: (block, node) visits, each staging the node's boxes
    staged: int = 0  # node walk: members a block stages, i.e. (block, node,
    #   cluster column) triples in which some ray of the block runs the member

    @property
    def ops(self) -> int:
        return self.pairs * MT_OPS + self.slab_tests * SLAB_OPS

    def staged_bytes(self, c: int) -> int:
        """Bytes the node walk's staging must move: 9 x C f32 per staged
        member, and per node visit the six box rows the re-cull reads."""
        return self.staged * 9 * c * 4 + self.nodes * 6 * NODE * SUPER * 4


MT_OPS = 45  # FP32 mul/add/sub of one M-T pair up to its edge tests (un-fused; the
#   divide runs only for the ~0.4 % of pairs that pass them and is not counted)
SLAB_OPS = 24  # FP32 sub/mul/add/min/max of one ray-box slab test (K1, the re-cull); K1's
#   group test counts as one, its 6 operations of slack arithmetic are not counted


def _run_visit(work: list, go, ok, t, tm, tM, ray_idx, best, occ, c: int, any_hit: bool):
    """One (block, sub-block) visit of `sweep_work` / `sweep_work_hier`: the
    closest-hit (best) or any-hit (occ) epilogue for the running rays `go`
    (P, 16), and their work added to work = [pairs, visits, slab tests,
    lane pairs], summed on the rays' device (no synchronise a visit)."""
    if any_hit:
        hit = ok & (t > tm) & (t < tM)
        first = torch.where(hit, torch.arange(c, device=hit.device), c).amin(dim=-1)
        cols = torch.where(go, torch.clamp(first + 1, max=c), 0)  # up to the first hit
        occ[ray_idx] = occ[ray_idx] | (go & hit.any(dim=-1))
    else:
        cur = best[ray_idx]
        cols = go * c
        tbest = torch.where(ok & (t > tm) & (t < cur[..., None]), t, BIG_T).amin(dim=-1)
        best[ray_idx] = torch.where(go & (tbest < cur), tbest, cur)
    work[0] = work[0] + cols.sum()
    work[1] = work[1] + go.any(dim=1).sum()
    work[3] = work[3] + cols.amax(dim=1).sum() * (BLOCK // 8)


def sweep_work(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int, any_hit: bool = False):
    """SweepWork of K2 (any_hit=False) or K3 on a CullResult: `_walk` with
    the kernels' per-ray gate applied in their visit order. A ray runs a
    member when its sub-block's bit is set and its key gate passes (K2:
    key <= best * |d|, with best as the member's turn finds it; K3: not yet
    occluded and key <= t_max * |d|); a sub-block visit counts when one of
    its 16 rays runs. Pairs of K2 are C per running ray; those of K3 stop at
    the ray's first hit."""
    best = cr.rays8[:, 7].clone()
    occ = torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    dlen = _dlen(cr.rays8)
    reach = torch.clamp(best * dlen, max=_BIG)
    work = [0, 0, 0, 0]  # pairs, visits, slab tests, lane pairs

    def visit(ray_idx, tm, tM, det, up, vp, tp, blk, i, k):
        key = cr.keys[blk, i][:, None]
        if any_hit:
            go = ~occ[ray_idx] & (key <= reach[ray_idx])
        else:
            go = key <= torch.clamp(best[ray_idx] * dlen[ray_idx], max=_BIG)
        _run_visit(work, go, *_mt_t(det, up, vp, tp), tm, tM, ray_idx, best, occ, c, any_hit)

    _walk(rows, xf_inv, cr, c, visit)
    return SweepWork(*(int(w) for w in work))


def _check_sweep(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int):
    dev = cr.rays8.device
    nr, e = cr.ids.shape
    if c > 1024:
        raise ValueError(f"cluster_size {c} exceeds the sweep kernels' 1024 (shared memory)")
    if c % 4:
        raise ValueError(f"cluster_size {c} is not a multiple of 4 (the sweeps read 4 columns at once)")
    check_tensor(cr.rays8, "rays8", torch.float32, dev, (nr * BLOCK, 8))
    for name in ("ids", "bits_lo", "bits_hi", "rowix", "xfix"):
        check_tensor(getattr(cr, name), name, torch.int32, dev, (nr, e))
    check_tensor(cr.keys, "keys", torch.float32, dev, (nr, e))
    check_tensor(cr.count, "count", torch.int32, dev, (nr, 1))
    check_tensor(xf_inv, "xf_inv", torch.float32, dev, (xf_inv.shape[0], 16))
    check_tensor(rows, "rows", torch.float32, dev, (rows.shape[0], STORE_ROWS, SUPER * c))
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the sweeps copy 16-byte words)")
    return nr, e


def closest_sweep(rows: Tensor, xf_inv: Tensor, cr: CullResult, c: int):
    """Kernel K2. Returns (t (NB,) f32, tri (NB,) int32 slot, vis (NR,) int32
    executed (sub-block, member) visits; vis is None on the CPU)."""
    if cr.rays8.device.type == "cpu":
        t, tri = _closest_torch(rows, xf_inv, cr, c)
        return t, tri, None
    dev_idx, stream = launch_env(cr.rays8)
    nr, e = _check_sweep(rows, xf_inv, cr, c)
    t = torch.empty((nr * BLOCK,), dtype=torch.float32, device=rows.device)
    tri = torch.empty((nr * BLOCK,), dtype=torch.int32, device=rows.device)
    vis = torch.empty((nr,), dtype=torch.int32, device=rows.device)
    raise_on(_lib().closest_launch(
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
    dev_idx, stream = launch_env(cr.rays8)
    nr, e = _check_sweep(rows, xf_inv, cr, c)
    occ = torch.empty((nr * BLOCK,), dtype=torch.int32, device=rows.device)
    raise_on(_lib().any_launch(
        dev_idx, cr.rays8.data_ptr(), cr.keys.data_ptr(), cr.bits_lo.data_ptr(),
        cr.bits_hi.data_ptr(), cr.rowix.data_ptr(), cr.xfix.data_ptr(),
        cr.count.data_ptr(), xf_inv.data_ptr(), rows.data_ptr(), nr, e, c,
        occ.data_ptr(), stream), "any")
    launch_counts["any"] += 1
    return occ


# --------------------------------------------------------------------------
# Hierarchical (node) path: node cull, then the node sweep with its inline
# cluster re-cull (reference :1030-1576)
# --------------------------------------------------------------------------

class NodeTables(NamedTuple):
    """Node-granularity tables of a ClusterSet (`ClusterSet.node_tables`)."""

    node_sph_t: Tensor  # (8, E8) f32 member-major entry boxes: entry k2 of
    #   node j at column k2*N2 + j (the node cull's `sph_t`)
    csph: Tensor  # (N2, 8, NODE*SUPER) f32 per-node cluster boxes, cluster
    #   (k2, k) at column k2*SUPER + k, rows [cx cy cz r hx hy hz .]
    erow2: Tensor  # (1, E8) int32 entry -> triangle-rows index
    exf2: Tensor  # (1, E8) int32 entry -> transform id
    node_box_t: Tensor  # (8, N2) f32 the nodes' own boxes, `group_boxes(node_sph_t)`
    #   (the node cull's `grp_t`)


class NodeCullResult(NamedTuple):
    ids: Tensor  # (NR, N2) int32 node ids, survivors first, near-to-far
    keys: Tensor  # (NR, N2) f32 sorted node distance lower bounds
    bits_lo: Tensor  # (NR, N2) int32 bit pattern of the uint32 entry masks of
    #   sub-blocks 0-3: entry k2 of sub-block s at bit (s%4)*8 + k2
    bits_hi: Tensor  # (NR, N2) same for sub-blocks 4-7
    count: Tensor  # (NR, 1) int32 number of surviving nodes
    rays8: Tensor  # (NR*B, 8) f32 [o(3), d(3), t_min, t_max]


def _node_tables(cs: ClusterSet) -> NodeTables:
    """Entries padded to whole nodes with far-sentinel boxes (center _BIG/2,
    zero extent: the slab test's tf is capped at the ray's reach, so tn > tf
    and a sentinel is never visited)."""
    e = cs.num_entries
    n2 = -(-e // NODE)
    e8 = n2 * NODE
    ss, sp, erow, exf = cs.super_spheres, cs.spheres, cs.entry_row, cs.entry_xf
    if e8 > e:
        sent = torch.zeros(((e8 - e) * SUPER, 8), dtype=torch.float32, device=ss.device)
        sent[:, 0] = _BIG / 2
        ss = torch.cat([ss, sent[: e8 - e]])
        sp = torch.cat([sp, sent])
        zi = torch.zeros((e8 - e,), dtype=torch.int32, device=ss.device)
        erow, exf = torch.cat([erow, zi]), torch.cat([exf, zi])
    node_sph_t = ss.reshape(n2, NODE, 8).transpose(0, 1).reshape(e8, 8).T.contiguous()
    return NodeTables(
        node_sph_t=node_sph_t,
        node_box_t=group_boxes(node_sph_t),
        csph=sp.reshape(n2, NODE * SUPER, 8).transpose(1, 2).contiguous(),
        erow2=erow[None].contiguous(),
        exf2=exf[None].contiguous(),
    )


def block_cull_nodes(cs: ClusterSet, o: Vec3, d: Vec3, t_min, t_max) -> NodeCullResult:
    """Stage 1 of the node walk: kernel K1 with nodes as the groups and
    entries as the members (64x fewer columns than the flat cull), then a
    stable sort of each block's nodes near-to-far."""
    rays8 = _pack_rays8(cs, o, d, t_min, t_max)
    nt = cs.node_tables
    key, lo, hi, count = cull_blocks(rays8, nt.node_sph_t, nt.node_box_t)
    order, keys, lo, hi = _sort_cull(key, lo, hi)
    return NodeCullResult(ids=order.to(torch.int32), keys=keys, bits_lo=lo, bits_hi=hi,
                          count=count, rays8=rays8)


def _node_recull(r: Tensor, tcur: Tensor, nsph: Tensor) -> Tensor:
    """Exact slab test of each ray's current [0, tcur] (live while
    tcur > t_min) against one node's cluster boxes. r: (nl, B, 8) rays,
    tcur: (nl, B), nsph: (nl, 8, 64). Returns (nl, B, 64) bool."""
    alive = (tcur > r[:, :, 6])[..., None]
    t0, t1 = [], []
    for a in range(3):
        iv = _safe_recip(r[:, :, 3 + a : 4 + a])
        mid = (nsph[:, a : a + 1] - r[:, :, a : a + 1]) * iv
        rad = nsph[:, 4 + a : 5 + a] * iv.abs()
        t0.append(mid - rad)
        t1.append(mid + rad)
    tn = torch.maximum(torch.maximum(t0[0], t0[1]), torch.clamp(t0[2], min=0.0))
    tf = torch.minimum(torch.minimum(t1[0], t1[1]), torch.minimum(t1[2], tcur[..., None]))
    return alive & (tn <= tf + tf.abs() * 4e-7 + 1e-30)


def _walk_hier(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult, c: int,
               tcur_of, bound_of, visit, on_recull=None):
    """Shared plain walk of `_closest_hier_torch` / `_any_hier_torch`.

    For each sorted node position i, the blocks still walking (i < count and
    key <= the block's bound, as the kernels' early exit) re-cull their rays
    against the node's 64 cluster boxes on [t_min, tcur_of()]
    (`on_recull(rays, tcur)` sees each such (nl, B, 8) / (nl, B) batch).
    Then for each cluster column j = k2*SUPER + k in order, every (block,
    16-ray sub-block) pair holding a ray whose bit j is set gets M-T against
    the member's C triangles, and `visit(ray_idx, gate, tm, tM, det, up, vp,
    tp, cid)` applies the epilogue to the rays with `gate` set."""
    sb = BLOCK // 8
    nr, n2 = cr.ids.shape
    dev = cr.rays8.device
    rays = cr.rays8.reshape(nr, BLOCK, 8)
    lane = torch.arange(sb, device=dev)
    pair_chunk = max(1, _mt_elems(dev) // (sb * c))
    recull_chunk = max(1, (1 << 22) // (BLOCK * NODE * SUPER))  # blocks per re-cull
    walking = torch.ones(nr, dtype=torch.bool, device=dev)
    for i in range(n2):
        walking &= (cr.count[:, 0] > i) & (cr.keys[:, i] <= bound_of())
        live = torch.nonzero(walking)[:, 0]
        if live.numel() == 0:
            break
        nid = cr.ids[live, i].to(torch.int64)
        tcur = tcur_of().reshape(nr, BLOCK)
        if on_recull is not None:
            on_recull(rays[live], tcur[live])
        hit = torch.cat([
            _node_recull(rays[live[b0 : b0 + recull_chunk]], tcur[live[b0 : b0 + recull_chunk]],
                         nt.csph[nid[b0 : b0 + recull_chunk]])
            for b0 in range(0, live.numel(), recull_chunk)
        ])  # (nl, B, 64)
        sub_hit = hit.reshape(-1, 8, sb, NODE * SUPER).any(dim=2)  # (nl, 8, 64)
        for j in torch.nonzero(sub_hit.any(dim=(0, 1)))[:, 0].tolist():
            k2, k = divmod(j, SUPER)
            bi_all, sub_all = torch.nonzero(sub_hit[:, :, j], as_tuple=True)
            tri_rows = rows[:, :9, k * c : (k + 1) * c]
            for p0 in range(0, bi_all.numel(), pair_chunk):
                bi = bi_all[p0 : p0 + pair_chunk]
                sub = sub_all[p0 : p0 + pair_chunk]
                ray_idx = live[bi][:, None] * BLOCK + sub[:, None] * sb + lane  # (P, 16)
                gate = hit[bi[:, None], sub[:, None] * sb + lane, j]  # (P, 16)
                r = cr.rays8[ray_idx]  # (P, 16, 8)
                e = nid[bi] * NODE + k2
                oc, dc = _xform_ray(
                    (r[..., 0], r[..., 1], r[..., 2]), (r[..., 3], r[..., 4], r[..., 5]),
                    xf_inv[nt.exf2[0, e]],
                )
                det, up, vp, tp = _mt_block(
                    tuple(x[..., None] for x in oc), tuple(x[..., None] for x in dc),
                    tri_rows[nt.erow2[0, e]],
                )
                visit(ray_idx, gate, r[..., 6:7], r[..., 7:8], det, up, vp, tp,
                      (e * SUPER + k).to(torch.int32))


def _dlen(rays8: Tensor) -> Tensor:
    d = rays8[:, 3:6]
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])


def _closest_hier_torch(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult,
                        c: int):
    """Plain PyTorch version of kernel K4a. Returns (t (NB,), tri (NB,) slot
    ids, -1 on miss). Visit order: node key (stable), entry k2, member k,
    column; strict < across members, lowest column within one."""
    best = cr.rays8[:, 7].clone()
    tri = torch.full_like(best, -1, dtype=torch.int32)
    iota = torch.arange(c, device=best.device, dtype=torch.int32)
    dlen = _dlen(cr.rays8)

    def bound():
        return torch.clamp(best * dlen, max=_BIG).reshape(-1, BLOCK).amax(dim=1)

    def visit(ray_idx, gate, tm, tM, det, up, vp, tp, cid):
        ok, t = _mt_t(det, up, vp, tp)
        cur = best[ray_idx]  # (P, 16)
        tcand = torch.where(ok & (t > tm) & (t < cur[..., None]), t, BIG_T)
        tbest = tcand.amin(dim=-1)
        jbest = torch.where(tcand == tbest[..., None], iota, c).amin(dim=-1)
        better = gate & (tbest < cur)
        best[ray_idx] = torch.where(better, tbest, cur)
        tri[ray_idx] = torch.where(better, cid[:, None] * c + jbest, tri[ray_idx])

    _walk_hier(rows, xf_inv, nt, cr, c, lambda: best, bound, visit)
    return best, tri


def _any_hier_torch(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult,
                    c: int):
    """Plain PyTorch version of kernel K4b. Returns occ (NB,) int32. An
    occluded ray's interval closes (tcur = t_min), so it drops out of the
    re-cull and of the early-exit bound."""
    occ = torch.zeros(cr.rays8.shape[0], dtype=torch.bool, device=cr.rays8.device)
    tm_all, tM_all = cr.rays8[:, 6], cr.rays8[:, 7]
    reach = torch.clamp(tM_all * _dlen(cr.rays8), max=_BIG)

    def bound():
        return torch.where(occ, 0.0, reach).reshape(-1, BLOCK).amax(dim=1)

    def visit(ray_idx, gate, tm, tM, det, up, vp, tp, cid):
        ok, t = _mt_t(det, up, vp, tp)
        hit = (ok & (t > tm) & (t < tM)).any(dim=-1)
        occ[ray_idx] = occ[ray_idx] | (gate & hit)

    _walk_hier(rows, xf_inv, nt, cr, c, lambda: torch.where(occ, tm_all, tM_all), bound, visit)
    return occ.to(torch.int32)


def sweep_work_hier(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult, c: int,
                    any_hit: bool = False) -> SweepWork:
    """SweepWork of K4a (any_hit=False) or K4b on a NodeCullResult: `_walk_hier`
    with the kernels' gates. Each node a block visits re-culls its rays still
    open (t_min < t) against 64 boxes; a ray runs a cluster its re-cull bit
    names (K4b: while not occluded), with pairs counted as in `sweep_work`.
    A block stages a member when one of its rays runs it. The counts stay on
    the rays' device until the walk ends (no host read a visit)."""
    best = cr.rays8[:, 7].clone()
    occ = torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    tm_all, tM_all = cr.rays8[:, 6], cr.rays8[:, 7]
    dlen = _dlen(cr.rays8)
    work = [0, 0, 0, 0, 0, 0]  # pairs, visits, slab tests, lane pairs, nodes, staged
    # the last (block, cluster) counted as staged, as block << 32 | cluster
    last = [torch.full((), -1, dtype=torch.int64, device=best.device)]

    def bound():
        if any_hit:
            return torch.where(occ, 0.0, torch.clamp(tM_all * dlen, max=_BIG)).reshape(-1, BLOCK).amax(dim=1)
        return torch.clamp(best * dlen, max=_BIG).reshape(-1, BLOCK).amax(dim=1)

    def on_recull(rays, tcur):
        work[2] = work[2] + (tcur > rays[:, :, 6]).sum() * (NODE * SUPER)
        work[4] += rays.shape[0]

    def visit(ray_idx, gate, tm, tM, det, up, vp, tp, cid):
        go = gate & ~occ[ray_idx] if any_hit else gate
        # the pairs of one cluster column come sorted by block, and a block
        # meets a cluster once in a walk: count each (block, cluster) once,
        # also across the chunks of one column: a running pair is new where
        # it differs from the running pair before it (`last` before the first)
        run = go.any(dim=1)
        key = (ray_idx[:, 0] // BLOCK) << 32 | cid.to(torch.int64)
        at = torch.where(run, torch.arange(run.shape[0], device=run.device), -1).cummax(dim=0).values
        before = torch.cat([last[0].reshape(1), torch.where(at[:-1] >= 0, key[at[:-1].clamp(min=0)], last[0])])
        work[5] = work[5] + (run & (key != before)).sum()
        last[0] = torch.where(at[-1] >= 0, key[at[-1].clamp(min=0)], last[0])
        _run_visit(work, go, *_mt_t(det, up, vp, tp), tm, tM, ray_idx, best, occ, c, any_hit)

    tcur_of = (lambda: torch.where(occ, tm_all, tM_all)) if any_hit else (lambda: best)
    _walk_hier(rows, xf_inv, nt, cr, c, tcur_of, bound, visit, on_recull)
    return SweepWork(*(int(w) for w in work))


def _check_hier_sweep(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult, c: int):
    dev = cr.rays8.device
    nr, n2 = cr.ids.shape
    if c > 1024:
        raise ValueError(f"cluster_size {c} exceeds the sweep kernels' 1024 (shared memory)")
    if c % 4:
        raise ValueError(f"cluster_size {c} is not a multiple of 4 (the sweeps read 4 columns at once)")
    check_tensor(cr.rays8, "rays8", torch.float32, dev, (nr * BLOCK, 8))
    check_tensor(cr.ids, "ids", torch.int32, dev, (nr, n2))
    check_tensor(cr.keys, "keys", torch.float32, dev, (nr, n2))
    check_tensor(cr.count, "count", torch.int32, dev, (nr, 1))
    check_tensor(nt.erow2, "erow2", torch.int32, dev, (1, n2 * NODE))
    check_tensor(nt.exf2, "exf2", torch.int32, dev, (1, n2 * NODE))
    check_tensor(nt.csph, "csph", torch.float32, dev, (n2, 8, NODE * SUPER))
    check_tensor(xf_inv, "xf_inv", torch.float32, dev, (xf_inv.shape[0], 16))
    check_tensor(rows, "rows", torch.float32, dev, (rows.shape[0], STORE_ROWS, SUPER * c))
    if rows.data_ptr() % 16 or nt.csph.data_ptr() % 16:
        raise ValueError("rows and csph must start on a 16-byte boundary (the sweeps copy 16-byte words)")
    return nr, n2


def closest_hier_sweep(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult, c: int):
    """Kernel K4a. Returns (t (NB,) f32, tri (NB,) int32 slot, vis (NR,) int32
    executed (sub-block, member) visits; vis is None on the CPU)."""
    if cr.rays8.device.type == "cpu":
        t, tri = _closest_hier_torch(rows, xf_inv, nt, cr, c)
        return t, tri, None
    dev_idx, stream = launch_env(cr.rays8)
    nr, n2 = _check_hier_sweep(rows, xf_inv, nt, cr, c)
    t = torch.empty((nr * BLOCK,), dtype=torch.float32, device=rows.device)
    tri = torch.empty((nr * BLOCK,), dtype=torch.int32, device=rows.device)
    vis = torch.empty((nr,), dtype=torch.int32, device=rows.device)
    raise_on(_lib().closest_hier_launch(
        dev_idx, cr.rays8.data_ptr(), cr.ids.data_ptr(), cr.keys.data_ptr(),
        cr.count.data_ptr(), nt.erow2.data_ptr(), nt.exf2.data_ptr(), nt.csph.data_ptr(),
        xf_inv.data_ptr(), rows.data_ptr(), nr, n2, c, t.data_ptr(), tri.data_ptr(),
        vis.data_ptr(), stream), "closest_hier")
    launch_counts["closest_hier"] += 1
    return t, tri, vis


def any_hier_sweep(rows: Tensor, xf_inv: Tensor, nt: NodeTables, cr: NodeCullResult,
                   c: int) -> Tensor:
    """Kernel K4b. Returns occ (NB,) int32 (1 = occluded)."""
    if cr.rays8.device.type == "cpu":
        return _any_hier_torch(rows, xf_inv, nt, cr, c)
    dev_idx, stream = launch_env(cr.rays8)
    nr, n2 = _check_hier_sweep(rows, xf_inv, nt, cr, c)
    occ = torch.empty((nr * BLOCK,), dtype=torch.int32, device=rows.device)
    raise_on(_lib().any_hier_launch(
        dev_idx, cr.rays8.data_ptr(), cr.ids.data_ptr(), cr.keys.data_ptr(),
        cr.count.data_ptr(), nt.erow2.data_ptr(), nt.exf2.data_ptr(), nt.csph.data_ptr(),
        xf_inv.data_ptr(), rows.data_ptr(), nr, n2, c, occ.data_ptr(), stream), "any_hier")
    launch_counts["any_hier"] += 1
    return occ


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _hit_record(cs: ClusterSet, o: Vec3, d: Vec3, t: Tensor, tri: Tensor) -> HitRecord:
    """HitRecord from a sweep's padded (t, tri slot) outputs."""
    n = o.x.shape[0]
    t = t[:n]
    tri = tri[:n]
    miss = tri < 0
    u, v = _recover_uv(cs, o, d, tri, miss)
    if cs.tri_map is not None:  # slot id -> scene triangle id
        tri = cs.tri_map[torch.clamp(tri, min=0)]
    return HitRecord(t=torch.where(miss, BIG_T, t), tri=torch.where(miss, -1, tri), u=u, v=v)


def _no_overflow(occ: Tensor) -> Tensor:
    return torch.zeros((), dtype=torch.float32, device=occ.device)


def closest_hit_cluster_hier(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.001,
                             t_max=1e16) -> HitRecord:
    """Exact closest hit, hierarchical (node) walk."""
    cr = block_cull_nodes(cs, o, d, t_min, t_max)
    t, tri, _ = closest_hier_sweep(cs.rows, cs.xf_inv, cs.node_tables, cr, cs.cluster_size)
    return _hit_record(cs, o, d, t, tri)


def any_hit_cluster_hier(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.01, t_max=1e16):
    """Occlusion query, hierarchical (node) walk: (occluded (N,), 0)."""
    cr = block_cull_nodes(cs, o, d, t_min, t_max)
    occ = any_hier_sweep(cs.rows, cs.xf_inv, cs.node_tables, cr, cs.cluster_size)
    return occ[: o.x.shape[0]] > 0, _no_overflow(occ)


def closest_hit_cluster(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16,
                        hier: bool | None = None) -> HitRecord:
    """Exact closest hit for a ray wavefront (cluster backend). hier=None
    takes the node walk for scenes of >= HIER_MIN_ENTRIES entries."""
    if hier is None:
        hier = cs.num_entries >= HIER_MIN_ENTRIES
    if hier:
        return closest_hit_cluster_hier(cs, o, d, t_min, t_max)
    cr = block_cull(cs, o, d, t_min, t_max)
    t, tri, _ = closest_sweep(cs.rows, cs.xf_inv, cr, cs.cluster_size)
    return _hit_record(cs, o, d, t, tri)


def closest_hit_cluster_exec_stats(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16,
                                   hier: bool | None = None):
    """Closest-hit sweep returning (t, exec_pair_evals): the sweep's padded
    t (NB,) and the EXECUTED ray-triangle pair count, from the kernels' own
    per-block visit counters. Same walk and routing as
    `closest_hit_cluster` (hier=None: the node walk from HIER_MIN_ENTRIES).

    On a card the count is Σ vis of K2 / K4a; on the CPU, where the plain
    versions return no vis, it is `sweep_work` / `sweep_work_hier`'s visits,
    which count the same visits. Unit: a visit here is one 16-ray sub-block
    running one member, so the count is Σ vis x 16 x C (= SweepWork.lane_pairs
    of closest-hit), where the reference counts (block // groups) x C per
    visit of its 128-ray (or 64-ray) blocks. A Python int, exact at any size
    (the reference's f32 sum rounds above 2**24)."""
    if hier is None:
        hier = cs.num_entries >= HIER_MIN_ENTRIES
    c = cs.cluster_size
    if hier:
        args = (cs.rows, cs.xf_inv, cs.node_tables, block_cull_nodes(cs, o, d, t_min, t_max), c)
        sweep, work = closest_hier_sweep, sweep_work_hier
    else:
        args = (cs.rows, cs.xf_inv, block_cull(cs, o, d, t_min, t_max), c)
        sweep, work = closest_sweep, sweep_work
    t, _, vis = sweep(*args)
    visits = work(*args).visits if vis is None else int(vis.sum(dtype=torch.int64))
    return t, visits * (BLOCK // 8) * c


def any_hit_cluster(cs: ClusterSet, o: Vec3, d: Vec3, t_min=0.01, t_max=1e16,
                    hier: bool | None = None):
    """Occlusion query: (occluded (N,) bool, overflow scalar == 0 always).
    hier=None routes as `closest_hit_cluster` does."""
    if hier is None:
        hier = cs.num_entries >= HIER_MIN_ENTRIES
    if hier:
        return any_hit_cluster_hier(cs, o, d, t_min, t_max)
    cr = block_cull(cs, o, d, t_min, t_max)
    occ = any_sweep(cs.rows, cs.xf_inv, cr, cs.cluster_size)
    return occ[: o.x.shape[0]] > 0, _no_overflow(occ)


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
    chunk = max(1, _mt_elems(dev) // ce)
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
