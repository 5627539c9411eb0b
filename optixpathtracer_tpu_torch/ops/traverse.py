"""The lockstep BVH walk (port of optixpathtracer_tpu/ops/traverse.py): the
exact closest-hit and occlusion queries over the binary LBVH (bvh/lbvh.py),
the reference's default backend and the walk that rendered every golden.

The whole wavefront walks in lockstep. Each ray owns a fixed-depth stack,
one row of an (N, STACK_DEPTH) int32 tensor; every iteration pops one entry
per ray, fetches that node's two child boxes (stored at the parent),
slab-tests both against the ray's current best t, and pushes far then near,
so the near child pops first. A leaf reference (negative) runs Möller–
Trumbore on its K contiguous triangles. Everything is masked and of fixed
shape; the loop ends when no ray has a stack entry left (any-hit: or every
ray has its hit).

Semantics kept from the reference: the push saturates at STACK_DEPTH - 1
and then overwrites the top entry (build_bvh asserts the tree fits, so this
is never reached on a built tree); the near child is the one whose box
centre projects nearer along the ray (`dist_l <= dist_r`, left on a tie);
within a leaf the first of equal t wins (argmin), across leaves only a
strictly smaller t replaces the best.

Each ray's walk is its own, and a finished ray neither pops, pushes nor
updates again. So the loop works on the rays still walking: whenever at
most half of the working set is live, the finished rays' results are
written out and the set shrinks to the live ones, which changes no result.
The loop condition (and that count) needs the device's answer on the
host, a synchronisation with a card: it is read every CHECK_EVERY
iterations rather than every one, the iterations in between being no-ops
for finished rays. On a card the iteration is captured once per working
set as a CUDA graph and replayed (the same kernels on the same tensors,
without the host's launch cost per operation). `walk_stats` counts the
sweeps and iterations run.
"""
from __future__ import annotations

import torch

from ..bvh.lbvh import BVH, TRAVERSAL_STACK_DEPTH
from ..core.math import Vec3
from ..core.scene import SceneData
from .intersect import BIG_T, ray_aabb, ray_triangle
from .traverse_cluster import HitRecord

Tensor = torch.Tensor

STACK_DEPTH = TRAVERSAL_STACK_DEPTH  # build_bvh asserts tree depth fits this
ROOT_REF = 0  # internal node 0 is always the Karras root
CHECK_EVERY = 8  # iterations between reads of the loop condition
walk_stats = {"sweeps": 0, "iterations": 0}


def _f32(x, n: int, dev) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(n).contiguous()


def _safe_inv(x: Tensor) -> Tensor:
    return 1.0 / torch.where(x.abs() > 1e-20, x, 1e-20)


def _traverse(bvh: BVH, scene: SceneData, o: Vec3, d: Vec3, t_min, t_max, any_hit: bool) -> HitRecord:
    n = o.x.shape[0]
    dev = o.x.device
    k = bvh.leaf_size
    m = bvh.num_internal
    walk_stats["sweeps"] += 1
    kk = torch.arange(k, dtype=torch.int64, device=dev)
    out_t = _f32(t_max, n, dev).clone()
    out_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v = torch.zeros_like(out_u)

    # the working set: every ray at first, then only the rays still walking
    # (a finished ray never walks again, and each ray's walk is its own)
    w = dict(idx=torch.arange(n, device=dev), ox=o.x, oy=o.y, oz=o.z, dx=d.x, dy=d.y, dz=d.z,
             ix=_safe_inv(d.x), iy=_safe_inv(d.y), iz=_safe_inv(d.z), t_min=_f32(t_min, n, dev),
             best_t=out_t.clone(), best_tri=out_tri.clone(), best_u=out_u.clone(), best_v=out_v.clone(),
             stack=torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev),  # root 0
             sp=torch.ones((n,), dtype=torch.int64, device=dev))  # 0 == done

    def body(w):
        o = Vec3(w["ox"], w["oy"], w["oz"])
        d = Vec3(w["dx"], w["dy"], w["dz"])
        stack, sp, best_t, t_min = w["stack"], w["sp"], w["best_t"], w["t_min"]
        active = sp > 0
        if any_hit:
            active = active & (w["best_tri"] < 0)
        sp1 = sp - 1
        ref = torch.gather(stack, 1, torch.clamp(sp1, min=0)[:, None])[:, 0]
        sp = torch.where(active, sp1, sp)
        is_leaf = ref < 0
        do_node = active & ~is_leaf
        do_leaf = active & is_leaf

        # internal node: test both children, push far then near
        node = torch.clamp(ref, 0, m - 1).to(torch.int64)
        cl, cr = bvh.child_left[node], bvh.child_right[node]
        lmin = Vec3(*(c[node] for c in bvh.left_min))
        lmax = Vec3(*(c[node] for c in bvh.left_max))
        rmin = Vec3(*(c[node] for c in bvh.right_min))
        rmax = Vec3(*(c[node] for c in bvh.right_max))
        inv_d = Vec3(w["ix"], w["iy"], w["iz"])
        hit_l = do_node & ray_aabb(o, inv_d, lmin, lmax, t_min, best_t)
        hit_r = do_node & ray_aabb(o, inv_d, rmin, rmax, t_min, best_t)
        # near child by box centres projected on the ray
        dist_l = (((lmin.x + lmax.x) * 0.5 - o.x) * d.x + ((lmin.y + lmax.y) * 0.5 - o.y) * d.y
                  + ((lmin.z + lmax.z) * 0.5 - o.z) * d.z)
        dist_r = (((rmin.x + rmax.x) * 0.5 - o.x) * d.x + ((rmin.y + rmax.y) * 0.5 - o.y) * d.y
                  + ((rmin.z + rmax.z) * 0.5 - o.z) * d.z)
        left_near = dist_l <= dist_r
        far_near = ((torch.where(left_near, cr, cl), torch.where(left_near, hit_r, hit_l)),
                    (torch.where(left_near, cl, cr), torch.where(left_near, hit_l, hit_r)))
        for ref_push, mask in far_near:
            # the push saturates at STACK_DEPTH - 1 and then overwrites the top
            idx = torch.clamp(sp, max=STACK_DEPTH - 1)[:, None]
            cur = torch.gather(stack, 1, idx)[:, 0]
            stack.scatter_(1, idx, torch.where(mask, ref_push, cur)[:, None])
            sp = torch.where(mask, torch.clamp(sp + 1, max=STACK_DEPTH - 1), sp)

        # leaf: K contiguous triangles
        leaf_id = torch.clamp(-(ref + 1), 0, m).to(torch.int64)
        base = leaf_id[:, None] * k + kk[None, :]  # (R, K)
        v0 = Vec3(*(c[base] for c in scene.v0))
        v1 = Vec3(*(c[base] for c in scene.v1))
        v2 = Vec3(*(c[base] for c in scene.v2))
        h, t, u, v = ray_triangle(Vec3(o.x[:, None], o.y[:, None], o.z[:, None]),
                                  Vec3(d.x[:, None], d.y[:, None], d.z[:, None]),
                                  v0, v1, v2, t_min[:, None], best_t[:, None])
        t = torch.where(h & do_leaf[:, None], t, BIG_T)
        j = torch.argmin(t, dim=1, keepdim=True)  # the first of equal t
        tb = torch.gather(t, 1, j)[:, 0]
        better = tb < best_t  # across leaves only a strictly smaller t wins
        new = dict(
            sp=sp,
            best_t=torch.where(better, tb, best_t),
            best_tri=torch.where(better, torch.gather(base, 1, j)[:, 0].to(torch.int32),
                                 w["best_tri"]),
            best_u=torch.where(better, torch.gather(u, 1, j)[:, 0], w["best_u"]),
            best_v=torch.where(better, torch.gather(v, 1, j)[:, 0], w["best_v"]),
        )
        for key, val in new.items():  # in place: a CUDA graph replays into the same tensors
            w[key].copy_(val)

    def write_back(w):
        i = w["idx"]
        out_t[i], out_tri[i] = w["best_t"], w["best_tri"]
        out_u[i], out_v[i] = w["best_u"], w["best_v"]

    graph = None
    while True:
        live = w["sp"] > 0
        if any_hit:
            live = live & (w["best_tri"] < 0)
        n_live = int(live.sum())
        if n_live == 0:
            break
        if 2 * n_live <= live.shape[0]:
            write_back(w)
            keep = live.nonzero()[:, 0]
            w = {key: a[keep] for key, a in w.items()}
            graph = None
        if dev.type != "cuda":
            for _ in range(CHECK_EVERY):
                body(w)
        elif graph is None:
            # one iteration run eagerly (on a side stream, as capture asks),
            # then the iteration captured and replayed on this working set
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body(w)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                body(w)
            for _ in range(CHECK_EVERY - 1):
                graph.replay()
        else:
            for _ in range(CHECK_EVERY):
                graph.replay()
        walk_stats["iterations"] += CHECK_EVERY
    write_back(w)
    return HitRecord(t=out_t, tri=out_tri, u=out_u, v=out_v)


def closest_hit(bvh: BVH, scene: SceneData, o: Vec3, d: Vec3, t_min=0.001,
                t_max=1e16) -> HitRecord:
    """Closest-hit query (the radiance ray). Misses keep t = t_max, tri -1."""
    return _traverse(bvh, scene, o, d, t_min, t_max, any_hit=False)


def any_hit(bvh: BVH, scene: SceneData, o: Vec3, d: Vec3, t_min=0.01, t_max=1e16) -> Tensor:
    """Occlusion query, ending each ray at its first hit: (N,) bool."""
    return _traverse(bvh, scene, o, d, t_min, t_max, any_hit=True).hit


def brute_force_closest_hit(scene: SceneData, o: Vec3, d: Vec3, t_min=0.001, t_max=1e16,
                            num_valid: int | None = None) -> HitRecord:
    """O(N*T) oracle for tests: every ray against every triangle; misses
    get t = BIG_T."""
    nt = scene.v0.x.shape[0] if num_valid is None else num_valid
    n = o.x.shape[0]
    dev = o.x.device
    ob = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
    v0, v1, v2 = (Vec3(*(c[None, :nt] for c in v)) for v in (scene.v0, scene.v1, scene.v2))
    h, t, u, v = ray_triangle(ob, db, v0, v1, v2, _f32(t_min, n, dev)[:, None],
                              _f32(t_max, n, dev)[:, None])
    t = torch.where(h, t, BIG_T)
    j = torch.argmin(t, dim=1, keepdim=True)
    tb = torch.gather(t, 1, j)[:, 0]
    hit_any = tb < BIG_T
    return HitRecord(t=tb, tri=torch.where(hit_any, j[:, 0].to(torch.int32), -1),
                     u=torch.gather(u, 1, j)[:, 0], v=torch.gather(v, 1, j)[:, 0])
