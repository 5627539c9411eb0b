"""Primitive intersection routines, batched SoA (port of
optixpathtracer_tpu/ops/intersect.py): the triangle, slab and sphere tests
of the lockstep walk (ops/traverse.py), in the reference's expression
order. All functions broadcast over leading shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import Vec3, cross, dot

Tensor = torch.Tensor

BIG_T = 1e30


def ray_triangle(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3, t_min, t_max):
    """Möller–Trumbore, two-sided. Returns (hit, t, u, v); misses get
    t = BIG_T."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tv = o - v0
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    v = dot(d, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return hit, torch.where(hit, t, BIG_T), u, v


def ray_aabb(o: Vec3, inv_d: Vec3, bmin: Vec3, bmax: Vec3, t_min, t_max) -> Tensor:
    """Slab test; robust to inf from axis-parallel rays."""
    t0x = (bmin.x - o.x) * inv_d.x
    t1x = (bmax.x - o.x) * inv_d.x
    t0y = (bmin.y - o.y) * inv_d.y
    t1y = (bmax.y - o.y) * inv_d.y
    t0z = (bmin.z - o.z) * inv_d.z
    t1z = (bmax.z - o.z) * inv_d.z
    near = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.maximum(torch.minimum(t0z, t1z), t_min),
    )
    far = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), t_max),
    )
    return near <= far


class SphereHit(NamedTuple):
    hit: Tensor
    t: Tensor
    nx: Tensor
    ny: Tensor
    nz: Tensor


def ray_sphere(o: Vec3, d: Vec3, center: Vec3, radius: Tensor, t_min, t_max) -> SphereHit:
    """Analytic sphere (cuda/sphere.cu:37-96 semantics): the nearest root in
    (t_min, t_max) and the outward unit normal. The whitted engine's dense
    sphere set (ops/spheres.py) solves the same quadratic over all spheres
    at once; this is the single-primitive form."""
    oc = o - center
    inv_len = torch.rsqrt(torch.clamp(dot(d, d), min=1e-30))
    dn = d * inv_len
    b = dot(oc, dn)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    has = disc > 0.0
    sdisc = torch.sqrt(torch.clamp(disc, min=0.0))
    root1 = -b - sdisc
    root2 = -b + sdisc
    t1 = root1 * inv_len
    t2 = root2 * inv_len
    ok1 = has & (t1 > t_min) & (t1 < t_max)
    ok2 = has & (t2 > t_min) & (t2 < t_max)
    t = torch.where(ok1, t1, torch.where(ok2, t2, BIG_T))
    root = torch.where(ok1, root1, root2)
    n = (oc + dn * root) / torch.clamp(radius, min=1e-20)
    return SphereHit(ok1 | ok2, t, n.x, n.y, n.z)
