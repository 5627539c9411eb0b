"""Sphere primitive set with dense (all-rays x all-spheres) intersection
(port of optixpathtracer_tpu/ops/spheres.py).

Reference: cuda/sphere.cu __intersection__sphere (:37-96) — the custom
primitive the Whitted config traces. A whitted scene holds a handful of
analytic spheres, so every ray is tested against every sphere: one (N, S)
broadcast quadratic solve and an argmin, no acceleration structure.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.materials import MaterialTable, build_table
from ..core.math import Vec3

Tensor = torch.Tensor

BIG_T = 1e30


class SphereScene(NamedTuple):
    center: Vec3  # (S,)
    radius: Tensor  # (S,)
    material_id: Tensor  # (S,) int32
    materials: MaterialTable

    @property
    def count(self) -> int:
        return self.radius.shape[0]


def build_spheres(spheres: list[tuple], materials: list[dict], device) -> SphereScene:
    """spheres: list of (center(3,), radius, material_index)."""
    c = np.array([s[0] for s in spheres], np.float32)
    r = np.array([s[1] for s in spheres], np.float32)
    m = np.array([s[2] for s in spheres], np.int32)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return SphereScene(center=Vec3(up(c[:, 0]), up(c[:, 1]), up(c[:, 2])), radius=up(r),
                       material_id=up(m), materials=build_table(materials, device))


class SphereHitRecord(NamedTuple):
    t: Tensor  # (N,), BIG_T on miss
    sphere: Tensor  # (N,) int32, -1 on miss
    nx: Tensor  # outward geometric normal at hit
    ny: Tensor
    nz: Tensor

    @property
    def hit(self) -> Tensor:
        return self.sphere >= 0


def closest_hit_spheres(ss: SphereScene, o: Vec3, d: Vec3, t_min, t_max) -> SphereHitRecord:
    """Dense closest hit: (N, S) quadratic solve, argmin over spheres (the
    lowest sphere index wins a tie)."""
    n = o.x.shape[0]
    dev = o.x.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)

    ocx = o.x[:, None] - ss.center.x[None, :]
    ocy = o.y[:, None] - ss.center.y[None, :]
    ocz = o.z[:, None] - ss.center.z[None, :]
    dd = d.x * d.x + d.y * d.y + d.z * d.z  # (N,)
    inv_len = torch.rsqrt(torch.clamp(dd, min=1e-30))[:, None]
    dxn = d.x[:, None] * inv_len
    dyn = d.y[:, None] * inv_len
    dzn = d.z[:, None] * inv_len
    b = ocx * dxn + ocy * dyn + ocz * dzn
    c = ocx * ocx + ocy * ocy + ocz * ocz - ss.radius[None, :] ** 2
    disc = b * b - c
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - s) * inv_len
    t2 = (-b + s) * inv_len
    ok1 = (disc > 0) & (t1 > t_min[:, None]) & (t1 < t_max[:, None])
    ok2 = (disc > 0) & (t2 > t_min[:, None]) & (t2 < t_max[:, None])
    t = torch.where(ok1, t1, torch.where(ok2, t2, BIG_T))

    j = torch.argmin(t, dim=1)
    tb = torch.gather(t, 1, j[:, None])[:, 0]
    hit = tb < BIG_T
    cx = ss.center.x[j]
    cy = ss.center.y[j]
    cz = ss.center.z[j]
    rad = torch.clamp(ss.radius[j], min=1e-20)
    px = o.x + d.x * tb
    py = o.y + d.y * tb
    pz = o.z + d.z * tb
    return SphereHitRecord(t=tb, sphere=torch.where(hit, j.to(torch.int32), -1),
                           nx=(px - cx) / rad, ny=(py - cy) / rad, nz=(pz - cz) / rad)


def any_hit_spheres(ss: SphereScene, o: Vec3, d: Vec3, t_min, t_max) -> Tensor:
    return closest_hit_spheres(ss, o, d, t_min, t_max).hit
