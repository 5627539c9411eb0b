"""Swept-sphere curve-primitive intersection (port of
optixpathtracer_tpu/ops/curve_intersect.py).

The reference ships only the shading helpers of curve primitives
(cuda/curve.h:37-396); the intersector lives in OptiX hardware. Here each
segment's swept-sphere surface is bounded by a chain of SUBDIV round cones
(the capsules between consecutive flatten points, radius interpolated), and
every (ray, sub-cone) pair is one dense branchless quadratic. The winning
sub-interval is re-flattened around the hit (one refinement level), and the
surface normal is rebuilt from the exact curve polynomial with
`core.curves.surface_normal`. Like the sphere set, the test is dense (rays x
segments x SUBDIV): whitted scenes hold few primitives. Plain PyTorch: no
kernel of its own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import curves
from ..core.materials import MaterialTable, build_table
from ..core.math import Vec3

Tensor = torch.Tensor

BIG_T = 1e30
SUBDIV = 8  # sub-cones per segment per flattening level


class CurveScene(NamedTuple):
    """A batch of curve segments as pre-transformed polynomial coefficients."""

    p: Tensor  # (N, K, 4) [x y z radius] coeffs (core.curves convention)
    material_id: Tensor  # (N,) int32
    materials: MaterialTable

    @property
    def count(self) -> int:
        return self.p.shape[0]


def build_curves(control_points: list, materials: list[dict], device, material_ids=None) -> CurveScene:
    """control_points: one (K, 4) uniform b-spline control array per
    segment (K in {2, 3, 4}; column 3 is the per-point radius), the layout
    OptiX takes via optixBuildInputCurveArray."""
    q = np.asarray(control_points, np.float32)
    mid = (np.zeros(q.shape[0], np.int32) if material_ids is None
           else np.asarray(material_ids, np.int32))
    return CurveScene(p=curves.from_bspline(torch.as_tensor(q, device=device)),
                      material_id=torch.as_tensor(mid, device=device),
                      materials=build_table(materials, device))


class CurveHitRecord(NamedTuple):
    t: Tensor  # (R,) BIG_T on miss
    seg: Tensor  # (R,) winning segment id, -1 on miss
    u: Tensor  # (R,) curve parameter at the hit
    hit: Tensor  # (R,) bool
    normal: Vec3  # (R,) exact offset-surface normal (zero on miss)
    point: Vec3  # (R,) hit point projected onto the exact surface


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _round_cone_entry(ox, oy, oz, dx, dy, dz, ax, ay, az, bx, by, bz, ra, rb):
    """Entry t of rays into round cones, broadcast over (R, M): rays are
    (R, 1) components, cone endpoints and radii (1, M) or (R, M). Returns
    (t, s_axial): t = BIG_T on a miss, s_axial in [0, 1] the hit's clamped
    axial coordinate."""
    bax, bay, baz = bx - ax, by - ay, bz - az
    oax, oay, oaz = ox - ax, oy - ay, oz - az
    obx, oby, obz = ox - bx, oy - by, oz - bz
    rr = ra - rb
    m0 = _dot(bax, bay, baz, bax, bay, baz)
    m1 = _dot(oax, oay, oaz, bax, bay, baz)
    m2 = _dot(dx, dy, dz, bax, bay, baz)
    m3 = _dot(dx, dy, dz, oax, oay, oaz)
    m5 = _dot(oax, oay, oaz, oax, oay, oaz)
    m6 = _dot(dx, dy, dz, obx, oby, obz)
    m7 = _dot(obx, oby, obz, obx, oby, obz)

    # lateral (cone) surface
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    ok_h = (h >= 0.0) & (k2.abs() > 1e-20) & (d2 > 0.0)
    safe_k2 = torch.where(ok_h, k2, 1.0)
    t_lat = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / safe_k2
    y = m1 - ra * rr + t_lat * m2
    lat = ok_h & (y > 0.0) & (y < d2) & (t_lat > 0.0)
    t_lat = torch.where(lat, t_lat, BIG_T)

    # endpoint spheres (near roots only: entry from outside)
    ha = m3 * m3 - m5 + ra * ra
    t_a = -m3 - torch.sqrt(torch.clamp(ha, min=0.0))
    t_a = torch.where((ha >= 0.0) & (t_a > 0.0), t_a, BIG_T)
    hb = m6 * m6 - m7 + rb * rb
    t_b = -m6 - torch.sqrt(torch.clamp(hb, min=0.0))
    t_b = torch.where((hb >= 0.0) & (t_b > 0.0), t_b, BIG_T)

    t = torch.minimum(t_lat, torch.minimum(t_a, t_b))
    # axial coordinate of the winning hit point, clamped to the sub-cone
    safe_m0 = torch.clamp(m0, min=1e-30)
    s = torch.clamp((m1 + t * m2) / safe_m0, 0.0, 1.0)
    s = torch.where(t >= BIG_T, 0.0, s)
    return t, s


def _flatten_points(p: Tensor, u_grid: np.ndarray) -> list[Tensor]:
    """Every segment at each parameter of a host grid: a list of (N, 4)."""
    return [curves.position4(p, torch.full((p.shape[0],), float(uv), dtype=torch.float32,
                                           device=p.device)) for uv in u_grid]


def _eval_poly4(pr: Tensor, u: Tensor) -> Tensor:
    """position4 on gathered per-ray coefficients pr (R, K, 4) at u (R,)."""
    k = pr.shape[1] - 1
    uu = u[:, None]
    if k == 1:
        return pr[:, 0] + uu * pr[:, 1]
    if k == 2:
        return pr[:, 0] + uu * (pr[:, 1] + uu * pr[:, 2])
    u2 = uu * uu
    u3 = (1.0 / 6.0) * u2 * uu
    return pr[:, 0] + (u3 + 0.5 * (uu - u2)) * pr[:, 1] + (u2 - 4.0 * u3) * pr[:, 2] + u3 * pr[:, 3]


def _coarse_chain(p: Tensor):
    """Level 0: every segment flattened into SUBDIV cones, (N*SUBDIV, 4) start
    and end points."""
    n = p.shape[0]
    pts0 = _flatten_points(p, np.linspace(0.0, 1.0, SUBDIV + 1, dtype=np.float32))
    a4 = torch.stack(pts0[:-1], 1).reshape(n * SUBDIV, 4)
    b4 = torch.stack(pts0[1:], 1).reshape(n * SUBDIV, 4)
    return a4, b4


def _cone_args(a, b):
    """The twelve cone arguments of `_round_cone_entry` from (..., 4) ends."""
    return (a[..., 0], a[..., 1], a[..., 2], b[..., 0], b[..., 1], b[..., 2],
            torch.clamp(a[..., 3], min=0.0), torch.clamp(b[..., 3], min=0.0))


def closest_hit_curves(scene: CurveScene, o: Vec3, d: Vec3, t_min: float = 1e-3,
                       t_max: float = 1e16) -> CurveHitRecord:
    """Closest hit of (R,) rays against every curve segment (dense)."""
    p = scene.p
    a4, b4 = _coarse_chain(p)
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    t0, _ = _round_cone_entry(ox, oy, oz, dx, dy, dz, *_cone_args(a4[None], b4[None]))  # (R, N*S)
    t0 = torch.where((t0 > t_min) & (t0 < t_max), t0, BIG_T)
    j0 = torch.argmin(t0, dim=1)
    t_coarse = torch.gather(t0, 1, j0[:, None])[:, 0]
    seg = (j0 // SUBDIV).to(torch.int32)
    sub = (j0 % SUBDIV).to(torch.int32)
    miss = t_coarse >= BIG_T

    # level 1: re-flatten around the winning sub-interval, a window of two
    # coarse sub-intervals centred on it, clamped to [0, 1]
    pr = p[torch.clamp(seg, min=0).to(torch.int64)]  # (R, K, 4)
    du = np.float32(2.0 / SUBDIV)
    u_lo = torch.clamp((sub.to(torch.float32) - 0.5) * float(np.float32(1.0 / SUBDIV)),
                       0.0, float(np.float32(1.0) - du))
    frac = np.linspace(0.0, 1.0, SUBDIV + 1, dtype=np.float32)
    pts1 = [_eval_poly4(pr, u_lo + float(np.float32(f) * du)) for f in frac]  # SUBDIV+1 x (R, 4)
    a1 = torch.stack(pts1[:-1], 1)  # (R, S, 4)
    b1 = torch.stack(pts1[1:], 1)
    t1, s1 = _round_cone_entry(ox, oy, oz, dx, dy, dz, *_cone_args(a1, b1))  # (R, S)
    t1 = torch.where((t1 > t_min) & (t1 < t_max), t1, BIG_T)
    j1 = torch.argmin(t1, dim=1)
    t_fine = torch.gather(t1, 1, j1[:, None])[:, 0]
    s_fine = torch.gather(s1, 1, j1[:, None])[:, 0]
    # the fine chain is authoritative: a grazing ray that clipped the coarse
    # bulge but misses the fine chain is a miss
    miss = miss | (t_fine >= BIG_T)
    u = u_lo + (j1.to(torch.float32) + s_fine) * float(np.float32(du / SUBDIV))
    u = torch.clamp(u, 0.0, 1.0)

    t = torch.where(miss, BIG_T, t_fine)
    ps = Vec3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    nrm, ps_fixed = curves.surface_normal(pr, u, ps)
    zero = torch.zeros_like(t)
    nrm = Vec3(*(torch.where(miss, zero, c) for c in nrm))
    # faceforward: curve tubes are two-sided
    back = nrm.x * d.x + nrm.y * d.y + nrm.z * d.z > 0.0
    sgn = torch.where(back, -1.0, 1.0)
    return CurveHitRecord(
        t=t, seg=torch.where(miss, -1, seg), u=torch.where(miss, 0.0, u), hit=~miss,
        normal=Vec3(nrm.x * sgn, nrm.y * sgn, nrm.z * sgn),
        point=Vec3(*(torch.where(miss, zero, c) for c in ps_fixed)))


def any_hit_curves(scene: CurveScene, o: Vec3, d: Vec3, t_min=1e-3, t_max=1e16) -> Tensor:
    """Occlusion: True where any segment blocks (t_min, t_max); the coarse
    chain only, at the resolution primary hits use. t_min / t_max are
    scalars or per-ray (R,) tensors."""
    a4, b4 = _coarse_chain(scene.p)
    t0, _ = _round_cone_entry(o.x[:, None], o.y[:, None], o.z[:, None],
                              d.x[:, None], d.y[:, None], d.z[:, None], *_cone_args(a4[None], b4[None]))
    dev = o.x.device
    tmin = torch.as_tensor(t_min, dtype=torch.float32, device=dev)
    tmax = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    tmin = tmin[:, None] if tmin.ndim == 1 else tmin
    tmax = tmax[:, None] if tmax.ndim == 1 else tmax
    return ((t0 > tmin) & (t0 < tmax)).any(dim=1)
