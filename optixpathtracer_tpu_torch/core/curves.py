"""B-spline curve-primitive helpers (port of optixpathtracer_tpu/core/curves.py,
the equivalent of cuda/curve.h).

Per-segment polynomial interpolators (linear/quadratic/cubic uniform
b-splines with a per-control-point radius in the w channel), radius extrema
over a parameter interval, and the curve-surface normal / tangent
reconstruction of OptiX curve primitives, batched over N segments.

Data model: a segment batch is one (N, K, 4) float32 tensor `p` of
PRE-TRANSFORMED polynomial coefficients (the reference's `p[]` member), K-1
the degree, columns [x, y, z, radius]. `from_bspline` builds it from uniform
b-spline control points (initializeFromBSpline), `export_bspline` inverts it.
"""
from __future__ import annotations

import torch

from .math import Vec3, dot, length, normalize

Tensor = torch.Tensor

# normal-reconstruction variants (reference curve.h:269-271)
NORMAL_CYLINDRICAL = 0  # correct if radius' == 0
NORMAL_CONIC = 1  # correct if curve'' == 0
NORMAL_EXACT = 2  # bona fide offset-surface normal


def _degree(p: Tensor) -> int:
    k = p.shape[-2] - 1
    if k not in (1, 2, 3):
        raise ValueError(f"curve batch must have 2..4 control rows, got {k + 1}")
    return k


def from_bspline(q: Tensor) -> Tensor:
    """Pre-transform uniform b-spline control points (N, K, 4), K in
    {2, 3, 4} (curve.h:42-46, 85-91, 141-148)."""
    q = torch.as_tensor(q, dtype=torch.float32)
    k = _degree(q)
    if k == 1:
        return torch.stack([q[:, 0], q[:, 1] - q[:, 0]], dim=1)
    if k == 2:
        return torch.stack([0.5 * (q[:, 1] + q[:, 0]), q[:, 1] - q[:, 0],
                            0.5 * q[:, 0] - q[:, 1] + 0.5 * q[:, 2]], dim=1)
    return torch.stack([(q[:, 2] + q[:, 0]) / 6.0 + (4.0 / 6.0) * q[:, 1], q[:, 2] - q[:, 0],
                        q[:, 2] - q[:, 1], q[:, 3] - q[:, 1]], dim=1)


def export_bspline(p: Tensor) -> Tensor:
    """Inverse of `from_bspline` (curve.h:93-98, 150-157)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    k = _degree(p)
    if k == 1:
        return torch.stack([p[:, 0], p[:, 0] + p[:, 1]], dim=1)
    if k == 2:
        return torch.stack([p[:, 0] - 0.5 * p[:, 1], p[:, 0] + 0.5 * p[:, 1],
                            p[:, 0] + 1.5 * p[:, 1] + 2.0 * p[:, 2]], dim=1)
    return torch.stack([
        p[:, 0] + (4.0 * p[:, 2] - 5.0 * p[:, 1]) / 6.0,
        p[:, 0] + (p[:, 1] - 2.0 * p[:, 2]) / 6.0,
        p[:, 0] + (p[:, 1] + 4.0 * p[:, 2]) / 6.0,
        p[:, 0] + p[:, 3] + (p[:, 1] - 2.0 * p[:, 2]) / 6.0,
    ], dim=1)


def _u(u, p: Tensor) -> Tensor:
    return torch.as_tensor(u, dtype=torch.float32, device=p.device).expand(p.shape[0])


def position4(p: Tensor, u) -> Tensor:
    """(N, 4) curve point [x, y, z, radius] at parameter u (curve.h position4)."""
    k = _degree(p)
    uu = _u(u, p)[:, None]
    if k == 1:
        return p[:, 0] + uu * p[:, 1]
    if k == 2:
        return p[:, 0] + uu * (p[:, 1] + uu * p[:, 2])
    # cubic basis in the pre-transformed coordinates (curve.h:159-175)
    u2 = uu * uu
    u3 = (1.0 / 6.0) * u2 * uu
    return p[:, 0] + (u3 + 0.5 * (uu - u2)) * p[:, 1] + (u2 - 4.0 * u3) * p[:, 2] + u3 * p[:, 3]


def velocity4(p: Tensor, u) -> Tensor:
    """(N, 4) first derivative of position4; cubic parameters are nudged off
    the exact 0/1 endpoints (curve.h:239-248)."""
    k = _degree(p)
    uu = _u(u, p)[:, None]
    if k == 1:
        return p[:, 1].expand(p.shape[0], 4)
    if k == 2:
        return p[:, 1] + 2.0 * uu * p[:, 2]
    uu = torch.clamp(uu, 1e-6, 1.0 - 1e-6)
    v = 1.0 - uu
    return 0.5 * v * v * p[:, 1] + 2.0 * v * uu * p[:, 2] + 0.5 * uu * uu * p[:, 3]


def acceleration4(p: Tensor, u) -> Tensor:
    """(N, 4) second derivative (curve.h acceleration4)."""
    k = _degree(p)
    uu = _u(u, p)[:, None]
    if k == 1:
        return torch.zeros((p.shape[0], 4), dtype=torch.float32, device=p.device)
    if k == 2:
        return (2.0 * p[:, 2]).expand(p.shape[0], 4)
    return 2.0 * p[:, 2] - p[:, 1] + (p[:, 1] - 4.0 * p[:, 2] + p[:, 3]) * uu


def _xyz(q: Tensor) -> Vec3:
    return Vec3(q[:, 0], q[:, 1], q[:, 2])


def position3(p: Tensor, u) -> Vec3:
    return _xyz(position4(p, u))


def velocity3(p: Tensor, u) -> Vec3:
    return _xyz(velocity4(p, u))


def acceleration3(p: Tensor, u) -> Vec3:
    return _xyz(acceleration4(p, u))


def radius(p: Tensor, u) -> Tensor:
    """(N,) interpolated curve radius (curve.h radius)."""
    return position4(p, u)[:, 3]


def derivative_of_radius(p: Tensor, u) -> Tensor:
    return velocity4(p, u)[:, 3]


def _radius_extremum_candidates(p: Tensor, u1, u2) -> Tensor:
    """(N, R) parameters to probe for radius extrema over [u1, u2]: the
    endpoints plus the clamped interior critical points of the radius
    polynomial (curve.h :53-63, 108-120, 182-226)."""
    k = _degree(p)
    u1 = _u(u1, p)
    u2 = _u(u2, p)
    if k == 1:
        return torch.stack([u1, u2], dim=1)
    if k == 2:
        den = 2.0 * p[:, 2, 3]
        nz = den.abs() > 1e-30
        safe = torch.where(nz, den, 1.0)
        root = torch.where(nz, torch.clamp(-p[:, 1, 3] / safe, u1, u2), u1)
        return torch.stack([u1, u2, root], dim=1)
    # cubic: radius' proportional to a + 2 b u - c u^2 (the reference's naming)
    a = p[:, 1, 3]
    b = 2.0 * p[:, 2, 3] - p[:, 1, 3]
    c = 4.0 * p[:, 2, 3] - p[:, 1, 3] - p[:, 3, 3]
    lin = c.abs() < 1e-5
    safe_b = torch.where(b.abs() > 1e-30, b, 1.0)
    root_lin = torch.where(b.abs() > 1e-30, -0.5 * a / safe_b, u1)
    det = torch.sqrt(torch.clamp(b * b + a * c, min=0.0))
    safe_c = torch.where(lin, 1.0, c)
    r1 = torch.where(lin, root_lin, (b + det) / safe_c)
    r2 = torch.where(lin, root_lin, (b - det) / safe_c)
    return torch.stack([u1, u2, torch.clamp(r1, u1, u2), torch.clamp(r2, u1, u2)], dim=1)


def min_radius(p: Tensor, u1, u2) -> Tensor:
    """(N,) exact minimum of the radius over [u1, u2]."""
    cand = _radius_extremum_candidates(p, u1, u2)
    return torch.stack([radius(p, cand[:, j]) for j in range(cand.shape[1])], dim=1).amin(dim=1)


def max_radius(p: Tensor, u1, u2) -> Tensor:
    """(N,) exact maximum of the radius over [u1, u2]."""
    cand = _radius_extremum_candidates(p, u1, u2)
    return torch.stack([radius(p, cand[:, j]) for j in range(cand.shape[1])], dim=1).amax(dim=1)


def curve_tangent(p: Tensor, u) -> Vec3:
    """Unit tangent along the curve axis (curve.h curveTangent, :391-396)."""
    return normalize(velocity3(p, u))


def surface_normal(p: Tensor, u, ps: Vec3, kind: int = NORMAL_EXACT) -> tuple[Vec3, Vec3]:
    """Object-space surface normal of the swept-sphere curve primitive
    (curve.h surfaceNormal, :285-380). `ps` is the near-surface hit point;
    it is projected onto the offset surface and returned beside the normal.
    Parameters at u == 0 / u >= 1 take flat endcap normals (-/+ velocity)
    for degree >= 2 and round ones (ps - endpoint) for linear segments."""
    k = _degree(p)
    uu = _u(u, p)

    p4 = position4(p, uu)
    c = _xyz(p4)
    r = p4[:, 3]
    d4 = velocity4(p, uu)
    d = _xyz(d4)
    dr = d4[:, 3]
    dd = dot(d, d)

    # project ps to the plane(c, d), then drop it radially to the surface
    o1 = ps - c
    o1 = o1 - d * (dot(o1, d) / dd)
    o1_len = torch.clamp(length(o1), min=1e-30)
    o1 = o1 * (r / o1_len)
    ps_fixed = c + o1

    if kind == NORMAL_CYLINDRICAL:
        body = o1
    elif kind == NORMAL_CONIC or k == 1:
        body = o1 * dd - d * (dr * r)
    else:
        dd_adj = dd - dot(acceleration3(p, uu), o1)
        body = o1 * dd_adj - d * (dr * r)

    at0 = uu == 0.0
    at1 = uu >= 1.0
    if k == 1:
        p0 = Vec3(p[:, 0, 0], p[:, 0, 1], p[:, 0, 2])
        p1 = p0 + Vec3(p[:, 1, 0], p[:, 1, 1], p[:, 1, 2])
        cap0 = ps - p0
        cap1 = ps - p1
    else:
        cap0 = -velocity3(p, torch.zeros_like(uu))
        cap1 = velocity3(p, torch.ones_like(uu))

    def sel(a: Vec3, b: Vec3, m) -> Vec3:
        return Vec3(*(torch.where(m, x, y) for x, y in zip(a, b)))

    normal = sel(cap0, sel(cap1, body, at1), at0)
    ps_out = sel(ps, sel(ps, ps_fixed, at1), at0)
    return normalize(normal), ps_out
