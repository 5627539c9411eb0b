"""Port parity, core/curves: every helper against the JAX package on the
same seeded b-spline segments (degrees 1-3), and tests/test_curves.py's
identities held by the port (the textbook b-spline basis, the round trip,
derivatives by finite differences, radius extrema against dense sampling,
unit tangents, radial and end-cap normals).

Tolerances: rtol 1e-5 / atol 1e-6 against JAX (the same f32 expressions;
a normalisation's rsqrt may round a ulp apart); the identities at
tests/test_curves.py's own tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core import curves as J
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu_torch.core import curves as C
from optixpathtracer_tpu_torch.core.math import Vec3, dot, length

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _q(k, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, k + 1, 4)).astype(np.float32)
    q[:, :, 3] = 0.05 + np.abs(q[:, :, 3]) * 0.3
    return q


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


def _vclose(got, want):
    for a, b in zip(got, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_polynomials_equal_to_jax(k):
    q = _q(k, 64, k)
    tp, jp = C.from_bspline(torch.as_tensor(q)), J.from_bspline(jnp.asarray(q))
    _close(tp.numpy(), jp)
    _close(C.export_bspline(tp).numpy(), J.export_bspline(jp))
    u = np.random.default_rng(10 + k).random(64, dtype=np.float32)
    u[:3] = (0.0, 1.0, 0.5)
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    for fn in ("position4", "velocity4", "acceleration4", "radius", "derivative_of_radius"):
        _close(getattr(C, fn)(tp, tu).numpy(), getattr(J, fn)(jp, ju))
    for fn in ("position3", "velocity3", "acceleration3", "curve_tangent"):
        _vclose(getattr(C, fn)(tp, tu), getattr(J, fn)(jp, ju))
    for fn in ("min_radius", "max_radius"):
        _close(getattr(C, fn)(tp, 0.1, 0.9).numpy(), getattr(J, fn)(jp, 0.1, 0.9))
        _close(getattr(C, fn)(tp, tu * 0.5, tu * 0.5 + 0.5).numpy(), getattr(J, fn)(jp, ju * 0.5, ju * 0.5 + 0.5))


@pytest.mark.parametrize("kind", [C.NORMAL_CYLINDRICAL, C.NORMAL_CONIC, C.NORMAL_EXACT])
@pytest.mark.parametrize("k", [1, 3])
def test_surface_normal_equal_to_jax(k, kind):
    q = _q(k, 64, 20 + k)
    tp, jp = C.from_bspline(torch.as_tensor(q)), J.from_bspline(jnp.asarray(q))
    rng = np.random.default_rng(30 + k)
    u = rng.random(64, dtype=np.float32)
    u[:4] = (0.0, 1.0, 0.0, 1.0)  # the end caps
    c = np.asarray(J.position4(jp, jnp.asarray(u)))
    ps = (c[:, :3] + rng.normal(0, 0.3, (64, 3))).astype(np.float32)
    tn, tps = C.surface_normal(tp, torch.as_tensor(u), Vec3(*(torch.as_tensor(ps[:, i].copy()) for i in range(3))),
                               kind)
    jn, jps = J.surface_normal(jp, jnp.asarray(u), JVec3(*(jnp.asarray(ps[:, i]) for i in range(3))), kind)
    for a, b in zip((*tn, *tps), (*jn, *jps)):
        _close(a.numpy(), b, rtol=1e-4, atol=1e-5)  # a projection and two normalisations


def _basis(k, u):
    if k == 1:
        return np.stack([1 - u, u], axis=1)
    if k == 2:
        return np.stack([0.5 * (1 - u) ** 2, 0.5 * (-2 * u * u + 2 * u + 1), 0.5 * u * u], axis=1)
    return np.stack([(1 - u) ** 3 / 6, (3 * u**3 - 6 * u * u + 4) / 6,
                     (-3 * u**3 + 3 * u * u + 3 * u + 1) / 6, u**3 / 6], axis=1)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_position_matches_bspline_basis_and_roundtrips(k):
    q = _q(k, 16, k)
    p = C.from_bspline(torch.as_tensor(q))
    for ui in np.linspace(0.0, 1.0, 9).astype(np.float32):
        want = np.einsum("j,njc->nc", _basis(k, np.array([ui]))[0], q)
        np.testing.assert_allclose(C.position4(p, float(ui)).numpy(), want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(C.export_bspline(p).numpy(), q, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_derivatives_and_radius_extrema(k):
    p = C.from_bspline(torch.as_tensor(_q(k, 8, 20 + k)))
    eps = 1e-3
    for u0 in (0.2, 0.5, 0.8):
        fd = (C.position4(p, u0 + eps) - C.position4(p, u0 - eps)) / (2 * eps)
        np.testing.assert_allclose(C.velocity4(p, u0).numpy(), fd.numpy(), rtol=5e-3, atol=5e-3)
        fd2 = (C.velocity4(p, u0 + eps) - C.velocity4(p, u0 - eps)) / (2 * eps)
        np.testing.assert_allclose(C.acceleration4(p, u0).numpy(), fd2.numpy(), rtol=5e-3, atol=5e-3)
    p = C.from_bspline(torch.as_tensor(_q(k, 32, 30 + k)))
    dense = torch.stack([C.radius(p, float(u)) for u in np.linspace(0.0, 1.0, 257, dtype=np.float32)], 1)
    rmin, rmax = C.min_radius(p, 0.0, 1.0), C.max_radius(p, 0.0, 1.0)
    assert (rmin <= dense.amin(1) + 1e-5).all() and (rmax >= dense.amax(1) - 1e-5).all()
    np.testing.assert_allclose(rmin.numpy(), dense.amin(1).numpy(), atol=1e-3)
    np.testing.assert_allclose(rmax.numpy(), dense.amax(1).numpy(), atol=1e-3)


def test_tangent_and_cylinder_normal():
    q = np.array([[[0, 0, 0, 0.5], [2, 0, 0, 0.5]]], np.float32)
    p = C.from_bspline(torch.as_tensor(q))
    t = C.curve_tangent(p, 0.5)
    np.testing.assert_allclose([float(c[0]) for c in t], [1, 0, 0], atol=1e-6)
    ps = Vec3(torch.tensor([1.0]), torch.tensor([0.6]), torch.tensor([0.0]))
    n, fixed = C.surface_normal(p, 0.5, ps)
    np.testing.assert_allclose([float(c[0]) for c in n], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(float(length(fixed - Vec3(torch.tensor([1.0]), torch.zeros(1), torch.zeros(1)))[0]),
                               0.5, atol=1e-6)
    assert abs(float(dot(n, t)[0])) < 1e-6


def test_end_cap_normals():
    lin = C.from_bspline(torch.as_tensor(np.array([[[0, 0, 0, 0.5], [2, 0, 0, 0.5]]], np.float32)))
    n0, _ = C.surface_normal(lin, 0.0, Vec3(torch.tensor([-0.5]), torch.zeros(1), torch.zeros(1)))
    np.testing.assert_allclose([float(c[0]) for c in n0], [-1, 0, 0], atol=1e-6)  # round cap
    cub = C.from_bspline(torch.as_tensor(_q(3, 1, 50)))
    n1, _ = C.surface_normal(cub, 1.0, Vec3(torch.zeros(1), torch.zeros(1), torch.zeros(1)))
    v1 = C.curve_tangent(cub, 1.0)
    np.testing.assert_allclose([float(c[0]) for c in n1], [float(c[0]) for c in v1], atol=1e-5)  # flat cap
