"""Port parity, ops/spheres (the dense all-rays x all-spheres closest hit)
and shade/pbr (whitted.cu's GGX metallic-roughness direct light), against
the JAX package on the same seeded numpy inputs.

XLA's rsqrt and PyTorch's round apart on about a third of inputs (neither
is correctly rounded), so every normalisation may differ by a ulp.
Tolerances: sphere ids and hit flags bit-exact; t rtol 1e-5 / atol 1e-6 and
the normals ((p - c) / r, |p| up to ~10, r down to 0.6) atol 1e-5, each on
99 % of lanes and on every lane within 4x the reference's own one-ulp input
spread (near-grazing rays cancel in b*b - c), as
tests/test_torch_probe_disney.py holds the Disney BSDF; the pbr terms rtol
1e-5 / atol 1e-6, `direct_light` conditioned the same way over the
preset's roughness range (0.05 to 1: below it the GGX peak of a
glancing half vector turns a ulp into 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.ops import spheres as jsph
from optixpathtracer_tpu.shade import pbr as jpbr
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import spheres as tsph
from optixpathtracer_tpu_torch.shade import pbr as tpbr
from tests.test_torch_probe_disney import _close_conditioned, _ulp_spread


def _close_cond(got, want, spread, rtol, atol):
    """`_close_conditioned` at the given tolerances."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    plain = err <= atol + rtol * np.abs(want)
    assert plain.mean() >= 0.99, f"only {plain.mean():.4f} of lanes within tolerance"
    bad = err > atol + rtol * np.abs(want) + 4.0 * spread
    assert not bad.any(), f"{int(bad.sum())} lanes beyond the one-ulp spread"

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
SPHERES = [((0.0, 1.2, 0.0), 1.2, 0), ((-2.4, 0.9, -1.0), 0.9, 1), ((2.2, 0.7, -0.5), 0.7, 2),
           ((0.0, 1.2, 0.0), 0.6, 1)]  # the last inside the first: nested shells
MATS = [dict(color=(0.95, 0.95, 0.95), transmission=1.0, eta=1.5), dict(metallic=1.0),
        dict(roughness=0.4)]


def _pair(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3))), Vec3(*(torch.as_tensor(a[:, i].copy()) for i in range(3)))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


@pytest.fixture(scope="module")
def spheres():
    return (jsph.build_spheres(SPHERES, [jmake(**m) for m in MATS]),
            tsph.build_spheres(SPHERES, [make_material(**m) for m in MATS], CPU))


@pytest.mark.parametrize("normalized", [True, False])
def test_closest_hit_spheres(spheres, normalized):
    jss, tss = spheres
    rng = np.random.default_rng(1)
    n = 4096
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    centers = np.array([s[0] for s in SPHERES], np.float32)
    aim = centers[rng.integers(0, len(SPHERES), n)] + rng.uniform(-1.5, 1.5, (n, 3))
    d = (aim - o).astype(np.float32)
    if normalized:
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.2, 2.0, 1e30).astype(np.float32)
    (jo, to), (jd, td) = _pair(o), _pair(d)
    want = jsph.closest_hit_spheres(jss, jo, jd, 1e-3, jnp.asarray(t_max))
    got = tsph.closest_hit_spheres(tss, to, td, 1e-3, torch.as_tensor(t_max))
    np.testing.assert_array_equal(got.sphere.numpy(), np.asarray(want.sphere))
    hit = got.hit.numpy()
    assert 0.1 < hit.mean() < 0.9
    # near-grazing rays are ill-conditioned (b*b - c cancels), so t and the
    # normals are held as the Disney BSDF is: plain tolerance on 99 % of
    # lanes, every lane within 4x the reference's one-ulp spread
    jt = jnp.asarray(t_max)
    spreads = _ulp_spread(lambda o_, d_: tuple(
        jnp.where(jsph.closest_hit_spheres(jss, o_, d_, 1e-3, jt).hit, c, 0.0)
        for c in jsph.closest_hit_spheres(jss, o_, d_, 1e-3, jt)[::1] if c.dtype == jnp.float32), (jo, jd),
        trials=8)
    for k, (a, b, sp) in enumerate(zip((got.t, got.nx, got.ny, got.nz), (want.t, want.nx, want.ny, want.nz),
                                       spreads)):
        _close_cond(np.where(hit, a.numpy(), 0.0), np.where(hit, np.asarray(b), 0.0), sp,
                    rtol=1e-5, atol=1e-6 if k == 0 else 1e-5)
    np.testing.assert_array_equal(tsph.any_hit_spheres(tss, to, td, 1e-3, 1e30).numpy(),
                                  np.asarray(jsph.any_hit_spheres(jss, jo, jd, 1e-3, 1e30)))


def test_material_table(spheres):
    jss, tss = spheres
    np.testing.assert_array_equal(tss.materials.rows.numpy(), np.asarray(jss.materials.rows))
    np.testing.assert_array_equal(tss.material_id.numpy(), np.asarray(jss.material_id))
    assert tss.count == jss.count == len(SPHERES)


def _unit(rng, n):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def test_pbr_terms_and_direct_light():
    rng = np.random.default_rng(2)
    n = 4096
    base = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    metallic = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), n)
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    nrm, v, l = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    v = np.where(np.sum(v * nrm, 1, keepdims=True) < 0, -v, v)  # mostly lit and visible
    col = rng.uniform(0, 50, (n, 3)).astype(np.float32)
    visible = rng.random(n) < 0.8
    J = [_pair(a) for a in (base, nrm, v, l, col)]
    jm, tm = jnp.asarray(metallic), torch.as_tensor(metallic)
    jr, tr = jnp.asarray(rough), torch.as_tensor(rough)
    want = jpbr.direct_light(J[0][0], jm, jr, J[1][0], J[2][0], J[3][0], J[4][0], jnp.asarray(visible))
    got = tpbr.direct_light(J[0][1], tm, tr, J[1][1], J[2][1], J[3][1], J[4][1], torch.as_tensor(visible))
    spreads = _ulp_spread(lambda n_, v_, l_: tuple(jpbr.direct_light(
        J[0][0], jm, jr, n_, v_, l_, J[4][0], jnp.asarray(visible))), (J[1][0], J[2][0], J[3][0]), trials=16)
    for a, b, sp in zip(got, want, spreads):
        _close_conditioned(a.numpy(), b, sp)
    assert (got.x.numpy() > 0).mean() > 0.2
    ndl, ndv = np.sum(nrm * l, 1), np.sum(nrm * v, 1)
    _close(tpbr.vis(torch.as_tensor(ndl), torch.as_tensor(ndv), tr).numpy(),
           jpbr.vis(jnp.asarray(ndl), jnp.asarray(ndv), jr))
    _close(tpbr.ggx_normal(torch.as_tensor(ndl), tr).numpy(), jpbr.ggx_normal(jnp.asarray(ndl), jr))
    s = tpbr.schlick(J[0][1], torch.as_tensor(ndv))
    for a, b in zip(s, jpbr.schlick(J[0][0], jnp.asarray(ndv))):
        _close(a.numpy(), b)
