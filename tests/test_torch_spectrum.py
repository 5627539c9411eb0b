"""Port parity, core/spectrum: every function against the JAX package on
the same seeded inputs, and tests/test_spectrum.py's properties held by the
port.

Tolerances: the hero wavelengths bit-exact (a multiply-add and a select);
the CIE fits, the Smits basis, rgb_to_spectrum and spectral_to_rgb rtol
1e-5 / atol 1e-6 (exp and the sigmoid round apart by a ulp); the two
constants computed at import within 2e-7 relative (the reference's grid is
jnp.linspace's, which XLA rounds a few ulps apart from f32 numpy; the
integral agrees exactly, the white scale within a ulp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core import spectrum as J
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu_torch.core import spectrum as S
from optixpathtracer_tpu_torch.core.math import Vec3

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _lam(n=4096, seed=0):
    lam = np.random.default_rng(seed).uniform(300, 800, n).astype(np.float32)
    return jnp.asarray(lam), torch.as_tensor(lam)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


def test_constants():
    assert S.CIE_Y_INTEGRAL == pytest.approx(J.CIE_Y_INTEGRAL, rel=2e-7)
    np.testing.assert_allclose(S.WHITE_SCALE, J.WHITE_SCALE, rtol=2e-7)
    assert (S.LAMBDA_MIN, S.LAMBDA_MAX, S.N_HERO) == (J.LAMBDA_MIN, J.LAMBDA_MAX, J.N_HERO)


@pytest.mark.parametrize("fn", ["cie_x", "cie_y", "cie_z"])
def test_cie_fits(fn):
    jl, tl = _lam()
    _close(getattr(S, fn)(tl), getattr(J, fn)(jl))
    _close(S.gauss(tl, 500.0, 20.0, 40.0), J.gauss(jl, 500.0, 20.0, 40.0))


def test_basis():
    jl, tl = _lam(seed=1)
    got, want = S._basis(tl), J._basis(jl)
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])


def test_xyz_to_srgb():
    x, y, z = np.random.default_rng(2).uniform(0, 2, (3, 1024)).astype(np.float32)
    for a, b in zip(S.xyz_to_srgb_linear(*map(torch.as_tensor, (x, y, z))),
                    J.xyz_to_srgb_linear(*map(jnp.asarray, (x, y, z)))):
        _close(a, b)


@pytest.mark.parametrize("lam_shape", ["per_ray", "grid"])
def test_rgb_to_spectrum(lam_shape):
    rng = np.random.default_rng(3)
    n = 2048
    rgb = rng.uniform(0, 1.2, (n, 3)).astype(np.float32)
    rgb[: n // 8] = rgb[: n // 8, :1]  # greys: the ties of the 6-way ordering
    rgb[n // 8: n // 4, 1] = rgb[n // 8: n // 4, 0]
    if lam_shape == "per_ray":
        lam = rng.uniform(380, 720, (n, 4)).astype(np.float32)
        jrgb = JVec3(*(jnp.asarray(rgb[:, i]) for i in range(3)))
        trgb = Vec3(*(torch.as_tensor(rgb[:, i].copy()) for i in range(3)))
    else:  # one colour against a grid of wavelengths
        lam = np.linspace(380, 720, 256, dtype=np.float32)[None, :]
        jrgb = JVec3(*(jnp.float32(c) for c in rgb[7]))
        trgb = Vec3(*(torch.tensor(float(c)) for c in rgb[7]))
    _close(S.rgb_to_spectrum(trgb, torch.as_tensor(lam)), J.rgb_to_spectrum(jrgb, jnp.asarray(lam)))


def test_sample_hero_wavelengths_bit_exact():
    u = np.random.default_rng(4).random(4096, dtype=np.float32)
    u[:3] = (0.0, 0.999999, 0.75)
    got = S.sample_hero_wavelengths(torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J.sample_hero_wavelengths(jnp.asarray(u))))
    assert got.shape == (4096, S.N_HERO)


def test_spectral_to_rgb():
    rng = np.random.default_rng(5)
    rad = rng.uniform(0, 3, (2048, 4)).astype(np.float32)
    lam = np.array(J.sample_hero_wavelengths(jnp.asarray(rng.random(2048, dtype=np.float32))))
    for fn in ("spectral_to_rgb", "spectral_to_rgb_calibrated"):
        for a, b in zip(getattr(S, fn)(torch.as_tensor(rad), torch.as_tensor(lam)),
                        getattr(J, fn)(jnp.asarray(rad), jnp.asarray(lam))):
            _close(a, b)


# ---- tests/test_spectrum.py's properties, held by the port ----------------

def _grid(n):
    return torch.linspace(S.LAMBDA_MIN, S.LAMBDA_MAX, n)[None, :]


def test_cie_y_peak_near_555():
    lam = torch.linspace(380.0, 720.0, 500)
    y = S.cie_y(lam).numpy()
    assert 540 < float(lam[y.argmax()]) < 570 and y.max() > 0.9


def test_hero_wavelengths_in_range_and_rotated():
    lam = S.sample_hero_wavelengths(torch.as_tensor(np.linspace(0, 0.999, 64, dtype=np.float32))).numpy()
    assert lam.min() >= S.LAMBDA_MIN - 1e-3 and lam.max() <= S.LAMBDA_MAX + 1e-3
    d = np.sort((lam - lam[:, :1]) % S.LAMBDA_RANGE, axis=1)
    np.testing.assert_allclose(d[:, 1], S.LAMBDA_RANGE / 4, atol=1.0)


def test_white_and_primaries_roundtrip():
    lam = _grid(512)
    one = torch.ones(())
    rgb = S.spectral_to_rgb_calibrated(S.rgb_to_spectrum(Vec3(one, one, one), lam), lam)
    np.testing.assert_allclose([float(c[0]) for c in rgb], 1.0, rtol=2e-2)
    for rgb_in, dominant in [((1, 0.1, 0.1), 0), ((0.1, 1, 0.1), 1), ((0.1, 0.1, 1), 2)]:
        c = Vec3(*(torch.tensor(float(v)) for v in rgb_in))
        out = [float(v[0]) for v in S.spectral_to_rgb_calibrated(S.rgb_to_spectrum(c, lam), lam)]
        assert int(np.argmax(out)) == dominant and out[dominant] > 0.5


def test_spectrum_nonnegative_bounded():
    lam = _grid(256)
    for r, g, b in np.random.default_rng(0).random((16, 3)):
        spec = S.rgb_to_spectrum(Vec3(*(torch.tensor(float(v)) for v in (r, g, b))), lam).numpy()
        assert spec.min() >= -1e-4 and spec.max() <= 2.2


def test_mc_estimator_matches_dense_integration():
    c = Vec3(torch.tensor(0.7), torch.tensor(0.4), torch.tensor(0.2))
    lam_d = _grid(2048)
    ref = S.spectral_to_rgb_calibrated(S.rgb_to_spectrum(c, lam_d), lam_d)
    lam = S.sample_hero_wavelengths(torch.as_tensor(np.random.default_rng(1).random(8192, dtype=np.float32)))
    out = S.spectral_to_rgb_calibrated(S.rgb_to_spectrum(c, lam), lam)
    np.testing.assert_allclose([float(v.mean()) for v in out], [float(v[0]) for v in ref], rtol=0.05)
