"""Port parity, ops/denoise: `atrous_denoise` over its arguments (iterations
1 and 4, a variance guide with its boost, a depth guide, demodulation) and
`bilateral_denoise`, on the same numpy-seeded images through the JAX
function and the port, at rtol 1e-4 / atol 1e-6 (exp rounds a few ulps
apart in XLA:CPU and PyTorch, and each iteration feeds the next). The
shifts themselves are exact, and the property tests/test_denoise.py pins
(noise halves, the albedo edge survives) holds for the port too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.ops import denoise as jdn
from optixpathtracer_tpu_torch.ops import denoise as tdn

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-6


def _scene(seed, h=40, w=56):
    """Two albedo halves, a normal edge, a depth step, MC-like noise, and a
    per-pixel variance (numpy seed)."""
    rng = np.random.default_rng(seed)
    albedo = np.zeros((h, w, 3), np.float32)
    albedo[:, : w // 2] = (0.8, 0.2, 0.2)
    albedo[:, w // 2:] = (0.2, 0.8, 0.2)
    albedo[:3, :3] = 0.0  # demodulation's 1e-3 floor
    normal = np.zeros((h, w, 3), np.float32)
    normal[: h // 2] = (0, 1, 0)
    normal[h // 2:] = (1, 0, 0)
    clean = albedo * 0.5
    noisy = (clean + rng.normal(0, 0.15, clean.shape)).astype(np.float32)
    depth = np.where(np.arange(w)[None, :] < w // 3, 4.0, 9.0).astype(np.float32) * np.ones((h, 1), np.float32)
    depth[-4:] = 0.0  # misses
    variance = (rng.random((h, w)) * 0.02).astype(np.float32)
    return dict(color=noisy, normal=normal, albedo=albedo, clean=clean, depth=depth, variance=variance)


def _both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
    got = fn_t(*(torch.as_tensor(a) for a in arrays), **{
        k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}).numpy()
    return got, want


@pytest.mark.parametrize("shift", [(0, 0), (3, -2), (-8, 5), (40, 0), (0, -60)])
def test_shift2d_equal(shift):
    x = np.random.default_rng(1).random((12, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdn._shift2d(torch.as_tensor(x), *shift).numpy(),
                                  np.asarray(jdn._shift2d(jnp.asarray(x), *shift)))


CASES = {
    "defaults": {},
    "one_iteration": dict(iterations=1),
    "variance": dict(variance=True, sigma_color=4.0, var_boost=256.0),
    "depth": dict(depth=True, sigma_depth=0.1),
    "demodulate": dict(demodulate=True, sigma_albedo=1.0),
    "bench": dict(variance=True, sigma_color=4.0, sigma_albedo=1.0, var_boost=256.0, demodulate=True),
    "fovea4k": dict(depth=True, sigma_color=4.0, sigma_albedo=1.0, demodulate=True),
    "all_one_iteration": dict(iterations=1, variance=True, depth=True, demodulate=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_atrous_matches_jax(case):
    s = _scene(2)
    kw = dict(CASES[case])
    for guide in ("variance", "depth"):
        if kw.pop(guide, False):
            kw[guide] = s[guide]
    got, want = _both(jdn.atrous_denoise, tdn.atrous_denoise,
                      (s["color"], s["normal"], s["albedo"]), **kw)
    assert got.shape == want.shape == s["color"].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sigma_space, sigma_color", [(2, 0.4), (1, 0.1)])
def test_bilateral_matches_jax(sigma_space, sigma_color):
    s = _scene(3)
    got, want = _both(jdn.bilateral_denoise, tdn.bilateral_denoise, (s["color"],),
                      sigma_space=sigma_space, sigma_color=sigma_color)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_atrous_reduces_noise_and_keeps_the_albedo_edge():
    s = _scene(4, h=48, w=64)
    out = tdn.atrous_denoise(*(torch.as_tensor(s[k]) for k in ("color", "normal", "albedo"))).numpy()
    assert np.abs(out - s["clean"]).mean() < 0.5 * np.abs(s["color"] - s["clean"]).mean()
    w = out.shape[1]
    assert out[:, : w // 2 - 4, 0].mean() > out[:, w // 2 + 4:, 0].mean() + 0.2
