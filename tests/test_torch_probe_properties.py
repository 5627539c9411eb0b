"""The probe's properties, on the port's functions (ROADMAP A.5): each test
of tests/test_probe.py (`:16`, `:26`, `:37`, `:59`, `:71`, `:88`, `:100`)
with the reference's image, sizes, streams and thresholds, run on
`optixpathtracer_tpu_torch.lights.probe` on the CPU. They hold what
tests/test_torch_probe_disney.py (lane for lane against JAX) does not:
that the tables are a distribution, the sampler draws from it, and the
estimator it feeds is unbiased."""
import numpy as np
import torch

from optixpathtracer_tpu_torch.core.math import Vec3, normalize
from optixpathtracer_tpu_torch.core.rng import RngState
from optixpathtracer_tpu_torch.lights import probe as P

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _gradient_probe(w=64, h=32, **kw):
    rng = np.random.default_rng(3)
    img = rng.random((h, w, 3)).astype(np.float32) + 0.01
    img[h // 4, w // 3] = 50.0  # a bright texel to stress importance sampling
    return P.build_probe(img, CPU, **kw), img


def _streams(n, subframe):
    return RngState.for_pixels(torch.arange(n, dtype=torch.int64), subframe)


def _arr(v: Vec3) -> np.ndarray:
    return np.stack([c.numpy() for c in v])


def _sphere_dirs(h=64, w=128):
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
    return P.uv_to_dir(torch.as_tensor(u.ravel(), dtype=torch.float32),
                       torch.as_tensor(v.ravel(), dtype=torch.float32))


def _pdf_total(p, h=64, w=128):
    pdf = P.probe_pdf(p, _sphere_dirs(h, w)).numpy().reshape(h, w)
    sin_t = np.sin(((np.arange(h) + 0.5) / h) * np.pi)
    return (pdf * sin_t[:, None]).sum() * (np.pi / h) * (2 * np.pi / w)


def _riemann(img):
    h, w = img.shape[:2]
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    return (img[..., 0] * sin_t[:, None]).sum() * (np.pi / h) * (2 * np.pi / w)


def _estimate(p, n, subframe):
    _, _, color, pdf = P.probe_sample(p, _streams(n, subframe))
    pdf = pdf.numpy()
    return np.divide(color.x.numpy(), pdf, out=np.zeros_like(pdf), where=pdf > 0).mean()


def test_cdf_monotone_and_normalized():
    p, _ = _gradient_probe()
    cy = p.cdf_y.numpy()
    assert np.all(np.diff(cy) >= -1e-6)
    np.testing.assert_allclose(cy[-1], 1.0, rtol=1e-5)
    cx = p.cdf_x.numpy()
    assert np.all(np.diff(cx, axis=1) >= -1e-6)
    np.testing.assert_allclose(cx[:, -1], 1.0, rtol=1e-5)


def test_uv_dir_roundtrip():
    d = np.random.default_rng(5).normal(size=(512, 3)).astype(np.float32)
    dv = normalize(Vec3(*(torch.as_tensor(d[:, k]) for k in range(3))))
    u, v = P.dir_to_uv(dv)
    np.testing.assert_allclose(_arr(P.uv_to_dir(u, v)), _arr(dv), atol=2e-3)


def test_sample_eval_agree():
    """The sampled colour is the image texel at the chosen (row, col); the
    direction maps back to within one texel (it sits on the texel's lower
    edge, the reference's ProbeSample convention)."""
    p, img = _gradient_probe()
    _, d, color, pdf, row, col = P.probe_sample_texel(p, _streams(2048, 0))
    row, col = row.numpy(), col.numpy()
    np.testing.assert_allclose(_arr(color).T, img[row, col], rtol=1e-5)
    u, v = P.dir_to_uv(d)
    ok = pdf.numpy() > 0  # pole rows (sin theta == 0) are pdf-0 and phi-degenerate
    dc = np.abs(u.numpy() * img.shape[1] - col)
    dc = np.minimum(dc, img.shape[1] - dc)  # phi wraps around
    assert np.all(dc[ok] <= 1.0 + 1e-3)
    assert np.all(np.abs(v.numpy() * img.shape[0] - row)[ok] <= 1.0 + 1e-3)


def test_importance_sampling_prefers_bright_texel():
    """The bright texel's luminance share is ~50 / (0.5 * 2048 + 50) ~ 4.6 %,
    a uniform sampler's 1 / 2048 ~ 0.05 %."""
    p, _ = _gradient_probe()
    _, _, color, _ = P.probe_sample(p, _streams(1 << 14, 1))
    assert (color.x.numpy() > 10.0).mean() > 0.03


def test_mc_integral_matches_riemann():
    """E[L / pdf] over probe samples == the integral of L over the sphere."""
    p, img = _gradient_probe()
    np.testing.assert_allclose(_estimate(p, 1 << 15, 2), _riemann(img), rtol=0.05)


def test_pdf_integrates_to_one():
    p, _ = _gradient_probe()
    np.testing.assert_allclose(_pdf_total(p), 1.0, rtol=0.05)


def test_gaussian_prefilter_stays_unbiased():
    """With the prefiltered CDF (OptixUtils/Texture.cpp:5-40) the estimate
    still equals the sphere integral (the pdf is what is sampled) and the
    pdf stays normalised."""
    p, img = _gradient_probe(gaussian_prefilter=True)
    np.testing.assert_allclose(_estimate(p, 1 << 15, 5), _riemann(img), rtol=0.05)
    np.testing.assert_allclose(_pdf_total(p), 1.0, rtol=0.05)
