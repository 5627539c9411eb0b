"""Port parity, shade/bsdf_vis: the lobe maps and the sample splat against
the JAX package, and tests/test_bsdf_vis.py's checks held by the port
(samples land where the pdf map says; the composite image).

Tolerances: the maps as tests/test_torch_probe_disney.py holds the Disney
BSDF (rtol 1e-5 / atol 1e-6 on 99 % of pixels; the reference's
near-grazing wo makes a few GGX lanes ill-conditioned, held within rtol
1e-3); the splat histogram equal to JAX's but for samples whose direction
rounds across a pixel border (at most 1 % of samples moved).
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.shade import bsdf_vis as J
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.shade import bsdf_vis as B

torch.set_num_threads(1)
W, H = 128, 64
MATS = {
    "glossy": dict(color=(0.95, 0.9, 0.9), specular=1.0, roughness=0.025),
    "diffuse": dict(color=(0.6, 0.6, 0.6), roughness=0.8),
    "metal": dict(color=(0.9, 0.7, 0.3), metallic=1.0, roughness=0.2),
    "glass": dict(color=(0.9, 0.9, 0.9), transmission=1.0, eta=1.5, roughness=0.3),
}


@pytest.mark.parametrize("name", sorted(MATS))
def test_maps_and_splat_equal_to_jax(name):
    f, pdf = B.bsdf_maps(make_material(**MATS[name]), width=W, height=H, device="cpu")
    jf, jpdf = J.bsdf_maps(jmake(**MATS[name]), width=W, height=H)
    for a, b in ((f, jf), (pdf, jpdf)):
        ok = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert ok.mean() >= 0.99
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
    n = 4000
    hist = B.bsdf_sample_splat(make_material(**MATS[name]), width=W, height=H, n_samples=n, device="cpu")
    jhist = np.asarray(J.bsdf_sample_splat(jmake(**MATS[name]), width=W, height=H, n_samples=n))
    assert hist.dtype == np.int32 and hist.sum() == jhist.sum()
    assert np.abs(hist - jhist).sum() <= 0.02 * n


def _expected_mass(pdf_img):
    theta = (np.arange(H) + 0.5) / H * np.pi
    mass = pdf_img * np.sin(theta)[:, None] * (np.pi / H) * (2 * np.pi / W)
    return mass / mass.sum()


@pytest.mark.parametrize("name", ["glossy", "diffuse", "metal"])
def test_samples_match_pdf_map(name):
    mat = make_material(**MATS[name])
    _, pdf = B.bsdf_maps(mat, width=W, height=H, device="cpu")
    n = 40000
    hist = B.bsdf_sample_splat(mat, width=W, height=H, n_samples=n, device="cpu")
    kept = hist.sum()
    assert kept > 0.6 * n

    def coarse(a, b=8):
        return a.reshape(H // b, b, W // b, b).sum(axis=(1, 3))

    tv = 0.5 * np.abs(coarse(_expected_mass(pdf)) - coarse(hist / kept)).sum()
    assert tv < 0.15, f"sampling disagrees with the pdf map: TV={tv:.3f}"


def test_composite_image():
    img = B.bsdf_test_image(width=W, height=H, n_samples=500, device="cpu")
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    red = (img[..., 0] == 1.0) & (img[..., 1] == 0.0) & (img[..., 2] == 0.0)
    assert 0 < red.sum() <= 500
    assert np.all(img[..., 2][~red] == 0.5)
    want = np.asarray(J.bsdf_test_image(width=W, height=H, n_samples=500))
    assert (red == ((want[..., 0] == 1.0) & (want[..., 1] == 0.0))).mean() > 0.99
