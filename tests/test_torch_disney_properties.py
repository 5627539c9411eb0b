"""The Disney BSDF's properties, on the port's functions (ROADMAP A.5):
each test of tests/test_disney.py (`:32`, `:48`, `:66` chi-square, `:109`
furnace, `:130`, `:141`, `:151`) with the reference's materials, sizes,
streams and thresholds, run on `optixpathtracer_tpu_torch.shade.disney`
on the CPU. tests/test_torch_probe_disney.py holds the BSDF lane for lane
against JAX; these hold that it is non-negative, that `bsdf_sample`
draws from `bsdf_pdf`, that it conserves energy, and the algebra the
spectral engine rests on."""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch.core.materials import build_table, make_material
from optixpathtracer_tpu_torch.core.math import Vec3, basis_from_vector, dot, normalize
from optixpathtracer_tpu_torch.core.rng import RngState
from optixpathtracer_tpu_torch.shade import disney

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mat_batch(n, **over):
    return build_table([make_material(**over)], CPU).take(torch.zeros(n, dtype=torch.int64))


def _full(n, x):
    return torch.full((n,), float(x), dtype=torch.float32)


def _frame(n):
    nrm = Vec3(_full(n, 0), _full(n, 0), _full(n, 1))
    u, v = basis_from_vector(nrm)
    return u, v, nrm


def _view(n, theta=0.5):
    return Vec3(_full(n, np.float32(np.sin(theta))), _full(n, 0), _full(n, np.float32(np.cos(theta))))


def _vec(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _streams(n, subframe):
    return RngState.for_pixels(torch.arange(n, dtype=torch.int64), subframe)


@pytest.mark.parametrize("over", [dict(), dict(roughness=0.1, metallic=1.0), dict(transmission=0.9),
                                  dict(subsurface=0.5), dict(clearcoat=1.0)],
                         ids=["default", "metal", "glass", "subsurface", "clearcoat"])
def test_eval_nonnegative_finite(over):
    n = 4096
    d = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    _, _, nrm = _frame(n)
    f = disney.bsdf_eval(_mat_batch(n, **over), Vec3(*(_full(n, 0.7),) * 3), _full(n, 1), _full(n, 1.5),
                         nrm, _view(n), normalize(_vec(d)))
    arr = np.stack([c.numpy() for c in f])
    assert np.all(np.isfinite(arr))
    assert np.all(arr >= -1e-6)


def test_sample_pdf_positive_and_consistent():
    """The pdf `bsdf_sample` returns equals `bsdf_pdf` at the sampled direction."""
    n = 8192
    mat = _mat_batch(n, roughness=0.4)
    u, v, nrm = _frame(n)
    view = _view(n)
    _, res = disney.bsdf_sample(mat, _full(n, 1), _full(n, 1.5), u, v, nrm, view, _streams(n, 0))
    p1 = res.pdf.numpy()
    p2 = disney.bsdf_pdf(mat, _full(n, 1), _full(n, 1.5), nrm, view, res.light).numpy()
    ok = p1 > 0
    # GGX reflection at roughness 0.4 puts a few % of samples below the
    # horizon (pdf 0: the path ends, as in the reference)
    assert ok.mean() > 0.85
    np.testing.assert_allclose(p1[ok], p2[ok], rtol=1e-4)


def test_sampled_directions_histogram_matches_pdf():
    """Chi-square: sampled directions binned over the sphere against pdf x
    solid angle at the bin centres."""
    n = 1 << 17
    u, v, nrm = _frame(n)
    _, res = disney.bsdf_sample(_mat_batch(n, roughness=0.6), _full(n, 1), _full(n, 1.5), u, v, nrm,
                                _view(n), _streams(n, 7))
    lz = res.light.z.numpy()
    lphi = np.arctan2(res.light.y.numpy(), res.light.x.numpy())
    nb_z, nb_p = 8, 8
    zi = np.clip(((lz + 1) / 2 * nb_z).astype(int), 0, nb_z - 1)
    pi_ = np.clip(((lphi + np.pi) / (2 * np.pi) * nb_p).astype(int), 0, nb_p - 1)
    counts = np.zeros((nb_z, nb_p))
    np.add.at(counts, (zi, pi_), 1.0)

    zc = (np.arange(nb_z) + 0.5) / nb_z * 2 - 1
    pc = (np.arange(nb_p) + 0.5) / nb_p * 2 * np.pi - np.pi
    zz, pp = np.meshgrid(zc, pc, indexing="ij")
    sz = np.sqrt(np.maximum(0, 1 - zz ** 2))
    ln = _vec(np.stack([sz * np.cos(pp), sz * np.sin(pp), zz], -1).reshape(-1, 3).astype(np.float32))
    m = zz.size
    _, _, nrm_m = _frame(m)
    pdf = disney.bsdf_pdf(_mat_batch(m, roughness=0.6), _full(m, 1), _full(m, 1.5), nrm_m, _view(m),
                          ln).numpy().reshape(nb_z, nb_p)
    expected = pdf * (2.0 / nb_z) * (2 * np.pi / nb_p) * n
    mask = expected > 80
    rel = np.abs(counts[mask] - expected[mask]) / expected[mask]
    assert np.median(rel) < 0.08, (np.median(rel), rel.max())


def test_furnace_energy_conservation():
    """White furnace: the BSDF-sampled estimate of the integral of f cos
    over the sphere stays within (0.3, 1.25) for a diffuse material."""
    n = 1 << 17
    mat = _mat_batch(n, color=(1.0, 1.0, 1.0), roughness=0.8)
    u, v, nrm = _frame(n)
    view = _view(n, theta=0.3)
    _, res = disney.bsdf_sample(mat, _full(n, 1), _full(n, 1.5), u, v, nrm, view, _streams(n, 13))
    f = disney.bsdf_eval(mat, Vec3(*(_full(n, 1.0),) * 3), _full(n, 1), _full(n, 1.5), nrm, view,
                         res.light)
    w = dot(res.light, nrm).numpy()
    pdf = res.pdf.numpy()
    val = np.where(pdf > 1e-6, f.x.numpy() * np.abs(w) / np.maximum(pdf, 1e-8), 0.0)
    assert 0.3 < val.mean() < 1.25, val.mean()


def test_fresnel_limits():
    def fd(c, ei, eo):
        return float(disney.fresnel_dielectric(torch.tensor([c]), torch.tensor([ei]), torch.tensor([eo]))[0])

    np.testing.assert_allclose(fd(1.0, 1.0, 1.5), 0.04, atol=1e-3)  # ((1 - 1.5) / 2.5)^2
    assert fd(0.01, 1.0, 1.5) > 0.9  # grazing
    np.testing.assert_allclose(fd(0.3, 1.5, 1.0), 1.0)  # total internal reflection


@pytest.mark.parametrize("a", [0.1, 0.5, 0.9])
def test_gtr2_normalized(a):
    """GTR2 is a normalised NDF: the hemisphere integral of D cos is 1."""
    nth = 4096
    th = (np.arange(nth) + 0.5) / nth * (np.pi / 2)
    d = disney.gtr2(torch.as_tensor(np.cos(th), dtype=torch.float32), torch.tensor(a)).numpy()
    integral = np.sum(d * np.cos(th) * np.sin(th)) * (np.pi / 2 / nth) * 2 * np.pi
    np.testing.assert_allclose(integral, 1.0, rtol=2e-2)


@pytest.mark.parametrize("kw", [
    dict(), dict(metallic=1.0), dict(metallic=0.5, roughness=0.3), dict(transmission=1.0, eta=1.5),
    dict(subsurface=0.6), dict(clearcoat=1.0), dict(specular_tint=1.0, metallic=0.4, roughness=0.3),
    dict(specular_tint=0.7, transmission=0.8, eta=1.5),
], ids=["default", "metal", "half_metal", "glass", "subsurface", "clearcoat", "tint", "tint_glass"])
def test_bsdf_eval_joint_affine_in_albedo_and_cspec0(kw):
    """Three overridden evals and the per-channel cspec0 rebuild reproduce
    the full RGB eval for every material class (the contract the spectral
    engine's per-wavelength reconstruction rests on; ctint, the one
    non-affine path, lives inside cspec0)."""
    rng = np.random.default_rng(5)
    n = 256
    nrm = np.zeros((n, 3), np.float32)
    nrm[:, 2] = 1
    v = rng.normal(0, 1, (n, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    l = rng.normal(0, 1, (n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    nv, vv, lv = _vec(nrm), _vec(v), _vec(l)
    eta_i = _full(n, 1)
    alb = np.array([0.7, 0.4, 0.15], np.float32)
    mt = _mat_batch(n, color=(0.6, 0.3, 0.2), **kw)
    eta_o = torch.where(eta_i == 1.0, mt.index_of_refraction(), 1.0)
    truth = disney.bsdf_eval(mt, Vec3(*(_full(n, a) for a in alb)), eta_i, eta_o, nv, vv, lv)
    zero, one = Vec3(*(_full(n, 0),) * 3), Vec3(*(_full(n, 1),) * 3)
    f00 = disney.bsdf_eval(mt, zero, eta_i, eta_o, nv, vv, lv, cspec0_override=zero)
    f10 = disney.bsdf_eval(mt, one, eta_i, eta_o, nv, vv, lv, cspec0_override=zero)
    f01 = disney.bsdf_eval(mt, zero, eta_i, eta_o, nv, vv, lv, cspec0_override=one)
    lum = 0.3 * alb[0] + 0.6 * alb[1] + 0.1 * alb[2]
    tint, m, spec = kw.get("specular_tint", 0.0), kw.get("metallic", 0.0), 0.5  # make_material's specular
    cspec = (1 + tint * (alb / lum - 1)) * 0.08 * spec * (1 - m) + m * alb
    for ch in range(3):
        pred = f00[ch] + (f10.x - f00.x) * float(alb[ch]) + (f01.x - f00.x) * float(cspec[ch])
        err = np.max(np.abs((pred - truth[ch]).numpy()) / (np.abs(truth[ch].numpy()) + 1e-6))
        assert err < 1e-5, (kw, ch, err)
