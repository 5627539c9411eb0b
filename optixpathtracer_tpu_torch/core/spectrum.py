"""Hero-wavelength spectral rendering support (port of
optixpathtracer_tpu/core/spectrum.py).

Reference: HelloPathtracing_sv3/spectrum.h — multi-lobe Gaussian CIE fits
(:508-523, Wyman et al. 2013), XYZ->sRGB (:399-416) and a Smits-style
white/cyan/magenta/yellow/red/green/blue RGB->spectrum basis (:585-636).
Reflectance spectra are evaluated analytically at the hero wavelength and
its rotated companions, so a path carries an (N, 4) spectral throughput.
The basis is built from smooth band windows; the white point is calibrated
so an equal-energy white round-trips to rgb (1, 1, 1).
"""
from __future__ import annotations

import torch

from .math import Vec3

Tensor = torch.Tensor

LAMBDA_MIN = 380.0
LAMBDA_MAX = 720.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN
N_HERO = 4  # hero wavelength + 3 rotations


def gauss(x: Tensor, mu: float, s1: float, s2: float) -> Tensor:
    """Piecewise two-sided Gaussian (Wyman 2013 / spectrum.h:508-511)."""
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return torch.exp(-0.5 * t * t)


def cie_x(lam: Tensor) -> Tensor:
    return (1.056 * gauss(lam, 599.8, 37.9, 31.0) + 0.362 * gauss(lam, 442.0, 16.0, 26.7)
            - 0.065 * gauss(lam, 501.1, 20.4, 26.2))


def cie_y(lam: Tensor) -> Tensor:
    return 0.821 * gauss(lam, 568.8, 46.9, 40.5) + 0.286 * gauss(lam, 530.9, 16.3, 31.1)


def cie_z(lam: Tensor) -> Tensor:
    return 1.217 * gauss(lam, 437.0, 11.8, 36.0) + 0.681 * gauss(lam, 459.0, 26.0, 13.8)


def _lam_grid(num: int = 256) -> Tensor:
    """The normalisation grid over [LAMBDA_MIN, LAMBDA_MAX], spaced as
    jnp.linspace spaces it: start * (1 - s) + stop * s with s = i / (num - 1)
    in f32, the last point exactly stop."""
    s = torch.arange(num - 1, dtype=torch.float32) / float(num - 1)
    out = LAMBDA_MIN * (1.0 - s) + LAMBDA_MAX * s
    return torch.cat([out, torch.tensor([LAMBDA_MAX])])


# integral of cie_y over [LAMBDA_MIN, LAMBDA_MAX] (the normalisation), in f32
CIE_Y_INTEGRAL = float(torch.trapezoid(cie_y(_lam_grid()), _lam_grid()))


def xyz_to_srgb_linear(x: Tensor, y: Tensor, z: Tensor) -> Vec3:
    """CIE XYZ -> linear sRGB (the matrix of spectrum.h XYZToSRGB)."""
    r = 3.2404542 * x - 1.5371385 * y - 0.4985314 * z
    g = -0.9692660 * x + 1.8760108 * y + 0.0415560 * z
    b = 0.0556434 * x - 0.2040259 * y + 1.0572252 * z
    return Vec3(r, g, b)


# ---- Smits-style analytic basis ---------------------------------------------

def _band(lam: Tensor, lo: float, hi: float, soft: float = 12.0) -> Tensor:
    """Smooth box window over [lo, hi] nm. The width divides as a 0-dim
    tensor on lam's device: CUDA takes `x / python_float` as a product with
    the reciprocal, one ulp from the CPU's (and XLA's) division."""
    s = torch.tensor(soft, dtype=torch.float32, device=lam.device)
    return torch.sigmoid((lam - lo) / s) * torch.sigmoid((hi - lam) / s)


def _basis(lam: Tensor) -> dict[str, Tensor]:
    blue = _band(lam, 340.0, 490.0)
    green = _band(lam, 490.0, 595.0)
    red = _band(lam, 595.0, 760.0)
    return dict(
        white=torch.ones_like(lam),
        red=red,
        green=green,
        blue=blue,
        cyan=torch.clamp(green + blue, 0.0, 1.05),
        magenta=torch.clamp(red + blue, 0.0, 1.05),
        yellow=torch.clamp(red + green, 0.0, 1.05),
    )


def rgb_to_spectrum(rgb: Vec3, lam: Tensor) -> Tensor:
    """The reflectance spectrum of an RGB albedo at wavelengths lam: the
    smallest channel contributes white, the secondary / primary bases fill
    the rest (Smits, spectrum.h rgb2spectrum :585-636). The rgb components
    broadcast against lam (trailing axes added as needed)."""
    b = _basis(lam)

    def expand(c):
        c = torch.as_tensor(c, dtype=torch.float32, device=lam.device)
        while c.ndim < lam.ndim:
            c = c[..., None]
        return c

    r, g, bl = expand(rgb.x), expand(rgb.y), expand(rgb.z)

    # branchless reformulation of the 6-way ordering
    m = torch.minimum(r, torch.minimum(g, bl))
    out = b["white"] * m

    r_min = (r <= g) & (r <= bl)
    g_min = (g < r) & (g <= bl)
    # case r smallest: cyan covers min(g, b) - r, then the blue/green remainder
    c1 = torch.minimum(g, bl) - r
    rem_gb = (g - bl).abs()
    case_r = b["cyan"] * torch.clamp(c1, min=0.0) + torch.where(
        g <= bl, b["blue"] * rem_gb, b["green"] * rem_gb)
    # case g smallest
    c2 = torch.minimum(r, bl) - g
    rem_rb = (r - bl).abs()
    case_g = b["magenta"] * torch.clamp(c2, min=0.0) + torch.where(
        r <= bl, b["blue"] * rem_rb, b["red"] * rem_rb)
    # case b smallest
    c3 = torch.minimum(r, g) - bl
    rem_rg = (r - g).abs()
    case_b = b["yellow"] * torch.clamp(c3, min=0.0) + torch.where(
        r <= g, b["green"] * rem_rg, b["red"] * rem_rg)

    return out + torch.where(r_min, case_r, torch.where(g_min, case_g, case_b))


def sample_hero_wavelengths(u: Tensor) -> Tensor:
    """u (N,) uniform -> (N, N_HERO) wavelengths: the hero and its equally
    rotated companions (pdf 1/LAMBDA_RANGE each)."""
    hero = LAMBDA_MIN + u * LAMBDA_RANGE
    k = torch.arange(N_HERO, dtype=torch.float32, device=u.device) / N_HERO
    lam = hero[:, None] + k[None, :] * LAMBDA_RANGE
    return torch.where(lam > LAMBDA_MAX, lam - LAMBDA_RANGE, lam)


def spectral_to_rgb(radiance: Tensor, lam: Tensor) -> Vec3:
    """MC estimate: (N, H) spectral radiance at wavelengths lam -> linear
    sRGB: divide by the uniform pdf, average the H samples, integrate
    against the CIE curves and convert (spectrum.h:236-258)."""
    w = LAMBDA_RANGE / lam.shape[-1] / CIE_Y_INTEGRAL
    x = _sum_last(radiance * cie_x(lam)) * w
    y = _sum_last(radiance * cie_y(lam)) * w
    z = _sum_last(radiance * cie_z(lam)) * w
    return xyz_to_srgb_linear(x, y, z)


def _sum_last(a: Tensor) -> Tensor:
    """Sum over the last axis. The hero axis (N_HERO wide) adds left to
    right, the CPU `torch.sum`'s order at that width, which a CUDA reduction
    does not keep; a wider axis (the white calibration below, on the CPU at
    import) takes `torch.sum`, whose CPU order there is another."""
    if a.shape[-1] > N_HERO:
        return torch.sum(a, dim=-1)
    out = a[..., 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k]
    return out


# white-point calibration: a perfect white reflector under an equal-energy
# illuminant round-trips to rgb == (1, 1, 1)
_w = spectral_to_rgb(torch.ones((1, 256)), _lam_grid()[None, :])
WHITE_SCALE = (1.0 / float(_w.x[0]), 1.0 / float(_w.y[0]), 1.0 / float(_w.z[0]))
del _w


def spectral_to_rgb_calibrated(radiance: Tensor, lam: Tensor) -> Vec3:
    c = spectral_to_rgb(radiance, lam)
    return Vec3(c.x * WHITE_SCALE[0], c.y * WHITE_SCALE[1], c.z * WHITE_SCALE[2])
