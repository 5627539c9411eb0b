"""AOV-guided denoiser: edge-avoiding À-Trous wavelet filtering (port of
optixpathtracer_tpu/ops/denoise.py).

The reference's OptixDenoiser wrapper has empty init()/exec() stubs
(HelloPathtracing_original/OptixDenoiser.cpp:15-43) while the renderer
fills the color/albedo/normal guide buffers; here those guides drive a real
filter (Dammertz et al. 2010): per iteration 5x5 B3-spline taps at a
dilation that doubles, each tap weighted by color, normal, albedo (and
optionally depth) similarity. Plain tensor code on (H, W, C) planes: every
tap is a static shift with edge replication, on the inputs' device, in the
reference's f32 expression order.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# 5-tap B3-spline, separable
_B3 = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def _shift2d(x: Tensor, dy: int, dx: int) -> Tensor:
    """out[i, j] = x[clamp(i - dy), clamp(j - dx)]: a static shift with edge
    clamp (replicate padding)."""
    h, w = x.shape[:2]
    rows = torch.clamp(torch.arange(h, device=x.device) - dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=x.device) - dx, 0, w - 1)
    return x[rows][:, cols]


def atrous_denoise(
    color: Tensor,  # (H, W, 3) linear radiance
    normal: Tensor,  # (H, W, 3)
    albedo: Tensor,  # (H, W, 3)
    iterations: int = 4,
    sigma_color=0.5,
    sigma_normal: float = 0.25,
    sigma_albedo=0.25,
    variance: Tensor | None = None,  # (H, W) variance of the per-pixel mean
    var_boost=64.0,
    depth: Tensor | None = None,  # (H, W) first-hit distance (0 = miss)
    sigma_depth=0.1,
    demodulate: bool = False,
) -> Tensor:
    """Edge-avoiding À-Trous filter; returns the denoised (H, W, 3).

    variance (optional): per-pixel variance of the running-mean luminance;
    the color edge-stop's denominator grows with the local noise level
    (SVGF-style), so noisy regions smooth through what a fixed sigma would
    read as edges. depth (optional): first-hit distance guide, a relative
    term |zp - zq| / max(zp, zq) that stops the filter at geometric
    discontinuities between surfaces whose normal and albedo agree.
    demodulate: filter illumination (color / albedo) and re-modulate."""
    out = color
    if demodulate:
        mod = torch.clamp(albedo, min=1e-3)
        out = color / mod
    if variance is not None:
        var = torch.clamp(variance, min=0.0)[..., None]
    if depth is not None:
        z = depth[..., None]
    denom_n = sigma_normal * sigma_normal
    denom_a = sigma_albedo * sigma_albedo
    for it in range(iterations):
        step = 1 << it
        accum = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype, device=out.device)
        denom_c = sigma_color * sigma_color
        if variance is not None:
            denom_c = denom_c * (1.0 + var_boost * var)
        for i in range(5):
            for j in range(5):
                dy = (i - 2) * step
                dx = (j - 2) * step
                k = float(_B3[i] * _B3[j])
                c = _shift2d(out, dy, dx)
                dc = ((c - out) ** 2).sum(-1, keepdim=True)
                dn = ((_shift2d(normal, dy, dx) - normal) ** 2).sum(-1, keepdim=True)
                da = ((_shift2d(albedo, dy, dx) - albedo) ** 2).sum(-1, keepdim=True)
                e = -dc / denom_c - dn / denom_n - da / denom_a
                if depth is not None:
                    zz = _shift2d(z, dy, dx)
                    dz = (zz - z) / torch.clamp(torch.maximum(zz, z), min=1e-6)
                    e = e - dz * dz / (sigma_depth * sigma_depth)
                wgt = k * torch.exp(e)
                accum = accum + c * wgt
                wsum = wsum + wgt
        out = accum / torch.clamp(wsum, min=1e-8)
    if demodulate:
        out = out * mod
    return out


def bilateral_denoise(color: Tensor, sigma_space: int = 2, sigma_color: float = 0.4) -> Tensor:
    """Single-pass joint bilateral (no guides): a cheap fallback."""
    r = sigma_space
    accum = torch.zeros_like(color)
    wsum = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype, device=color.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            c = _shift2d(color, dy, dx)
            spatial = float(torch.exp(torch.tensor(-(dy * dy + dx * dx) / (2.0 * r * r),
                                                   dtype=torch.float32)))
            dc = ((c - color) ** 2).sum(-1, keepdim=True)
            wgt = spatial * torch.exp(-dc / (sigma_color * sigma_color))
            accum = accum + c * wgt
            wsum = wsum + wgt
    return accum / torch.clamp(wsum, min=1e-8)
