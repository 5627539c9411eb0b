"""Post-process: exposure, tone mapping, sRGB encode, RGBA8 pack (port of
optixpathtracer_tpu/ops/tonemap.py)."""
from __future__ import annotations

import torch

from ..core.math import Vec3

Tensor = torch.Tensor

TONEMAP_NONE = "none"
TONEMAP_SQRT = "sqrt"  # toneMap.cu behavior (gamma 2.0)
TONEMAP_REINHARD = "reinhard"  # sv4 device behavior


def exposure(c: Vec3, stops: float) -> Vec3:
    """Exposure correction: c * 2^stops."""
    return c * (2.0**stops)


def reinhard(c: Vec3, white: float = 1.0) -> Vec3:
    lum = 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z
    return c * (1.0 / (1.0 + lum / white))


def to_srgb(c: Vec3) -> Vec3:
    """Exact sRGB OETF on clamped linear input (helpers.h toSRGB)."""

    def enc(x):
        x = torch.clamp(x, 0.0, 1.0)
        lo = 12.92 * x
        hi = 1.055 * torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.4) - 0.055
        return torch.where(x < 0.0031308, lo, hi)

    return Vec3(enc(c.x), enc(c.y), enc(c.z))


def quantize_u8(x: Tensor) -> Tensor:
    """Round-to-nearest 8-bit quantization."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def finalize(c: Vec3, mode: str = TONEMAP_REINHARD, exposure_stops: float = 0.0,
             srgb: bool = True) -> Vec3:
    """Full post chain in linear float; returns display-ready [0,1] RGB."""
    if exposure_stops != 0.0:
        c = exposure(c, exposure_stops)
    if mode == TONEMAP_SQRT:
        c = Vec3(*(torch.sqrt(torch.clamp(a, min=0.0)) for a in c))
    elif mode == TONEMAP_REINHARD:
        c = reinhard(c)
    elif mode != TONEMAP_NONE:
        raise ValueError(f"unknown tonemap mode {mode!r}")
    if srgb:
        return to_srgb(c)
    return Vec3(*(torch.clamp(a, 0.0, 1.0) for a in c))


def pack_rgba8(c: Vec3) -> Tensor:
    """(N,) Vec3 in [0,1] -> (N, 4) uint8 with alpha 255."""
    r = quantize_u8(c.x)
    return torch.stack([r, quantize_u8(c.y), quantize_u8(c.z), torch.full_like(r, 255)], dim=-1)
