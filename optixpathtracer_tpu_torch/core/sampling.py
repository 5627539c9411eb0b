"""Sample warps of the Disney sampler (port of the warps of
optixpathtracer_tpu/core/sampling.py that the slice uses; the
stratified/blue-noise strategies wait for ROADMAP A.5)."""
from __future__ import annotations

from typing import Tuple

import torch

from .math import TWO_PI, Vec3

Tensor = torch.Tensor


def uniform_sample_hemisphere(u1: Tensor, u2: Tensor) -> Vec3:
    """z in [0,1), pdf = 1/(2*pi). (maths.h:241-252 draws z directly.)"""
    z = u1
    w = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return Vec3(torch.cos(phi) * w, torch.sin(phi) * w, z)


def uniform_sample_disc(u1: Tensor, u2: Tensor) -> Tuple[Tensor, Tensor]:
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u1: Tensor, u2: Tensor) -> Vec3:
    """pdf = cos(theta)/pi."""
    x, y = uniform_sample_disc(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return Vec3(x, y, z)
