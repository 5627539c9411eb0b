"""Metallic-roughness GGX direct lighting, the whitted pipeline's shading
(port of optixpathtracer_tpu/shade/pbr.py).

Reference: cuda/whitted.cu __closesthit__radiance (:114-198) — base color x
texture, F0=0.04 dielectric split, Cook-Torrance with Schlick Fresnel +
Smith-style visibility + GGX NDF (whitted_cuda.h schlick/vis/ggxNormal
:48-80), one shadow ray per point light, ambient adds base color.
"""
from __future__ import annotations

import torch

from ..core.math import INV_PI, PI, Vec3, dot, lerp, where

Tensor = torch.Tensor

F0 = 0.04


def schlick(spec_color: Vec3, v_dot_h: Tensor) -> Vec3:
    m = torch.clamp(1.0 - v_dot_h, 0.0, 1.0)
    m2 = m * m
    return spec_color + (1.0 - spec_color) * (m2 * m2 * m)


def vis(n_dot_l: Tensor, n_dot_v: Tensor, alpha: Tensor) -> Tensor:
    """Height-correlated-ish visibility term (whitted_cuda.h vis)."""
    a2 = alpha * alpha
    gv = n_dot_l * torch.sqrt(torch.clamp(n_dot_v * n_dot_v * (1.0 - a2) + a2, min=1e-12))
    gl = n_dot_v * torch.sqrt(torch.clamp(n_dot_l * n_dot_l * (1.0 - a2) + a2, min=1e-12))
    return 0.5 / torch.clamp(gv + gl, min=1e-12)


def ggx_normal(n_dot_h: Tensor, alpha: Tensor) -> Tensor:
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * d * d, min=1e-12)


def direct_light(base_color: Vec3, metallic: Tensor, roughness: Tensor, n: Vec3,
                 v: Vec3, l: Vec3, light_color: Vec3, visible: Tensor) -> Vec3:
    """One point light's contribution at a hit (whitted.cu:158-188). v and l
    are unit, toward the viewer and the light; light_color is color x
    intensity; visible is the shadow ray's result (True: unoccluded)."""
    diff_color = base_color * ((1.0 - F0) * (1.0 - metallic))
    one = Vec3(*(torch.ones_like(metallic),) * 3)
    spec_color = lerp(one * F0, base_color, metallic)
    alpha = roughness * roughness

    h = Vec3(l.x + v.x, l.y + v.y, l.z + v.z)
    h = h * torch.rsqrt(torch.clamp(dot(h, h), min=1e-12))
    n_dot_l = dot(n, l)
    n_dot_v = dot(n, v)
    n_dot_h = dot(n, h)
    v_dot_h = dot(v, h)

    f = schlick(spec_color, v_dot_h)
    g = vis(n_dot_l, n_dot_v, alpha)
    d = ggx_normal(n_dot_h, alpha)

    diff = (one - f) * diff_color * INV_PI
    spec = f * (g * d)
    lit = (n_dot_l > 0.0) & (n_dot_v > 0.0) & visible
    out = light_color * ((diff + spec) * n_dot_l)
    zero = torch.zeros_like(metallic)
    return where(lit, out, Vec3(zero, zero, zero))
