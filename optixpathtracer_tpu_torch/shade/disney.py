"""Disney/principled BSDF — sample / eval / pdf, batched and branchless
(port of optixpathtracer_tpu/shade/disney.py; same lobes, the same fixed
budget of six uniforms per sample, and the same kept reference quirks)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.materials import MaterialTable
from ..core.math import (
    INV_PI,
    INV_TWO_PI,
    PI,
    TWO_PI,
    Vec3,
    dot,
    lerp,
    local_to_world,
    refract,
    safe_normalize,
    where,
)
from ..core.rng import RngState, randf
from ..core.sampling import cosine_sample_hemisphere, uniform_sample_hemisphere

Tensor = torch.Tensor

# BSDF event types (Disney.cuh BSDFType)
REFLECTED = 0
TRANSMITTED = 1
SPECULAR = 2


def schlick_fresnel(u: Tensor) -> Tensor:
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def gtr1(n_dot_h: Tensor, a: Tensor) -> Tensor:
    a = torch.clamp(a, min=1e-4)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    val = (a2 - 1.0) / (PI * torch.log(a2) * t)
    return torch.where(a >= 1.0, INV_PI, val)


def gtr2(n_dot_h: Tensor, a: Tensor) -> Tensor:
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (PI * t * t)


def smith_ggx(n_dot_v: Tensor, alpha_g) -> Tensor:
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / torch.clamp(n_dot_v + torch.sqrt(a + b - a * b), min=1e-8)


def fresnel_dielectric(v_dot_n: Tensor, eta_i: Tensor, eta_o: Tensor) -> Tensor:
    """Exact dielectric Fresnel with TIR -> 1 (Fr, Disney.cuh:80-97)."""
    sin2_t = (eta_i / eta_o) ** 2 * (1.0 - v_dot_n * v_dot_n)
    tir = sin2_t > 1.0
    l_dot_n = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    eta = eta_o / eta_i
    denom1 = v_dot_n + eta * l_dot_n
    denom2 = l_dot_n + eta * v_dot_n
    r1 = (v_dot_n - eta * l_dot_n) / torch.where(denom1.abs() > 1e-8, denom1, 1e-8)
    r2 = (l_dot_n - eta * v_dot_n) / torch.where(denom2.abs() > 1e-8, denom2, 1e-8)
    f = 0.5 * (r1 * r1 + r2 * r2)
    return torch.where(tir, 1.0, f)


def bsdf_pdf(mat: MaterialTable, eta_i, eta_o, n: Vec3, v: Vec3, l: Vec3) -> Tensor:
    """Solid-angle pdf of BSDFSample having produced l (BSDFPdf semantics)."""
    l_dot_n = dot(l, n)

    # backside: only the subsurface half of the 50/50 diffuse choice lands here
    below_brdf = INV_TWO_PI * mat.subsurface * 0.5
    below = lerp(below_brdf, 0.0, mat.transmission)

    f = fresnel_dielectric(dot(n, v), eta_i, eta_o)
    a = torch.clamp(mat.roughness, min=0.001)
    half = safe_normalize(l + v)
    cos_theta_half = dot(half, n).abs()
    pdf_half = gtr2(cos_theta_half, a) * cos_theta_half
    pdf_spec = 0.25 * pdf_half / torch.clamp(dot(l, half), min=1e-6)
    pdf_diff = l_dot_n.abs() * INV_PI * (1.0 - mat.subsurface)
    above_bsdf = pdf_spec * f
    above_brdf = lerp(pdf_diff, pdf_spec, 0.5)
    above = lerp(above_brdf, above_bsdf, mat.transmission)
    return torch.where(l_dot_n <= 0.0, below, above)


def _sample_ggx_half(u: Vec3, v: Vec3, n: Vec3, view: Vec3, roughness, r1, r2) -> Vec3:
    """GTR2 half-vector importance sample, flipped into the view hemisphere."""
    a = torch.clamp(roughness, min=0.001)
    phi = r1 * TWO_PI
    cos_th = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    half = local_to_world(
        Vec3(sin_th * torch.cos(phi), sin_th * torch.sin(phi), cos_th), u, v, n)
    flip = dot(half, view) <= 0.0
    return where(flip, -half, half)


class BSDFSampleResult(NamedTuple):
    light: Vec3  # sampled direction
    pdf: Tensor  # solid-angle pdf (0 => terminate path)
    event: Tensor  # int32: REFLECTED / TRANSMITTED / SPECULAR


def bsdf_sample(mat: MaterialTable, eta_i, eta_o, u: Vec3, v: Vec3, n: Vec3,
                view: Vec3, state: RngState, u12=None) -> tuple[RngState, BSDFSampleResult]:
    """Importance-sample the BSDF (BSDFSample semantics, mask-combined).

    u12 (optional (u1, u2)): caller-supplied uniforms replacing the (r1, r2)
    lobe-direction draw (the engine's low-discrepancy `sampling=`
    strategies); those two state advances are skipped then, the other four
    draws keep their order."""
    state, u_lobe = randf(state)
    state, u_f = randf(state)
    if u12 is None:
        state, r1 = randf(state)
        state, r2 = randf(state)
    else:
        r1, r2 = u12
    state, u_half = randf(state)
    state, u_ss = randf(state)

    trans_path = u_lobe < mat.transmission
    f = fresnel_dielectric(dot(n, view), eta_i, eta_o)

    # (a) glossy reflection half-vector
    half = _sample_ggx_half(u, v, n, view, mat.roughness, r1, r2)
    l_spec = half * (2.0 * dot(view, half)) - view

    # (b) specular transmission (delta)
    l_refr, refr_ok = refract(view, n, eta_i / eta_o)

    # (c) diffuse: subsurface (into the surface) or cosine hemisphere
    d_ss = uniform_sample_hemisphere(r1, r2)
    l_ss = u * d_ss.x + v * d_ss.y - n * d_ss.z
    d_cos = cosine_sample_hemisphere(r1, r2)
    l_cos = local_to_world(d_cos, u, v, n)

    refract_spec = trans_path & ~(u_f < f)
    diffuse_half = ~trans_path & (u_half < 0.5)
    subsurface = diffuse_half & (u_ss < mat.subsurface)
    cosine = diffuse_half & ~(u_ss < mat.subsurface)

    light = where(refract_spec, l_refr, where(subsurface, l_ss, where(cosine, l_cos, l_spec)))
    event = torch.where(
        refract_spec, SPECULAR, torch.where(subsurface, TRANSMITTED, REFLECTED)
    ).to(torch.int32)

    pdf_smooth = bsdf_pdf(mat, eta_i, eta_o, n, view, light)
    pdf_delta = torch.where(refr_ok, (1.0 - f) * mat.transmission, 0.0)
    pdf = torch.where(refract_spec, pdf_delta, pdf_smooth)
    return state, BSDFSampleResult(light=light, pdf=pdf, event=event)


def bsdf_eval(mat: MaterialTable, albedo: Vec3, eta_i, eta_o, n: Vec3, v: Vec3, l: Vec3,
              cspec0_override: Vec3 | None = None) -> Vec3:
    """Evaluate the full principled BSDF (BSDFEval semantics).

    cspec0_override: replaces the derived specular color. The eval is
    jointly affine in (albedo, cspec0), so three overridden evals rebuild
    the exact per-wavelength BSDF of the spectral engine (engine/spectral)."""
    n_dot_l = dot(n, l)
    n_dot_v = dot(n, v)
    h = safe_normalize(l + v)
    n_dot_h = dot(n, h)
    l_dot_h = dot(l, h)

    def const3(c):
        return Vec3(*(torch.full_like(n_dot_l, c),) * 3)

    one = const3(1.0)
    zero = const3(0.0)

    cd_lin = albedo
    cd_lum = 0.3 * cd_lin.x + 0.6 * cd_lin.y + 0.1 * cd_lin.z
    ctint = where(cd_lum > 0.0, cd_lin / torch.clamp(cd_lum, min=1e-8), one)
    cspec0 = lerp(lerp(one, ctint, mat.specular_tint) * (mat.specular * 0.08), cd_lin, mat.metallic)
    if cspec0_override is not None:
        cspec0 = cspec0_override

    a = torch.clamp(mat.roughness, min=0.001)

    # --- transmission lobe (bsdf) ---
    f_v = fresnel_dielectric(n_dot_v, eta_i, eta_o)
    bsdf_below = mat.transmission * (1.0 - f_v) / torch.clamp(n_dot_l.abs(), min=1e-6) * (
        1.0 - mat.metallic)
    ds = gtr2(n_dot_h, a)
    fh_diel = fresnel_dielectric(l_dot_h, eta_i, eta_o)
    fs_trans = lerp(cspec0, one, fh_diel)
    gs = smith_ggx(n_dot_v, a) * smith_ggx(n_dot_l, a)
    bsdf_above = fs_trans * (gs * ds)
    bsdf_part = where(n_dot_l <= 0.0, Vec3(bsdf_below, bsdf_below, bsdf_below), bsdf_above)
    bsdf_part = where(mat.transmission > 0.0, bsdf_part, zero)

    # --- reflection lobe (brdf) ---
    # backside: Hanrahan-Krueger-ish subsurface transmission
    s = Vec3(torch.sqrt(mat.color.x), torch.sqrt(mat.color.y), torch.sqrt(mat.color.z))
    fl_b = schlick_fresnel(n_dot_l.abs())
    fv_b = schlick_fresnel(n_dot_v)
    fd_b = (1.0 - 0.5 * fl_b) * (1.0 - 0.5 * fv_b)
    brdf_below = s * (INV_PI * mat.subsurface * fd_b * (1.0 - mat.metallic))
    brdf_below = where(mat.subsurface > 0.0, brdf_below, zero)

    # frontside: retro-diffuse + GGX specular + clearcoat
    fh = schlick_fresnel(l_dot_h)
    fs = lerp(cspec0, one, fh)
    fl = schlick_fresnel(n_dot_l)
    fv = schlick_fresnel(n_dot_v)
    fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * mat.roughness
    fd = lerp(1.0, fd90, fl) * lerp(1.0, fd90, fv)
    dr = gtr1(n_dot_h, lerp(0.1, 0.001, mat.clearcoat_gloss))
    fc = lerp(0.04, 1.0, fh)
    gr = smith_ggx(n_dot_l, 0.25) * smith_ggx(n_dot_v, 0.25)
    brdf_above = (
        cd_lin * (INV_PI * fd * (1.0 - mat.metallic) * (1.0 - mat.subsurface))
        + fs * (gs * ds)
        + one * (mat.clearcoat * gr * fc * dr)
    )
    brdf_part = where(n_dot_l <= 0.0, brdf_below, brdf_above)
    brdf_part = where(mat.transmission < 1.0, brdf_part, zero)
    return lerp(brdf_part, bsdf_part, mat.transmission)
