"""Hero-wavelength spectral path tracer, the sv3 preset's mode (port of
optixpathtracer_tpu/engine/spectral.py).

Each path carries an (N, 4) spectral throughput at a hero wavelength and
three rotated companions; reflectances are evaluated through the Smits
basis (core/spectrum.py), and every path resolves to linear sRGB through the
CIE curves at its end. The structure is the wavefront engine's (probe NEE
with MIS, Disney continuation) with one twist: the Disney eval is jointly
affine in (albedo, cspec0), so three overridden evals rebuild the exact
per-wavelength BSDF:
  f(lambda) = S[f00](lambda) + (f10 - f00) * S_albedo(lambda)
            + (f01 - f00) * cspec0(lambda)
with f00 = f(albedo=0, cspec0=0), f10 = f(albedo=1, cspec0=0),
f01 = f(albedo=0, cspec0=1), cspec0(lambda) the Disney specular color
rebuilt per wavelength from the spectralised tint. No coherence sort, as in
the reference; the sweeps take `cfg.traversal`'s backend, as the RGB
engine's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..builder import CompiledScene
from ..core.math import Vec3, basis_from_vector, dot, normalize, where
from ..core.rng import M32, RngState, randf, tea
from ..core.spectrum import (
    N_HERO,
    rgb_to_spectrum,
    sample_hero_wavelengths,
    spectral_to_rgb_calibrated,
)
from ..lights.probe import Probe, dir_to_uv, probe_eval, probe_sample
from ..shade import disney
from .renderer import ProgressiveState
from .wavefront import CameraParams, RenderConfig, _any_hit2, _closest_hit2, _hit_geometry

Tensor = torch.Tensor


def _bounce(cs, probe, cfg: RenderConfig, lam: Tensor, path: dict) -> dict:
    """One spectral bounce of every live path."""
    active = ~path["done"]
    t_max = torch.where(active, cfg.t_max, 0.0)
    rec = _closest_hit2(cs, cfg, path["o"], path["d"], cfg.t_min, t_max)[0]
    hit = rec.hit & active
    n_hit, mat, albedo, _ = _hit_geometry(cs, rec, path["d"], cfg.use_shading_normals)
    p_hit = path["o"] + path["d"] * rec.t
    s_alb = rgb_to_spectrum(albedo, lam)  # (N, 4)

    # per-wavelength Disney specular color: spectralise the RGB tint (the
    # one non-affine albedo term) and rebuild cspec0(lambda)
    ones = torch.ones_like(path["eta"])
    one3 = Vec3(ones, ones, ones)
    zeros = torch.zeros_like(ones)
    zero3 = Vec3(zeros, zeros, zeros)
    cd_lum = 0.3 * albedo.x + 0.6 * albedo.y + 0.1 * albedo.z
    ctint = where(cd_lum > 0.0, albedo * (1.0 / torch.clamp(cd_lum, min=1e-8)), one3)
    s_tint = rgb_to_spectrum(ctint, lam)
    base_spec = (mat.specular * 0.08 * (1.0 - mat.metallic))[:, None]
    s_cspec = ((1.0 + (s_tint - 1.0) * mat.specular_tint[:, None]) * base_spec
               + mat.metallic[:, None] * s_alb)
    eta_o = torch.where(path["eta"] == 1.0, mat.index_of_refraction(), 1.0)
    wo = -path["d"]

    def eval_spectral(wi_dir: Vec3) -> Tensor:
        """The exact per-wavelength BSDF via the joint-affine split."""
        f00 = disney.bsdf_eval(mat, zero3, path["eta"], eta_o, n_hit, wo, wi_dir, cspec0_override=zero3)
        f10 = disney.bsdf_eval(mat, one3, path["eta"], eta_o, n_hit, wo, wi_dir, cspec0_override=zero3)
        f01 = disney.bsdf_eval(mat, zero3, path["eta"], eta_o, n_hit, wo, wi_dir, cspec0_override=one3)
        # chromatic base: the subsurface sqrt(color) backside term
        s_f00 = rgb_to_spectrum(f00, lam)
        return s_f00 + (f10.x - f00.x)[:, None] * s_alb + (f01.x - f00.x)[:, None] * s_cspec

    # ---- NEE with MIS (the sky spectralised through the Smits basis) ----
    state, wi, sky_rgb, sky_pdf = probe_sample(probe, path["state"])
    occ_tmax = torch.where(hit, cfg.t_max, 0.0)
    occluded = _any_hit2(cs, cfg, p_hit, wi, cfg.shadow_t_min, occ_tmax)[0]
    b_pdf = disney.bsdf_pdf(mat, path["eta"], eta_o, n_hit, wo, wi)
    f_l = eval_spectral(wi)
    weight = 0.5 * sky_pdf / torch.clamp(0.5 * b_pdf + 0.5 * sky_pdf, min=1e-12)
    s_sky = rgb_to_spectrum(sky_rgb, lam)
    valid = hit & ~occluded & (b_pdf > 0) & (sky_pdf > 0) & (weight > 0)
    contrib = s_sky * f_l * (weight * dot(wi, n_hit).abs() / torch.clamp(sky_pdf, min=1e-12))[:, None]
    rad = path["rad"] + torch.where(valid[:, None], path["tp"] * contrib, 0.0)
    alpha = torch.where(hit, 1.0, path["alpha"])

    # emission on primary hits
    s_emit = rgb_to_spectrum(mat.emission, lam)
    rad = rad + torch.where((hit & ~path["secondary"])[:, None], path["tp"] * s_emit, 0.0)

    # ---- Disney continuation ----
    tb, bb = basis_from_vector(n_hit)
    state, res = disney.bsdf_sample(mat, path["eta"], eta_o, tb, bb, n_hit, wo, state)
    g_l = eval_spectral(res.light)
    cos_t = dot(n_hit, res.light).abs()
    cont = hit & (res.pdf > 0.0)
    tp = torch.where(cont[:, None],
                     path["tp"] * g_l * (cos_t / torch.clamp(res.pdf, min=1e-12))[:, None], path["tp"])
    transmit = dot(res.light, n_hit) <= 0.0
    eta = torch.where(cont & transmit, eta_o, path["eta"])
    done = path["done"] | (active & ~rec.hit) | (hit & (res.pdf <= 0.0))
    return dict(o=where(cont, p_hit, path["o"]), d=where(cont, res.light, path["d"]), tp=tp,
                eta=eta, rad=rad, alpha=alpha, done=done, secondary=path["secondary"] | cont,
                state=state)


def trace_spectral(cs: CompiledScene, probe: Probe, cfg: RenderConfig, cam: CameraParams,
                   pixel_x: Tensor, pixel_y: Tensor, subframe: int) -> Vec3:
    """Render cfg.samples_per_launch spectral paths a pixel -> the linear RGB
    sum over them (divide by spp to average). Sample s of a pixel draws from
    tea(pixel, subframe * spp + s): jx, jy, then the hero wavelength."""
    dev = pixel_x.device
    n = pixel_x.shape[0]
    spp = cfg.samples_per_launch
    w = torch.tensor(float(cfg.width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(cfg.height), dtype=torch.float32, device=dev)
    pix = (pixel_y.to(torch.int64) * cfg.width + pixel_x.to(torch.int64)) & M32
    zf = torch.zeros((n,), dtype=torch.float32, device=dev)
    color = Vec3(zf, zf, zf)

    for s in range(spp):
        state = RngState.seed(tea(pix, torch.full_like(pix, (int(subframe) * spp + s) & M32)))
        state, jx = randf(state)
        state, jy = randf(state)
        state, ul = randf(state)
        lam = sample_hero_wavelengths(ul)  # (N, 4)

        dx = 2.0 * (pixel_x.to(torch.float32) + jx) / w - 1.0
        dy = 2.0 * (pixel_y.to(torch.float32) + jy) / h - 1.0
        d = normalize(cam.u * dx + cam.v * dy + cam.w * 1.0)
        o = Vec3(cam.eye.x + zf, cam.eye.y + zf, cam.eye.z + zf)
        backplate = probe_eval(probe, *dir_to_uv(d))

        path = dict(o=o, d=d, tp=torch.ones((n, N_HERO), device=dev) + zf[:, None], eta=zf + 1.0,
                    rad=torch.zeros((n, N_HERO), device=dev) + zf[:, None], alpha=zf,
                    done=zf > 1.0, secondary=zf > 1.0, state=state)
        for _ in range(cfg.max_depth + 1):
            path = _bounce(cs, probe, cfg, lam, path)

        rgb = spectral_to_rgb_calibrated(path["rad"], lam)
        # composite over the RGB backplate by coverage (reference semantics)
        a = path["alpha"]
        color = color + (backplate * (1.0 - a) + rgb)
    return color


class SpectralRenderer(ProgressiveState):
    """Progressive spectral renderer (the `Renderer`'s API shape) on the
    compiled scene's device; pixels in scanline order, as the reference."""

    def __init__(self, cs: CompiledScene, probe: Probe, config: RenderConfig, camera):
        self.cs = cs
        self.device = cs.device
        self.probe = probe
        self.config = config
        self.camera = camera
        super().__init__()
        n = config.width * config.height
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), config.width)
        self._px = torch.as_tensor(xs, device=self.device)
        self._py = torch.as_tensor(ys, device=self.device)
        self.accum = Vec3.zeros((n,), self.device)

    def render(self, download: bool = True) -> np.ndarray | None:
        """One launch of samples_per_launch spectral paths a pixel, folded
        into the running mean; returns the (H, W, 3) linear image, top row
        first (None with download=False)."""
        cam = CameraParams.from_camera(self.camera, self.device)
        out = trace_spectral(self.cs, self.probe, self.config, cam, self._px, self._py,
                             self.subframe_index)
        cur = out * (1.0 / self.config.samples_per_launch)
        a = 1.0 / (self.subframe_index + 1.0)
        self.accum = self.accum + (cur - self.accum) * a if self.subframe_index else cur
        self.subframe_index += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.accum_image() if download else None

    def image_tensor(self) -> Tensor:
        """(H, W, 3) running mean on the device, top row first."""
        h, w = self.config.height, self.config.width
        return torch.stack(list(self.accum), -1).reshape(h, w, 3).flip(0)

    def accum_image(self) -> np.ndarray:
        return self.image_tensor().cpu().numpy()
