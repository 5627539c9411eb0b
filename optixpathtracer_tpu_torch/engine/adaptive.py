"""Variance-guided adaptive sampling renderer (port of
optixpathtracer_tpu/engine/adaptive.py).

Samples go where the estimator's own measured variance says they buy the
most error reduction. It reuses the fused-foveation lane machinery
(`trace_wavefront`'s `sample_lanes`: per-lane RNG counters, one sample per
lane) with the "zones" chosen each round by per-tile error:

  * the frame is covered by 16x8 pixel tiles, the cluster backend's
    128-ray cull block, so refined lanes stay block-coherent;
  * each refinement round selects a fixed number K of tiles by per-tile
    error (a stable descending sort: ties go to the lower tile id, as
    `jax.lax.top_k` breaks them) and traces K * 128 * spp lanes;
  * per-pixel sample counts live in a padded count buffer; the image is
    sum / count, and each pixel's RNG counter continues its stream where it
    left off (sample i of a pixel draws the same tea stream whether warm-up,
    refinement or the uniform renderer traced it).

Radiance is clamped per sample at cfg.clamp_radiance: a launch carries one
sample per lane, so the uniform path's per-launch-mean clamp has no analog.
The count buffer is int64 (uint32 in the reference); every slot of a launch
is unique, so the scatter-adds are deterministic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3, luminance
from ..core.rng import M32
from ..lights.probe import Probe
from ..ops.denoise import atrous_denoise
from .wavefront import CameraParams, RenderConfig, trace_wavefront

Tensor = torch.Tensor

TILE_W, TILE_H = 16, 8
TILE_N = TILE_W * TILE_H  # == the cluster backend's 128-ray cull block


def _tile_layout(width: int, height: int):
    """Padded tile layout: every tile holds exactly TILE_N lane slots.

    Returns (tiles_x, tiles_y, px, py, valid) with px/py/valid numpy arrays
    of shape (tiles_x * tiles_y * TILE_N,): slot t*128+i is lane i (row-major
    within the tile) of tile t. Edge tiles carry out-of-frame slots that
    launches mask off."""
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    t = np.arange(tiles_x * tiles_y, dtype=np.int32)
    tx, ty = t % tiles_x, t // tiles_x
    i = np.arange(TILE_N, dtype=np.int32)
    px = tx[:, None] * TILE_W + (i % TILE_W)[None, :]
    py = ty[:, None] * TILE_H + (i // TILE_W)[None, :]
    valid = (px < width) & (py < height)
    return tiles_x, tiles_y, px.reshape(-1), py.reshape(-1), valid.reshape(-1)


def _adaptive_launch(cs: CompiledScene, probe: Probe, cfg: RenderConfig, cam: CameraParams,
                     sel: Tensor, px_all: Tensor, py_all: Tensor, valid_all: Tensor,
                     col_sum: Vec3, lum_sum: Tensor, lum2_sum: Tensor, count: Tensor,
                     nrm_sum: Vec3, alb_sum: Vec3, dep_sum: Tensor, spp: int, area_light=None):
    """Trace spp new samples for every pixel of the K selected tiles and fold
    them into the running sums. One launch of K * TILE_N * spp lanes.
    Returns the new (col_sum, lum_sum, lum2_sum, count, nrm_sum, alb_sum,
    dep_sum, rays_traced)."""
    dev = px_all.device
    k = sel.shape[0]
    slot = (sel.to(torch.int64)[:, None] * TILE_N
            + torch.arange(TILE_N, dtype=torch.int64, device=dev)[None, :]).reshape(-1)
    px, py, valid = px_all[slot], py_all[slot], valid_all[slot]
    m = k * TILE_N
    valid_s = valid.repeat(spp)
    # sample j of this launch is the pixel's overall sample count + j: the
    # same tea stream the uniform renderer uses for that sample index
    lanes = (count[slot].repeat(spp)
             + torch.arange(spp, dtype=torch.int64, device=dev).repeat_interleave(m)) & M32
    fcfg = dataclasses.replace(cfg, samples_per_launch=1, batch_spp=False)
    out = trace_wavefront(cs, probe, fcfg, cam, px.repeat(spp), py.repeat(spp), 0,
                          active_mask=valid_s, sample_lanes=lanes, area_light=area_light)

    # per-sample clamp; masked lanes (the bare backplate) contribute zero
    vf = valid_s.to(torch.float32)
    c = Vec3(*(torch.clamp(ch, 0.0, cfg.clamp_radiance) * vf for ch in out.color))
    lum = luminance(c)

    def add(acc: Tensor, per_lane: Tensor) -> Tensor:
        return acc.index_add(0, slot, per_lane.reshape(spp, m).sum(0))

    return (
        Vec3(*(add(a, ch) for a, ch in zip(col_sum, c))),
        add(lum_sum, lum),
        add(lum2_sum, lum * lum),
        count.index_add(0, slot, spp * valid.to(torch.int64)),
        # first-bounce AOVs (per lane at spp 1): the denoiser's guides
        Vec3(*(add(a, ch * vf) for a, ch in zip(nrm_sum, out.normal))),
        Vec3(*(add(a, ch * vf) for a, ch in zip(alb_sum, out.albedo))),
        add(dep_sum, out.depth * vf),
        out.rays_traced,
    )


def _tile_errors(lum_sum: Tensor, lum2_sum: Tensor, count: Tensor, n_tiles: int) -> Tensor:
    """Per-tile refinement score: summed relative variance of each pixel's
    mean, variance-of-mean / (mean + eps)^2 (dark pixels need absolutely
    less variance for the same relative error); padded slots score zero."""
    n = torch.clamp(count.to(torch.float32), min=1.0)
    mean = lum_sum / n
    var = torch.clamp(lum2_sum / n - mean * mean, min=0.0)
    err = var / n / (mean + 1e-2) ** 2
    err = torch.where(count > 0, err, 0.0)
    return err.reshape(n_tiles, TILE_N).sum(dim=1)


def _top_tiles(err: Tensor, k: int) -> Tensor:
    """Indices of the k largest per-tile errors, largest first and ties to
    the lower tile id (what `jax.lax.top_k` returns; `torch.topk` promises
    no order among ties, and sky and padded tiles tie at 0)."""
    return torch.sort(err, descending=True, stable=True).indices[:k]


class AdaptiveRenderer:
    """Progressive renderer that concentrates samples on high-variance
    tiles; renders on the compiled scene's device.

    render() traces one round: the first call is a uniform warm-up pass
    (`warmup_spp` samples for every pixel, which seeds the variance
    estimates); every later call refines the top `refine_fraction` of tiles
    by measured error with `refine_spp` fresh samples each. accum_image() is
    the running per-pixel mean at any point."""

    def __init__(self, compiled_scene: CompiledScene, probe: Probe,
                 config: RenderConfig | None = None, camera: Camera | None = None,
                 area_light=None, warmup_spp: int = 2, refine_spp: int = 4,
                 refine_fraction: float = 0.25):
        self.cs = compiled_scene
        self.device = compiled_scene.device
        self.probe = probe
        self.config = config or RenderConfig()
        self.camera = camera or Camera()
        self.area_light = area_light
        self.warmup_spp = int(warmup_spp)
        self.refine_spp = int(refine_spp)
        w, h = self.config.width, self.config.height
        self.tiles_x, self.tiles_y, px, py, valid = _tile_layout(w, h)
        self.n_tiles = self.tiles_x * self.tiles_y
        self.refine_tiles = max(1, min(self.n_tiles, int(round(self.n_tiles * refine_fraction))))
        dev = self.device
        self._px = torch.as_tensor(px, device=dev)
        self._py = torch.as_tensor(py, device=dev)
        self._valid = torch.as_tensor(valid, device=dev)
        self._valid_np = valid
        # canonical pixel (bottom row first) of each in-frame slot
        self._yx = torch.as_tensor((py * w + px)[valid].astype(np.int64), device=dev)
        p = px.shape[0]
        self.col_sum = Vec3.zeros((p,), dev)
        self.lum_sum = torch.zeros((p,), dtype=torch.float32, device=dev)
        self.lum2_sum = torch.zeros((p,), dtype=torch.float32, device=dev)
        self.count = torch.zeros((p,), dtype=torch.int64, device=dev)
        self.nrm_sum = Vec3.zeros((p,), dev)
        self.alb_sum = Vec3.zeros((p,), dev)
        self.dep_sum = torch.zeros((p,), dtype=torch.float32, device=dev)
        self.rounds = 0
        self.rays_traced = 0.0

    # -- rendering ---------------------------------------------------------
    def render(self) -> None:
        """One adaptive round (the warm-up on the first call)."""
        cam = CameraParams.from_camera(self.camera, self.device)
        if self.rounds == 0:
            sel = torch.arange(self.n_tiles, dtype=torch.int64, device=self.device)
            spp = self.warmup_spp
        else:
            err = _tile_errors(self.lum_sum, self.lum2_sum, self.count, self.n_tiles)
            sel = _top_tiles(err, self.refine_tiles)
            spp = self.refine_spp
        (self.col_sum, self.lum_sum, self.lum2_sum, self.count, self.nrm_sum, self.alb_sum,
         self.dep_sum, rays) = _adaptive_launch(
            self.cs, self.probe, self.config, cam, sel, self._px, self._py, self._valid,
            self.col_sum, self.lum_sum, self.lum2_sum, self.count, self.nrm_sum, self.alb_sum,
            self.dep_sum, spp, self.area_light)
        self.rays_traced += float(rays)
        self.rounds += 1

    def render_n(self, n: int) -> np.ndarray:
        for _ in range(n):
            self.render()
        return self.accum_image()

    # -- outputs -----------------------------------------------------------
    def _frame(self, per_slot: Tensor) -> Tensor:
        """(H, W, ...) image of per-slot values on the render device, top
        row first; out-of-frame slots dropped."""
        w, h = self.config.width, self.config.height
        img = per_slot.new_zeros((h * w,) + per_slot.shape[1:])
        img[self._yx] = per_slot[self._valid]
        return img.reshape((h, w) + per_slot.shape[1:]).flip(0)

    def _n(self) -> Tensor:
        return torch.clamp(self.count.to(torch.float32), min=1.0)

    def mean_tensor(self, v: Vec3) -> Tensor:
        """(H, W, 3) per-pixel sum / count on the render device, top row first."""
        return self._frame(torch.stack(list(v), -1) / self._n()[:, None])

    def variance_tensor(self) -> Tensor:
        """(H, W) variance of the per-pixel mean, Var[samples] / count, on
        the render device (the denoiser's noise guide)."""
        n = self._n()
        m = self.lum_sum / n
        return self._frame(torch.clamp(self.lum2_sum / n - m * m, min=0.0) / n)

    def accum_image(self) -> np.ndarray:
        """(H, W, 3) running mean, top row first (image convention)."""
        return self.mean_tensor(self.col_sum).cpu().numpy()

    def aovs(self) -> dict[str, np.ndarray]:
        """Running-mean normal / albedo / depth AOVs (the denoiser's guides)."""
        return {
            "normal": self.mean_tensor(self.nrm_sum).cpu().numpy(),
            "albedo": self.mean_tensor(self.alb_sum).cpu().numpy(),
            "depth": self._frame(self.dep_sum / self._n()).cpu().numpy(),
        }

    def variance_image(self) -> np.ndarray:
        return self.variance_tensor().cpu().numpy()

    def denoised_tensor(self, **kwargs) -> Tensor:
        """AOV-guided À-Trous denoise of the adaptive running mean, (H, W, 3)
        on the render device. Defaults are the reference's measured best on
        the bench scene: variance-scaled heavy color smoothing and albedo
        demodulation (the depth guide stays opt-in)."""
        kwargs.setdefault("variance", self.variance_tensor())
        kwargs.setdefault("sigma_color", 4.0)
        kwargs.setdefault("sigma_albedo", 1.0)
        kwargs.setdefault("var_boost", 256.0)
        kwargs.setdefault("demodulate", True)
        return atrous_denoise(self.mean_tensor(self.col_sum), self.mean_tensor(self.nrm_sum),
                              self.mean_tensor(self.alb_sum), **kwargs)

    def denoised_image(self, **kwargs) -> np.ndarray:
        return self.denoised_tensor(**kwargs).cpu().numpy()

    def sample_map(self) -> np.ndarray:
        """(H, W) per-pixel sample counts: the adaptive effort map."""
        return self._frame(self.count).cpu().numpy()

    def error_map(self) -> np.ndarray:
        """(tiles_y, tiles_x) current per-tile refinement scores."""
        err = _tile_errors(self.lum_sum, self.lum2_sum, self.count, self.n_tiles)
        return err.reshape(self.tiles_y, self.tiles_x).flip(0).cpu().numpy()

    def stats(self) -> dict:
        counts = self.count.cpu().numpy()[self._valid_np]
        return {
            "rounds": self.rounds,
            "rays_traced": self.rays_traced,
            "total_samples": int(counts.sum()),
            "spp_min": int(counts.min()) if counts.size else 0,
            "spp_max": int(counts.max()) if counts.size else 0,
            "refine_tiles": self.refine_tiles,
            "n_tiles": self.n_tiles,
        }
