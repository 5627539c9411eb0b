"""Foveated multi-resolution rendering, the sv4 (VMV'23) engine (port of
optixpathtracer_tpu/engine/foveated.py).

Reference semantics (HelloPathtracing_sv4_vmv23): three launches per frame —
  periphery: 1/4-res grid, 1 spp, annulus r > outer_radius, progressive accum;
  ring:      1/2-res grid over [inner, outer+2], 2 spp, redrawn every frame;
  fovea:     full-res disc r <= inner+1, 8 spp, redrawn every frame;
with default radii inner=157, outer=515. Each zone is one wavefront over its
subsampled launch grid in 16x8 tile order; the annulus cull is the
wavefront's `active_mask`; the fillSize x fillSize block splat is one
indexed write into the flat framebuffer. `fused=True` traces all three
zones in one wavefront with per-lane RNG counters (`sample_lanes`), the
same streams as the three launches.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3
from ..core.rng import M32
from ..lights.probe import Probe
from ..ops import tonemap
from .renderer import ProgressiveState, frame_stats
from .wavefront import CameraParams, RenderConfig, trace_wavefront

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FoveationZone:
    """One ring of the foveation pattern (static launch geometry)."""

    name: str
    factor: int  # pixel subsampling stride (and splat block size)
    spp: int
    r_inner: float
    r_outer: float
    redraw: bool  # True: overwrite each frame; False: progressive accumulate
    grid_w: int  # launch grid dims (pixels covered = grid * factor)
    grid_h: int
    centered: bool  # offset = gaze - extent/2 (ring/fovea) vs (0,0) (periphery)


@dataclasses.dataclass(frozen=True)
class FoveationConfig:
    """The sv4 3-zone preset, parameterized (radii/spp/factors as data)."""

    inner_radius: int = 157
    outer_radius: int = 515
    periphery_factor: int = 4
    ring_factor: int = 2
    periphery_spp: int = 1
    ring_spp: int = 2
    fovea_spp: int = 8
    progressive: bool = False  # accumulate every zone progressively instead
    #   of redrawing ring/fovea each frame (converges the fovea under a
    #   static gaze)

    def zones(self, width: int, height: int) -> tuple[FoveationZone, ...]:
        ro = self.outer_radius
        ri = self.inner_radius
        redraw = not self.progressive
        ring_half = ro + 2
        fovea_half = ri + 1
        return (
            FoveationZone("periphery", self.periphery_factor, self.periphery_spp,
                          float(ro), 1e18, False,
                          width // self.periphery_factor, height // self.periphery_factor,
                          centered=False),
            FoveationZone("ring", self.ring_factor, self.ring_spp,
                          float(ri), float(ro + 2), redraw,
                          ring_half, ring_half, centered=True),
            FoveationZone("fovea", 1, self.fovea_spp,
                          0.0, float(ri + 1), redraw,
                          2 * fovea_half, 2 * fovea_half, centered=True),
        )


@functools.lru_cache(maxsize=None)
def _zone_lanes(zone: FoveationZone) -> tuple[np.ndarray, np.ndarray, bool]:
    """Static (lx, ly, statically_culled) lane enumeration of a zone grid.

    Lanes go in 16x8 tile order (the cluster cull works per 128-ray block,
    and a tile is a compact bundle). For gaze-centred zones px - gaze =
    lx*factor - half does not depend on the gaze, so the annulus test is
    static and dead lanes leave the launch; it runs in float32 exactly as
    the dynamic test does, so boundary lanes decide the same either way.
    statically_culled=True when the annulus was applied."""
    gw, gh = zone.grid_w, zone.grid_h
    n = gw * gh
    ys, xs = np.divmod(np.arange(n, dtype=np.int32), gw)
    tiles_x = -(-gw // 16)
    tile_id = (ys // 8) * tiles_x + (xs // 16)
    within = (ys % 8) * 16 + (xs % 16)
    perm = np.argsort(tile_id * 128 + within, kind="stable")
    xs, ys = xs[perm], ys[perm]
    culled = False
    if zone.centered:
        half = gw * zone.factor // 2
        dx = (xs * zone.factor - half).astype(np.float32)
        dy = (ys * zone.factor - half).astype(np.float32)
        r = np.sqrt(dx * dx + dy * dy, dtype=np.float32)
        keep = (r >= np.float32(zone.r_inner)) & (r <= np.float32(zone.r_outer))
        if keep.sum() and not keep.all():
            xs, ys, culled = xs[keep], ys[keep], True
    return xs, ys, culled


def _zone_pixels(cfg: RenderConfig, zone: FoveationZone, gaze: tuple[int, int], device):
    """Zone launch grid -> (px, py, active) int32/int32/bool on `device`,
    with the annulus cull applied; the gaze (buffer coords) moves the grid
    of centred zones (the reference's idx*factor + offset remap)."""
    lx_np, ly_np, statically_culled = _zone_lanes(zone)
    lx = torch.as_tensor(lx_np, device=device)
    ly = torch.as_tensor(ly_np, device=device)
    if zone.centered:
        half = zone.grid_w * zone.factor // 2
        off = (gaze[0] - half, gaze[1] - half)
    else:
        off = (0, 0)
    px = lx * zone.factor + off[0]
    py = ly * zone.factor + off[1]
    in_frame = (px >= 0) & (px < cfg.width) & (py >= 0) & (py < cfg.height)
    if statically_culled:
        return px, py, in_frame  # annulus already applied statically
    dx = px.to(torch.float32) - float(np.float32(gaze[0]))
    dy = py.to(torch.float32) - float(np.float32(gaze[1]))
    rng = torch.sqrt(dx * dx + dy * dy)
    return px, py, (rng >= zone.r_inner) & (rng <= zone.r_outer) & in_frame


def _splat_zone(cfg: RenderConfig, zone: FoveationZone, px: Tensor, py: Tensor, active: Tensor,
                accum: Vec3, color_sum: Vec3, subframe: int) -> Vec3:
    """Average, progressively blend (non-redraw zones), and block-splat one
    zone's per-pixel radiance sums into the flat accum buffer."""
    new_color = color_sum * (1.0 / zone.spp)
    if not zone.redraw and subframe > 0:
        # progressive accumulate against the previous value at the splat anchor
        anchor = (torch.clamp(py, 0, cfg.height - 1) * cfg.width
                  + torch.clamp(px, 0, cfg.width - 1)).to(torch.int64)
        prev = Vec3(*(c[anchor] for c in accum))
        a = float(np.float32(1.0) / (np.float32(subframe) + np.float32(1.0)))
        clamped = Vec3(*(torch.clamp(c, 0.0, cfg.clamp_radiance) for c in new_color))
        new_color = prev + (clamped - prev) * a

    # f x f block splat with frame clamp
    f = zone.factor
    fi = torch.arange(f, dtype=px.dtype, device=px.device)
    sx = torch.clamp(px[:, None, None] + fi[None, :, None], 0, cfg.width - 1)  # (N, f, 1)
    sy = torch.clamp(py[:, None, None] + fi[None, None, :], 0, cfg.height - 1)  # (N, 1, f)
    n_pix = cfg.width * cfg.height
    tgt = (sy * cfg.width + sx).reshape(-1).to(torch.int64)  # (N*f*f,)
    keep = active[:, None, None].expand(-1, f, f).reshape(-1)
    # inactive lanes write into a dummy slot one past the end: a masked
    # "write the current value" would race with real writes to that pixel
    tgt = torch.where(keep, tgt, n_pix)

    def splat(channel: Tensor, vals: Tensor) -> Tensor:
        v = vals[:, None, None].expand(-1, f, f).reshape(-1)
        padded = torch.cat([channel, channel.new_zeros(1)])
        padded[tgt] = v
        return padded[:n_pix]

    return Vec3(*(splat(c, v) for c, v in zip(accum, new_color)))


def _zone_step(cs: CompiledScene, probe: Probe, cfg: RenderConfig, zone: FoveationZone,
               cam: CameraParams, gaze: tuple[int, int], accum: Vec3, subframe: int):
    """Render one zone and splat it into the flat accum buffer; returns
    (accum, rays_traced)."""
    px, py, active = _zone_pixels(cfg, zone, gaze, accum.x.device)
    zcfg = dataclasses.replace(cfg, samples_per_launch=zone.spp)
    out = trace_wavefront(cs, probe, zcfg, cam, torch.clamp(px, 0, cfg.width - 1),
                          torch.clamp(py, 0, cfg.height - 1), subframe, active_mask=active)
    return _splat_zone(cfg, zone, px, py, active, accum, out.color, subframe), out.rays_traced


def _expand_zone_lanes(cfg: RenderConfig, zones: tuple[FoveationZone, ...],
                       gaze: tuple[int, int], subframe: int, device):
    """Expand every zone's pixel grid to per-sample lanes and concatenate.

    Returns (px, py, active, lane_counters, grids): one entry per lane, plus
    the per-zone (px, py, active) grids for the fold. Lane counters are
    subframe * zone_spp + sample, the streams of the three-launch mode."""
    pxs, pys, acts, lanes, grids = [], [], [], [], []
    for zone in zones:
        px, py, active = _zone_pixels(cfg, zone, gaze, device)
        grids.append((px, py, active))
        n = px.shape[0]
        pxs.append(px.repeat(zone.spp))
        pys.append(py.repeat(zone.spp))
        acts.append(active.repeat(zone.spp))
        s = torch.arange(zone.spp, dtype=torch.int64, device=device).repeat_interleave(n)
        lanes.append((subframe * zone.spp + s) & M32)
    return (
        torch.clamp(torch.cat(pxs), 0, cfg.width - 1),
        torch.clamp(torch.cat(pys), 0, cfg.height - 1),
        torch.cat(acts),
        torch.cat(lanes),
        grids,
    )


def _fold_and_splat(cfg: RenderConfig, zones: tuple[FoveationZone, ...], grids: list,
                    color: Vec3, accum: Vec3, subframe: int) -> Vec3:
    """Reduce each zone's lanes to per-pixel sums and splat in zone order
    (later zones overwrite earlier ones at the 2 px ring overlaps, as the
    reference's three sequential launches do)."""
    offset = 0
    for zone, (px, py, active) in zip(zones, grids):
        n = px.shape[0]
        m = n * zone.spp
        color_sum = Vec3(*(c[offset:offset + m].reshape(zone.spp, n).sum(0) for c in color))
        offset += m
        accum = _splat_zone(cfg, zone, px, py, active, accum, color_sum, subframe)
    return accum


def _fused_step(cs: CompiledScene, probe: Probe, cfg: RenderConfig,
                zones: tuple[FoveationZone, ...], cam: CameraParams, gaze: tuple[int, int],
                accum: Vec3, subframe: int):
    """All zones in ONE wavefront launch: each zone's grid expanded to its
    own spp with per-lane RNG counters, traced together, folded back zone by
    zone and splatted in zone order. Returns (accum, rays_traced)."""
    px, py, act, lanes, grids = _expand_zone_lanes(cfg, zones, gaze, subframe, accum.x.device)
    fcfg = dataclasses.replace(cfg, samples_per_launch=1, batch_spp=False)
    out = trace_wavefront(cs, probe, fcfg, cam, px, py, subframe, active_mask=act,
                          sample_lanes=lanes)
    return _fold_and_splat(cfg, zones, grids, out.color, accum, subframe), out.rays_traced


class FoveatedRenderer(ProgressiveState):
    """Three-zone gaze-contingent progressive renderer (sv4 engine); renders
    on the compiled scene's device."""

    def __init__(self, compiled_scene: CompiledScene, probe: Probe, config: RenderConfig,
                 camera: Camera, foveation: FoveationConfig | None = None, fused: bool = False):
        self.cs = compiled_scene
        self.device = compiled_scene.device
        self.probe = probe
        self.config = config
        self.camera = camera
        self.fov = foveation or FoveationConfig()
        # fused=True traces all zones in ONE wavefront launch (same RNG
        # streams and estimator as the three-launch mode)
        self.fused = fused
        self.zones = self.fov.zones(config.width, config.height)
        self.accum = Vec3.zeros((config.width * config.height,), self.device)
        super().__init__()
        self.gaze = (config.width // 2, config.height // 2)
        self.last_rays = 0.0

    def set_gaze(self, x: int, y: int) -> None:
        """Gaze in image coords (the reference uses the mouse cursor)."""
        self.gaze = (int(x), int(y))

    def render(self, download: bool = True) -> np.ndarray | None:
        """One frame of all zones; returns the tone-mapped (H, W, 4) uint8
        frame (or None with download=False, as `Renderer.render`)."""
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera, self.device)
        # image y (top-first) -> buffer y (bottom-first)
        gaze = (self.gaze[0], self.config.height - 1 - self.gaze[1])
        sub = self.subframe_index
        if self.fused:
            self.accum, rays = _fused_step(self.cs, self.probe, self.config, self.zones, cam,
                                           gaze, self.accum, sub)
        else:
            rays = 0
            for zone in self.zones:
                self.accum, r = _zone_step(self.cs, self.probe, self.config, zone, cam, gaze,
                                           self.accum, sub)
                rays = rays + r
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_rays = float(rays)
        self.subframe_index += 1
        self._frame_times.append(time.perf_counter() - t0)
        return self.frame() if download else None

    def frame(self, exposure_stops: float = 2.0) -> np.ndarray:
        """Tone-mapped display frame (sv4: exposure 2^2 + Reinhard + sRGB)."""
        disp = tonemap.finalize(self.accum, mode=tonemap.TONEMAP_REINHARD,
                                exposure_stops=exposure_stops)
        img = tonemap.pack_rgba8(disp).cpu().numpy()
        h, w = self.config.height, self.config.width
        return img.reshape(h, w, 4)[::-1]

    def accum_image(self) -> np.ndarray:
        h, w = self.config.height, self.config.width
        img = np.stack([c.cpu().numpy() for c in self.accum], -1)
        return img.reshape(h, w, 3)[::-1]

    def stats(self) -> dict:
        out = frame_stats(self.subframe_index, self._frame_times)
        if not out["frames"]:
            return out
        return {"frames": out["frames"], "fps": out["fps"], "last_rays": self.last_rays}
