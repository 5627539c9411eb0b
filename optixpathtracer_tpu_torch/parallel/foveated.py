"""Multi-device foveated rendering: the fused zone wavefront sharded by lanes
(port of optixpathtracer_tpu/parallel/foveated.py).

Interleaved pixel strips are load-imbalanced under foveation: the fovea's
pixels carry 8 spp at full resolution while periphery pixels carry 1 spp at
1/4 resolution. The fused single-launch foveation (engine/foveated
`_fused_step`) already expands every zone to per-sample lanes, one lane one
path, so interleaving the concatenated lane list round-robin over the ranks
gives every rank an identical lane count and zone mix, statically. Every
rank expands the same lanes with the same RNG counters, so the estimator
equals the single-device fused mode; only the lane-to-rank assignment
differs. Each rank traces its lanes; the per-lane colours are gathered
(`all_gather`, about 22 MB per 4K frame; staged through the host under
gloo), and every rank folds and splats them into its own replica of the
accumulation. Collectives per frame: that gather, one `all_reduce` of the
ray count and one `all_gather` of the per-rank counts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3
from ..engine.foveated import (
    FoveationConfig,
    FoveationZone,
    _expand_zone_lanes,
    _fold_and_splat,
    _zone_lanes,
)
from ..engine.renderer import ProgressiveState, frame_stats
from ..engine.wavefront import CameraParams, RenderConfig, trace_wavefront
from ..lights.probe import Probe
from ..ops import tonemap
from .tiles import all_gather_rows, all_sum

Tensor = torch.Tensor


def rr(a: Tensor, fill, n_dev: int) -> Tensor:
    """Pad to a multiple of `n_dev` with `fill`, then interleave round-robin
    so the d-th of `n_dev` equal slices holds lanes l with l % n_dev == d
    (an equal zone mix per rank)."""
    n_pad = -(-a.shape[0] // n_dev) * n_dev
    if n_pad > a.shape[0]:
        a = torch.cat([a, a.new_full((n_pad - a.shape[0],), fill)])
    return a.reshape(n_pad // n_dev, n_dev).T.reshape(n_pad)


def unrr(a: Tensor, n_dev: int, n_lanes: int) -> Tensor:
    """Undo `rr`: back to concat order, the padding dropped."""
    n_pad = a.shape[0]
    return a.reshape(n_dev, n_pad // n_dev).T.reshape(n_pad)[:n_lanes]


def make_fused_foveated_step(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    zones: tuple[FoveationZone, ...],
    group=None,
) -> Callable:
    """Multi-rank fused-foveation step:
    (cam, gaze, accum, subframe) -> (new_accum, rays, rays_dev)."""
    n_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    fcfg = dataclasses.replace(cfg, samples_per_launch=1, batch_spp=False)
    # per-zone lane counts AFTER the static annulus cull (engine.foveated
    # _zone_lanes drops gaze-independent dead lanes from centered zones)
    n_lanes = sum(len(_zone_lanes(z)[0]) * z.spp for z in zones)
    m = -(-n_lanes // n_dev)  # lanes a rank traces, padding included

    def shard(a: Tensor, fill) -> Tensor:
        return rr(a, fill, n_dev)[rank * m:(rank + 1) * m]

    def step(cam: CameraParams, gaze: tuple[int, int], accum: Vec3, subframe: int):
        # the same lane expansion as the single-device fused launch
        # (engine/foveated._expand_zone_lanes): identical RNG counters, so
        # only the lane->rank assignment differs from fused single-device
        px, py, act, lanes, grids = _expand_zone_lanes(cfg, zones, gaze, subframe, cs.device)
        out = trace_wavefront(cs, probe, fcfg, cam, shard(px, 0), shard(py, 0), subframe,
                              active_mask=shard(act, False), sample_lanes=shard(lanes, 0))
        own = out.rays_traced.to(torch.int64).reshape(1)
        rays = int(all_sum(own, group)[0])
        rays_dev = all_gather_rows(own, group).cpu().numpy()
        # fold back to concat order (the cross-rank gather), then reduce and
        # splat exactly as the single-device fused step does
        gathered = all_gather_rows(torch.stack(list(out.color))[None], group).to(cs.device)
        color = Vec3(*(unrr(gathered[:, k].reshape(-1), n_dev, n_lanes) for k in range(3)))
        return _fold_and_splat(cfg, zones, grids, color, accum, subframe), rays, rays_dev

    return step


class DistributedFoveatedRenderer(ProgressiveState):
    """Gaze-contingent progressive renderer over the ranks of a process group.

    Same API and estimator as engine.foveated.FoveatedRenderer(fused=True);
    lanes are statically balanced across ranks (see module docstring).
    Every rank constructs one on its own compiled scene and calls `render`
    together; the accumulation is replicated, so `frame` and
    `accum_image` are local."""

    def __init__(
        self,
        compiled_scene: CompiledScene,
        probe: Probe,
        config: RenderConfig,
        camera: Camera,
        foveation: FoveationConfig | None = None,
        group=None,
    ):
        self.cs = compiled_scene
        self.device = compiled_scene.device
        self.probe = probe
        self.config = config
        self.camera = camera
        self.fov = foveation or FoveationConfig()
        self.zones = self.fov.zones(config.width, config.height)
        self.accum = Vec3.zeros((config.width * config.height,), self.device)
        super().__init__()
        self.gaze = (config.width // 2, config.height // 2)
        self.last_rays = 0.0
        self.last_rays_per_device: np.ndarray | None = None
        self._step = make_fused_foveated_step(compiled_scene, probe, config, self.zones, group)

    def set_gaze(self, x: int, y: int) -> None:
        self.gaze = (int(x), int(y))

    def render(self) -> np.ndarray:
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera, self.device)
        # image y (top-first) -> buffer y (bottom-first)
        gaze = (self.gaze[0], self.config.height - 1 - self.gaze[1])
        self.accum, rays, rays_dev = self._step(cam, gaze, self.accum, self.subframe_index)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.subframe_index += 1
        self.last_rays = float(rays)
        self.last_rays_per_device = rays_dev
        self._frame_times.append(time.perf_counter() - t0)
        return self.frame()

    def frame(self, exposure_stops: float = 2.0) -> np.ndarray:
        """Tone-mapped display frame (sv4: exposure 2^2 + Reinhard + sRGB) —
        same contract as engine.foveated.FoveatedRenderer.frame."""
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
