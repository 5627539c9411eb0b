"""Multi-device rendering: interleaved pixel strips sharded over ranks (port
of optixpathtracer_tpu/parallel/tiles.py).

The reference shards the frame's pixel list over a 1-D device mesh with
`shard_map`; the port runs one process per device over `torch.distributed`
(parallel/ranks.py starts them). The layout is the reference's: the pixel
list is permuted into round-robin row strips (`TileLayout`, bit-equal), and
rank r owns the r-th contiguous slice of it, so every rank gets an equal,
spatially interleaved share. Scene, probe and (with demand textures) the
pool are replicated: each rank holds its own on its device. The render step
is embarrassingly parallel; per frame it makes one `all_reduce` of the ray
count (the reference's `psum`), one `all_gather` of the per-rank counts
and, with demand textures, one `all_reduce` of the page-usage bitmap (the
union every rank's pager then serves). `accum_image` gathers the shards.
Under gloo every collective is staged through host tensors
(`ranks.comm_device`); under NCCL they stay on the device.

The demand pool: every rank runs the same deterministic
`process_requests` on the same union, so the ranks' pools stay identical
and `pages_loaded` equals the single-device renderer's; no pool rows cross
ranks.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3
from ..engine.renderer import ProgressiveState, frame_stats
from ..engine.wavefront import CameraParams, RenderConfig, accumulate, trace_wavefront
from ..lights.probe import Probe
from .ranks import comm_device


class TileLayout(NamedTuple):
    """Round-robin row-strip assignment (StaticWorkDistribution semantics)."""

    pixel_x: np.ndarray  # (N,) int32, permuted so rank shards interleave rows
    pixel_y: np.ndarray
    inverse: np.ndarray  # (N,) scatter indices: permuted -> row-major frame

    @staticmethod
    def build(width: int, height: int, n_devices: int, strip_rows: int = 1) -> "TileLayout":
        rows = np.arange(height)
        owner = (rows // strip_rows) % n_devices
        order = np.argsort(owner, kind="stable")  # rows grouped by rank
        ys = np.repeat(order, width).astype(np.int32)
        xs = np.tile(np.arange(width, dtype=np.int32), height)
        perm = ys.astype(np.int64) * width + xs
        inverse = np.empty_like(perm)
        inverse[perm] = np.arange(perm.size)
        return TileLayout(pixel_x=xs, pixel_y=ys, inverse=inverse)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's `t` (equal shapes) along dim 0, on the
    collective's device (`comm_device`)."""
    world = dist.get_world_size(group)
    src = t.to(comm_device(t.device, group))
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts)


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of `t` (the reference's `psum`), on the collective's device."""
    src = t.to(comm_device(t.device, group)).clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src


def make_sharded_step(cs: CompiledScene, probe: Probe, cfg: RenderConfig, group=None):
    """The sharded progressive step: this rank's shard of pixels through
    `trace_wavefront` and `accumulate`. Returned fn: (cam, px, py, accum,
    subframe[, pool]) -> (new_accum, color_sum, rays, rays_dev[, usage]):
    `rays` the sum over ranks, `rays_dev` each rank's count and, with a
    demand pool, `usage` the union of the ranks' page-usage bitmaps (numpy
    bool), which each rank's pager then serves."""

    def step(cam: CameraParams, px, py, accum: Vec3, subframe: int, pool=None):
        out = trace_wavefront(cs, probe, cfg, cam, px, py, subframe, demand_pool=pool)
        new_accum = accumulate(accum, out.color, subframe, cfg.samples_per_launch, cfg.clamp_radiance)
        own = out.rays_traced.to(torch.int64).reshape(1)
        rays = int(all_sum(own, group)[0])
        rays_dev = all_gather_rows(own, group).cpu().numpy()
        if pool is None:
            return new_accum, out.color, rays, rays_dev
        usage = all_sum(out.tex_usage.to(torch.int32), group) > 0
        return new_accum, out.color, rays, rays_dev, usage.cpu().numpy()

    return step


class DistributedRenderer(ProgressiveState):
    """Progressive renderer sharded over the ranks of a process group
    (strip data parallelism). Every rank constructs one on its own compiled
    scene (its device) and calls `render` and `accum_image` together."""

    def __init__(self, compiled_scene: CompiledScene, probe: Probe, config: RenderConfig,
                 camera: Camera, demand=None, group=None):
        self.cs = compiled_scene
        self.device = compiled_scene.device
        self.probe = probe
        self.config = config
        self.camera = camera
        self.group = group
        # demand-loaded sparse textures over the ranks: each rank's pool is
        # its own replica, every shard samples it, usage bitmaps sum over
        # the ranks and each rank's pager services the same union
        self.demand = demand
        # same settle semantics as engine.renderer.Renderer: retry a launch
        # until its (union) working set is resident so fallback-shaded
        # samples never enter the progressive mean
        self.demand_settle = True
        self.demand_settle_max = 32
        self.rank = dist.get_rank(group)
        n_dev = dist.get_world_size(group)
        assert (config.width * config.height) % n_dev == 0, (
            "frame pixels must divide evenly over devices"
        )
        self.layout = TileLayout.build(config.width, config.height, n_dev)
        n_local = config.width * config.height // n_dev
        own = slice(self.rank * n_local, (self.rank + 1) * n_local)
        self._px = torch.as_tensor(self.layout.pixel_x[own], device=self.device)
        self._py = torch.as_tensor(self.layout.pixel_y[own], device=self.device)
        self.accum = Vec3.zeros((n_local,), self.device)
        super().__init__()
        self.last_rays = 0.0
        self.last_rays_per_device: np.ndarray | None = None
        self.last_launches = 0
        self.last_gather_ms = 0.0
        self._step = make_sharded_step(compiled_scene, probe, config, group)

    def render(self) -> None:
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera, self.device)
        sub = self.subframe_index
        if self.demand is not None:
            for i in range(max(2, self.demand_settle_max)):
                new_accum, _, rays, rays_dev, u = self._step(
                    cam, self._px, self._py, self.accum, sub, self.demand.pool)
                n_pending = int((u & (self.demand._page_table < 0)).sum())
                self.demand.process_requests(u)
                if n_pending == 0 or not self.demand_settle:
                    break
                if int(u.sum()) > self.demand.capacity:
                    break  # working set can never be simultaneously resident
            self.accum = new_accum
            self.last_launches = i + 1
        else:
            self.accum, _, rays, rays_dev = self._step(cam, self._px, self._py, self.accum, sub)
            self.last_launches = 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.subframe_index += 1
        self.last_rays = float(rays)
        self.last_rays_per_device = rays_dev
        self._frame_times.append(time.perf_counter() - t0)

    def accum_image(self) -> np.ndarray:
        """Gather shards and undo the strip permutation -> (H, W, 3),
        top-first; a collective: every rank calls it and gets the frame."""
        t0 = time.perf_counter()
        flat = all_gather_rows(torch.stack(list(self.accum), -1), self.group).cpu().numpy()
        self.last_gather_ms = (time.perf_counter() - t0) * 1e3
        h, w = self.config.height, self.config.width
        frame = flat[self.layout.inverse]  # permuted slots -> row-major pixels
        return frame.reshape(h, w, 3)[::-1]

    def stats(self) -> dict:
        out = frame_stats(self.subframe_index, self._frame_times)
        if out["frames"]:
            out["last_rays"] = self.last_rays
        return out
