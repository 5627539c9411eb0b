"""Progressive renderer: owns the framebuffer state and runs one wavefront
launch per `render()` (port of optixpathtracer_tpu/engine/renderer.py, with
`aovs`, the AOV-guided `denoised_image`, checkpoint / resume of the
progressive state in the reference's `.npz` layout and the parallelogram
area light; demand-loaded textures are ROADMAP A.11).

Pixels are traced in 16x8 tiles, not scanlines: the cluster traversal culls
per 128-ray block, and a tile's rays form a far tighter bundle. The tile
permutation is static; image outputs are unpermuted on read.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3
from ..lights.probe import Probe
from ..ops import tonemap
from ..ops.denoise import atrous_denoise
from .wavefront import CameraParams, RenderConfig, SampleOutput, accumulate, trace_wavefront


def _render_step(cs, probe, cfg, cam, pixel_x, pixel_y, accum: Vec3, subframe: int,
                 area_light=None):
    """One progressive launch over a pixel chunk (the optixLaunch unit)."""
    out = trace_wavefront(cs, probe, cfg, cam, pixel_x, pixel_y, subframe, area_light=area_light)
    new_accum = accumulate(accum, out.color, subframe, cfg.samples_per_launch, cfg.clamp_radiance)
    frame = tonemap.pack_rgba8(tonemap.finalize(new_accum, mode=tonemap.TONEMAP_NONE, srgb=True))
    return new_accum, frame, out


def frame_stats(frames: int, frame_times: list[float]) -> dict:
    """Frame statistics over the last 64 frame times (displayStats,
    sutil.cpp:723-783): {"frames": 0} before the first frame."""
    times = frame_times[-64:]
    if not times:
        return {"frames": 0}
    mean = float(np.mean(times))
    return {"frames": frames, "last_frame_s": times[-1], "mean_frame_s": mean,
            "fps": 1.0 / max(mean, 1e-9)}


class ProgressiveState:
    """What the progressive renderers share: a change of view or of sky
    restarts the accumulation, and every frame's host time is kept for
    `stats`. Subclasses own `camera`, `probe`, `config`, `subframe_index`."""

    def __init__(self):
        self.subframe_index = 0
        self._frame_times: list[float] = []

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.subframe_index = 0  # camera motion restarts accumulation

    def set_probe(self, probe: Probe) -> None:
        self.probe = probe
        self.subframe_index = 0


class Renderer(ProgressiveState):
    """Progressive path-tracing renderer over a compiled scene; renders on
    the compiled scene's device. `area_light` (a `QuadLight` on that
    device, or None) is sampled by every launch."""

    TILE_W, TILE_H = 16, 8  # pixel-tile shape for ray-block coherence

    def __init__(self, compiled_scene: CompiledScene, probe: Probe,
                 config: RenderConfig | None = None, camera: Camera | None = None,
                 area_light=None):
        self.cs = compiled_scene
        self.device = compiled_scene.device
        self.probe = probe
        self.config = config or RenderConfig()
        self.camera = camera or Camera()
        self.area_light = area_light
        super().__init__()
        self.resize(self.config.width, self.config.height)

    def resize(self, width: int, height: int) -> None:
        """Reallocate framebuffers in 16x8-tile pixel order."""
        self.config = dataclasses.replace(self.config, width=width, height=height)
        n = width * height
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), width)
        tw, th = self.TILE_W, self.TILE_H
        tiles_x = -(-width // tw)
        tile_id = (ys // th) * tiles_x + (xs // tw)
        within = (ys % th) * tw + (xs % tw)
        perm = np.argsort(tile_id * (tw * th) + within, kind="stable")
        self._perm = perm
        self._inv_perm = np.argsort(perm, kind="stable")
        self._inv_perm_t = torch.as_tensor(self._inv_perm, device=self.device)
        self._px = torch.as_tensor(xs[perm], device=self.device)
        self._py = torch.as_tensor(ys[perm], device=self.device)
        self.accum = Vec3.zeros((n,), self.device)
        self.subframe_index = 0
        self._last: SampleOutput | None = None
        self._frame_u8 = None

    def set_camera(self, camera: Camera) -> None:
        camera.aspect_ratio = self.config.width / self.config.height
        super().set_camera(camera)

    def render(self, download: bool = True) -> np.ndarray | None:
        """One progressive launch; returns the (H, W, 4) uint8 frame (or
        None with download=False, leaving the frame on the device)."""
        t0 = time.perf_counter()
        cam = CameraParams.from_camera(self.camera, self.device)
        tiles = max(1, self.config.dispatch_tiles)
        n = self._px.shape[0]
        chunk = -(-n // tiles)
        sub = self.subframe_index
        parts = []
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            a_chunk = Vec3(*(c[s:e] for c in self.accum))
            parts.append(_render_step(self.cs, self.probe, self.config, cam,
                                      self._px[s:e], self._py[s:e], a_chunk, sub,
                                      self.area_light))
        if len(parts) == 1:
            self.accum, frame, self._last = parts[0]
        else:
            self.accum = Vec3(*(torch.cat([p[0][k] for p in parts]) for k in range(3)))
            frame = torch.cat([p[1] for p in parts])
            self._last = _merge_outputs([p[2] for p in parts])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.subframe_index += 1
        self._frame_u8 = frame
        self._frame_times.append(time.perf_counter() - t0)
        return self.download_pixels() if download else None

    def render_n(self, n: int) -> np.ndarray:
        for _ in range(n):
            out = self.render()
        return out

    @property
    def last_output(self) -> SampleOutput | None:
        return self._last

    @property
    def pixels(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(pixel_x, pixel_y) of one launch, in 16x8-tile lane order."""
        return self._px, self._py

    def image_tensor(self, v: Vec3) -> torch.Tensor:
        """(H, W, 3) image of a per-lane Vec3 on the render device, top row
        first (row 0 of the buffer is the bottom, GL convention)."""
        h, w = self.config.height, self.config.width
        return torch.stack(list(v), -1)[self._inv_perm_t].reshape(h, w, 3).flip(0)

    def _to_image(self, v: Vec3) -> np.ndarray:
        return self.image_tensor(v).cpu().numpy()

    def download_pixels(self) -> np.ndarray:
        """(H, W, 4) uint8, top row first (SampleRenderer::downloadPixels)."""
        h, w = self.config.height, self.config.width
        u8 = self._frame_u8.cpu().numpy()[self._inv_perm]
        return u8.reshape(h, w, 4)[::-1]

    def accum_image(self) -> np.ndarray:
        return self._to_image(self.accum)

    def aovs(self) -> dict[str, np.ndarray]:
        """normal / albedo / alpha / depth AOVs of the last launch (the
        denoiser's guides; depth is (H, W), 0 on a miss)."""
        if self._last is None:
            raise RuntimeError("render() first")
        h, w = self.config.height, self.config.width
        depth = self._last.depth[self._inv_perm_t].reshape(h, w).flip(0)
        return {
            "normal": self._to_image(self._last.normal),
            "albedo": self._to_image(self._last.albedo),
            "alpha": self._to_image(self._last.alpha),
            "depth": depth.cpu().numpy(),
        }

    def denoised_image(self, **kwargs) -> np.ndarray:
        """AOV-guided À-Trous denoise of the current accumulation (the
        OptixDenoiser exec() role), run on the render device; kwargs go to
        `ops.denoise.atrous_denoise` (tensors on the render device)."""
        if self._last is None:
            raise RuntimeError("render() first")
        out = atrous_denoise(self.image_tensor(self.accum), self.image_tensor(self._last.normal),
                             self.image_tensor(self._last.albedo), **kwargs)
        return out.cpu().numpy()

    def save_checkpoint(self, path: str) -> None:
        """Persist the progressive state (accumulation in canonical pixel
        order, subframe index, size, camera) in the reference's `.npz`
        layout: a checkpoint of either package loads in the other."""
        inv = self._inv_perm
        np.savez(
            path,
            accum=np.stack([c.cpu().numpy()[inv] for c in self.accum]),
            subframe_index=self.subframe_index,
            width=self.config.width,
            height=self.config.height,
            eye=self.camera.eye,
            lookat=self.camera.lookat,
            up=self.camera.up,
            fov_y=self.camera.fov_y,
        )

    def load_checkpoint(self, path: str) -> None:
        d = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        if int(d["width"]) != self.config.width or int(d["height"]) != self.config.height:
            self.resize(int(d["width"]), int(d["height"]))
        a = d["accum"][:, self._perm]  # canonical -> tile order
        self.accum = Vec3(*(torch.as_tensor(np.ascontiguousarray(c, np.float32), device=self.device)
                            for c in a))
        self.subframe_index = int(d["subframe_index"])
        self.camera = Camera(eye=d["eye"], lookat=d["lookat"], up=d["up"], fov_y=float(d["fov_y"]),
                             aspect_ratio=self.config.width / self.config.height)

    def stats(self) -> dict:
        out = frame_stats(self.subframe_index, self._frame_times)
        if out["frames"]:
            out["total_spp"] = self.subframe_index * self.config.samples_per_launch
        return out


def _merge_outputs(outs: list[SampleOutput]) -> SampleOutput:
    """Concatenate per-pixel fields of chunked launches; sum the scalars."""

    def cat(*xs):
        return torch.cat(xs)

    return SampleOutput(
        color=Vec3(*(cat(*(o.color[k] for o in outs)) for k in range(3))),
        alpha=Vec3(*(cat(*(o.alpha[k] for o in outs)) for k in range(3))),
        normal=Vec3(*(cat(*(o.normal[k] for o in outs)) for k in range(3))),
        albedo=Vec3(*(cat(*(o.albedo[k] for o in outs)) for k in range(3))),
        depth=cat(*(o.depth for o in outs)),
        rays_traced=sum(o.rays_traced for o in outs),
        bfs_overflow=sum(o.bfs_overflow for o in outs),
    )
