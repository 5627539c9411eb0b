"""Config 1 — '04HelloRaytracing': primary visibility + one hard shadow ray
(port of optixpathtracer_tpu/models/hello_raytracing.py).

Reference: 04HelloRaytracing/deviceProgram.cu — raygen shoots one centered ray
per pixel (:195-229), closest hit interpolates the shading normal (geometric
fallback, :83-103), modulates by the diffuse texture (:109-117), traces ONE
shadow ray toward a fixed light point (:126-150), and shades
(.1 + (.2 + .8*lightVisibility) * cosDN) * diffuseColor (:156-161); misses
are black (:167-170); output packs 0xAABBGGRR (:231-242).

The shadow ray is unnormalised (origin to light, t in (0, 1)): on the city
its length is about 2400, and the cluster walk's slab tests see it as is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..builder import CompiledScene
from ..core.camera import Camera
from ..core.math import Vec3, cross, dot, faceforward, normalize, where
from ..engine.wavefront import CameraParams
from ..ops.dispatch import trace_closest, trace_occluded

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HelloConfig:
    width: int = 1200
    height: int = 800
    light_pos: tuple = (-907.108, 2205.875, -400.0267)  # deviceProgram.cu:126


def camera_rays(cfg: HelloConfig, cam: CameraParams, pixel_x: Tensor, pixel_y: Tensor):
    """(o, d): one ray through each pixel's center, screen in [0,1]^2
    (deviceProgram.cu:210-216)."""
    dev = pixel_x.device
    # divide by device scalars: CUDA takes `x / python_float` as a product
    # with the reciprocal, one ulp from the CPU's quotient
    w = torch.tensor(float(cfg.width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(cfg.height), dtype=torch.float32, device=dev)
    sx = (pixel_x.to(torch.float32) + 0.5) / w
    sy = (pixel_y.to(torch.float32) + 0.5) / h
    d = normalize(cam.u * ((sx - 0.5) * 2.0) + cam.v * ((sy - 0.5) * 2.0) + cam.w * 1.0)
    zf = d.x * 0.0
    return Vec3(cam.eye.x + zf, cam.eye.y + zf, cam.eye.z + zf), d


def render_hello(cs: CompiledScene, cfg: HelloConfig, cam: CameraParams,
                 pixel_x: Tensor, pixel_y: Tensor) -> Vec3:
    """Flat-shaded primary-visibility pass; returns (N,) linear color."""
    o, d = camera_rays(cfg, cam, pixel_x, pixel_y)
    rec = trace_closest(cs, o, d, 0.0, 1e20)
    tri = torch.clamp(rec.tri, min=0).to(torch.int64)
    scene = cs.scene

    # interpolated shading normal with geometric fallback + faceforward
    w0 = 1.0 - rec.u - rec.v
    v0, v1, v2, n0, n1, n2, uv6, mat_id, has = scene.take_shade(tri)
    ng = normalize(cross(v1 - v0, v2 - v0))
    ng = faceforward(ng, -d, ng)
    ns = n0 * w0 + n1 * rec.u + n2 * rec.v
    ns = normalize(where(has, ns, ng))
    # flip the shading normal into the geometric hemisphere (:101-103)
    flip = dot(ng, ns) < 0.0
    ns = where(flip, ns - ng * (2.0 * dot(ng, ns)), ns)

    mat = scene.materials.take(mat_id.to(torch.int64))
    uv0u, uv0v, uv1u, uv1v, uv2u, uv2v = uv6
    tu = uv0u * w0 + uv1u * rec.u + uv2u * rec.v
    tv = uv0v * w0 + uv1v * rec.u + uv2v * rec.v
    tex = scene.textures.sample_bilinear(mat.texture_id, tu, tv)  # white where texture_id < 0
    diffuse = where(mat.texture_id >= 0, mat.color * tex, mat.color)

    p = o + d * rec.t
    lx, ly, lz = cfg.light_pos
    ldir = Vec3(lx - p.x, ly - p.y, lz - p.z)  # unnormalised: t in (0, 1)
    t_max = torch.where(rec.hit, 1.0 - 1e-3, 0.0)
    occ = trace_occluded(cs, p + ng * 1e-3, ldir, 1e-3, t_max)
    light_vis = torch.where(occ, 0.0, 1.0)

    cos_dn = 0.1 + 0.8 * dot(d, ns).abs()
    color = diffuse * (0.1 + (0.2 + 0.8 * light_vis) * cos_dn)
    return where(rec.hit, color, Vec3.zeros(d.x.shape, d.x.device))


class HelloRenderer:
    """Single-shot renderer for the 04 config (no accumulation), on the
    compiled scene's device. Pixels are traced in scanline order, as the
    reference does."""

    def __init__(self, cs: CompiledScene, cfg: HelloConfig, camera: Camera):
        self.cs = cs
        self.cfg = cfg
        self.camera = camera
        self.device = cs.device
        n = cfg.width * cfg.height
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), cfg.width)
        self._px = torch.as_tensor(xs, device=self.device)
        self._py = torch.as_tensor(ys, device=self.device)
        self.frame: Tensor | None = None  # (H, W, 3) of the last render, on the device

    def render(self, download: bool = True) -> np.ndarray | None:
        """(H, W, 3) float in [0,1], top row first (None with
        download=False: the frame stays on the device as `frame`)."""
        cam = CameraParams.from_camera(self.camera, self.device)
        out = render_hello(self.cs, self.cfg, cam, self._px, self._py)
        img = torch.stack(list(out), -1).reshape(self.cfg.height, self.cfg.width, 3).flip(0)
        self.frame = torch.clamp(img, 0.0, 1.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.frame.cpu().numpy() if download else None

    def render_rgba8(self) -> np.ndarray:
        """0xAABBGGRR-style 8-bit output (deviceProgram.cu:231-242)."""
        img = self.render()
        rgb = (img * 255.99).astype(np.uint8)
        a = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
        return np.concatenate([rgb, a], axis=-1)
