"""Config 2 — 'whitted spheres': recursive reflect/refract + shadow rays
(port of optixpathtracer_tpu/models/whitted.py).

Preset scene in the spirit of the classic OptiX whitted sample the reference
vendors (cuda/whitted.cu + cuda/sphere.cu): glass and metal spheres over a
floor box, point lights, constant-color miss. The renderer builds its own
scene on `device` ("cuda" unless told otherwise); it never falls back to the
CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..builder import compile_scene
from ..core.camera import Camera
from ..core.materials import make_material
from ..core.math import Vec3
from ..core.scene import HostScene
from ..engine.wavefront import CameraParams
from ..engine.whitted import WhittedConfig, light_kinds, render_whitted
from ..lights.lights import build_lights, make_ambient_light, make_point_light
from ..ops.spheres import build_spheres
from ..ops.tonemap import TONEMAP_NONE, finalize

# rays at the deepest level of one launch (2^max_depth x its pixels): the
# launch is split into pixel chunks above this. On an NVIDIA H100 80GB HBM3
# (700 W) the preset's 768x576 at depth 3 (3.54M rays at level 3) in one
# launch peaked at 2.56-2.66 GB of device memory (chip_smoke.py
# `whitted_slice`, PERF.md §6), so 8.4M rays (~6 GB) stay one launch. The
# reference's 1M was set by a TPU's 16 GB.
MAX_DEEPEST_RAYS = 1 << 23


def default_scene(device):
    """Spheres + floor + lights (whitted-sample look) on `device`."""
    materials = [
        make_material(color=(0.95, 0.95, 0.95), transmission=1.0, eta=1.5, roughness=0.05),
        make_material(color=(0.9, 0.75, 0.3), metallic=1.0, roughness=0.1),
        make_material(color=(0.25, 0.45, 0.9), metallic=0.0, roughness=0.4),
    ]
    spheres = [
        ((0.0, 1.2, 0.0), 1.2, 0),   # glass
        ((-2.4, 0.9, -1.0), 0.9, 1),  # gold
        ((2.2, 0.7, -0.5), 0.7, 2),   # blue plastic
    ]
    ss = build_spheres(spheres, materials, device)

    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75), roughness=0.9),
               pos=(0, -0.15, 0), extent=(12, 0.15, 12))
    cs = compile_scene(hs, device)

    lights = build_lights([
        make_point_light((6.0, 8.0, 4.0), (1.0, 1.0, 0.95), intensity=120.0),
        make_point_light((-7.0, 6.0, -2.0), (0.6, 0.7, 1.0), intensity=60.0),
        make_ambient_light((1.0, 1.0, 1.0), 0.12),
    ], device)
    return ss, cs, lights


def launch_tiles(n: int, max_depth: int, dispatch_tiles: int | None = None) -> int:
    """Pixel chunks of one launch: the given count, or enough that the
    deepest level holds at most MAX_DEEPEST_RAYS rays; raised to the next
    divisor of n (equal chunks). Raises ValueError for more chunks than
    pixels, where the reference's search never ends (models/whitted.py:67)."""
    if dispatch_tiles is None:
        dispatch_tiles = max(1, -(-n * (2 ** max_depth) // MAX_DEEPEST_RAYS))
    if not 1 <= dispatch_tiles <= n:
        raise ValueError(f"dispatch_tiles={dispatch_tiles}: must be between 1 and the {n} pixels")
    while n % dispatch_tiles:
        dispatch_tiles += 1
    return dispatch_tiles


class WhittedRenderer:
    """Progressive whitted renderer over spheres, an optional triangle scene
    and optional curves, on the device of the scene it is given."""

    def __init__(self, ss, cs, lights, cfg: WhittedConfig, camera: Camera, curves=None,
                 dispatch_tiles: int | None = None):
        self.ss, self.cs, self.lights = ss, cs, lights
        self.curves = curves
        self.cfg = cfg
        self.camera = camera
        self.device = lights.kind.device
        n = cfg.width * cfg.height
        self.dispatch_tiles = launch_tiles(n, cfg.max_depth, dispatch_tiles)
        chunk = n // self.dispatch_tiles
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), cfg.width)
        self._px = [torch.as_tensor(xs[i * chunk:(i + 1) * chunk], device=self.device)
                    for i in range(self.dispatch_tiles)]
        self._py = [torch.as_tensor(ys[i * chunk:(i + 1) * chunk], device=self.device)
                    for i in range(self.dispatch_tiles)]
        self.accum = Vec3.zeros((n,), self.device)
        self.subframe_index = 0
        self.frame: torch.Tensor | None = None  # (H, W, 3) display image, on the device
        self._kinds = light_kinds(lights)

    def render(self, download: bool = True) -> np.ndarray | None:
        """Progressive accumulation like whitted.cu raygen (:91-102); returns
        the (H, W, 3) sRGB image, top row first (None with download=False)."""
        cam = CameraParams.from_camera(self.camera, self.device)
        sub = self.subframe_index
        parts = [render_whitted(self.ss, self.cs, self.lights, self.cfg, cam, px, py, sub,
                                kinds=self._kinds, curves=self.curves)
                 for px, py in zip(self._px, self._py)]
        out = Vec3(*(torch.cat([p[k] for p in parts]) for k in range(3)))
        a = 1.0 / (sub + 1.0)
        self.accum = out if sub == 0 else self.accum + (out - self.accum) * a
        self.subframe_index += 1
        disp = finalize(self.accum, mode=TONEMAP_NONE, srgb=True)
        h, w = self.cfg.height, self.cfg.width
        self.frame = torch.stack(list(disp), -1).reshape(h, w, 3).flip(0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.frame.cpu().numpy() if download else None


def _require(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the whitted preset renders on the card (device='cuda'), and no CUDA "
                           "device is available; pass device='cpu' to render on the CPU")
    return device


def make_renderer(width=768, height=576, max_depth=3, device="cuda") -> WhittedRenderer:
    """The whitted preset at 768x576, depth 3 (BASELINE.json config 2) on
    `device`."""
    device = _require(device)
    ss, cs, lights = default_scene(device)
    cfg = WhittedConfig(width=width, height=height, max_depth=max_depth)
    cam = Camera(eye=(0.0, 3.2, 9.0), lookat=(0.0, 1.0, 0.0), up=(0, 1, 0),
                 fov_y=40, aspect_ratio=width / height)
    return WhittedRenderer(ss, cs, lights, cfg, cam)
