"""Cornell box with area-light NEE, the classic sanity render; port of
examples/render_cornell.py (scenes/cornell_box.obj under a `QuadLight`,
Reinhard tone map at +1 stop).

Run:  python -m optixpathtracer_tpu_torch.examples.render_cornell [out.png] [--cpu]
      (FRAMES=N sets the frame count, 8 by default)
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..builder import compile_scene
from ..core.camera import Camera
from ..core.math import Vec3
from ..engine.renderer import Renderer
from ..engine.wavefront import RenderConfig
from ..io.image import save_png
from ..io.obj import load_obj
from ..lights.lights import QuadLight
from ..lights.probe import build_probe
from ..ops import tonemap as tm
from ..tools import device
from ..utils.platform import auto_tune
from . import REPO, frames_from_env, parse


def render_cornell(dev, out: str, width: int = 256, height: int = 256, spp: int = 8,
                   frames: int = 8, log=print) -> Renderer:
    """`frames` frames of the cornell box at `spp`, depth 5, under its quad
    light; writes the tone-mapped accumulation to `out`. Returns the renderer."""
    hs = load_obj(os.path.join(REPO, "scenes", "cornell_box.obj"))
    cs = compile_scene(hs, dev)
    probe = build_probe(np.full((8, 16, 3), 1e-5, np.float32), dev)  # dark env
    light = QuadLight.make(corner=(-0.3, 1.985, -0.3), v1=(0.6, 0, 0), v2=(0, 0, 0.6),
                           emission=(15.0, 15.0, 15.0), device=dev)
    cfg = auto_tune(
        RenderConfig(width=width, height=height, samples_per_launch=spp, max_depth=5,
                     emission_all_bounces=True),
        dev, cs.num_triangles)
    cam = Camera(eye=(0, 1.0, 3.6), lookat=(0, 1.0, 0), up=(0, 1, 0), fov_y=40,
                 aspect_ratio=width / height)
    r = Renderer(cs, probe, cfg, cam, area_light=light)
    for i in range(frames):
        r.render()
        log(f"frame {i + 1}/{frames}  {r.stats()['total_spp']} spp")
    acc = r.accum_image()
    disp = tm.finalize(Vec3(*(torch.as_tensor(np.ascontiguousarray(acc[..., k])) for k in range(3))),
                       mode=tm.TONEMAP_REINHARD, exposure_stops=1.0)
    save_png(out, np.stack([c.numpy() for c in disp], -1))
    log(f"wrote {out}")
    return r


def main(argv=None) -> int:
    args = parse("render_cornell", "cornell.png", argv)
    render_cornell(device(args.cpu), args.out, frames=frames_from_env(),
                   log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
