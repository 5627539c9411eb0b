"""Render the bundled textured interior (scenes/loft.obj); port of
examples/render_loft.py.

The loft is a closed scene (the sky probe never leaks in), so it is lit by
its emissive ceiling panels and window via emission_all_bounces (the
reference's cornell-style closed scenes render black there, since it adds
emission only on primary hits; see RenderConfig.emission_all_bounces).
Writes OUT and OUT's `_denoised.png` twin.

Run:  python -m optixpathtracer_tpu_torch.examples.render_loft [out.png] [--cpu]
"""
from __future__ import annotations

import os

import numpy as np

from ..builder import compile_scene
from ..core.camera import Camera
from ..engine.renderer import Renderer
from ..engine.wavefront import RenderConfig
from ..io.image import save_png
from ..io.obj import load_obj
from ..lights.probe import build_probe
from ..tools import device
from ..utils.platform import auto_tune
from . import REPO, parse


def render_loft(dev, out: str, width: int = 480, height: int = 320, frames: int = 8,
                log=print) -> Renderer:
    """`frames` frames of the loft at 4 spp, depth 4; writes `out` and its
    denoised twin. Returns the renderer."""
    hs = load_obj(os.path.join(REPO, "scenes", "loft.obj"))
    cs = compile_scene(hs, dev)
    probe = build_probe(np.full((8, 16, 3), 1e-6, np.float32), dev)  # closed room
    cfg = auto_tune(
        RenderConfig(width=width, height=height, samples_per_launch=4, max_depth=4,
                     emission_all_bounces=True, use_shading_normals=True),
        dev, cs.num_triangles)
    cam = Camera(eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0),
                 fov_y=55, aspect_ratio=width / height)
    r = Renderer(cs, probe, cfg, cam)
    for i in range(frames):
        img = r.render()
        log(f"frame {i + 1}/{frames}")
    save_png(out, img)
    denoised = out.replace(".png", "_denoised.png")
    log(f"wrote {out} - denoised: {denoised}")
    save_png(denoised, np.clip(np.sqrt(np.clip(r.denoised_image(), 0, None)), 0, 1))
    return r


def main(argv=None) -> int:
    args = parse("render_loft", "loft.png", argv)
    render_loft(device(args.cpu), args.out, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
