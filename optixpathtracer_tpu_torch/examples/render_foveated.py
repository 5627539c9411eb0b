"""Foveated rendering demo: gaze-contingent 3-zone path tracing (the sv4
configuration) on a few boxes; port of examples/render_foveated.py.

Run:  python -m optixpathtracer_tpu_torch.examples.render_foveated [out.png] [--cpu]
      (FRAMES=N sets the frame count, 8 by default)
"""
from __future__ import annotations

import numpy as np

from ..builder import compile_scene
from ..core.camera import Camera
from ..core.materials import make_material
from ..core.scene import HostScene
from ..engine.foveated import FoveatedRenderer, FoveationConfig
from ..engine.wavefront import RenderConfig
from ..io.image import save_png
from ..lights.probe import build_probe
from ..tools import device
from ..utils.platform import auto_tune
from . import frames_from_env, parse


def boxes_scene() -> HostScene:
    """A floor and three coloured boxes."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
    for p, c in [((-1, 0.5, 0), (0.85, 0.2, 0.2)), ((0.9, 0.7, 0.4), (0.2, 0.7, 0.3)),
                 ((0, 0.3, 1.5), (0.3, 0.4, 0.9))]:
        hs.add_box(make_material(color=c, roughness=0.5), pos=p, extent=(0.4, 0.5, 0.4))
    return hs


def sky(dev):
    s = np.full((32, 64, 3), 0.35, np.float32)
    s[4:7, 14:18] = (30.0, 28.0, 24.0)
    return build_probe(s, dev)


def render_foveated(dev, out: str, width: int = 480, height: int = 360, frames: int = 8,
                    inner: int = 50, outer: int = 120, log=print) -> FoveatedRenderer:
    """`frames` foveated frames, the gaze at the centre; writes the last
    display frame to `out`. Returns the renderer."""
    cs = compile_scene(boxes_scene(), dev)
    cfg = auto_tune(RenderConfig(width=width, height=height, max_depth=3), dev)
    cam = Camera(eye=(4, 2.5, 5), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=40,
                 aspect_ratio=width / height)
    fr = FoveatedRenderer(cs, sky(dev), cfg, cam,
                          FoveationConfig(inner_radius=inner, outer_radius=outer))
    fr.set_gaze(width // 2, height // 2)
    for i in range(frames):
        frame = fr.render()
        log(f"frame {i + 1}/{frames}  rays={fr.last_rays:.0f}")
    save_png(out, frame)
    log(f"wrote {out} {fr.stats()}")
    return fr


def main(argv=None) -> int:
    args = parse("render_foveated", "foveated.png", argv)
    render_foveated(device(args.cpu), args.out, frames=frames_from_env(),
                    log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
