"""Model presets over the engine (port of optixpathtracer_tpu/models; the
`disney_pt` preset only — the others are ROADMAP A.10)."""
from __future__ import annotations

from ..builder import CompiledScene
from ..core.camera import Camera
from ..engine.renderer import Renderer
from ..engine.wavefront import RenderConfig
from ..lights.probe import Probe

__all__ = ["make_disney_pt_renderer"]


def make_disney_pt_renderer(
    cs: CompiledScene, probe: Probe, camera: Camera,
    width=1200, height=1024, spp=32, max_depth=8, **overrides,
) -> Renderer:
    """Config 3: the original pathtracer — spp 32 (main.cpp:134), depth 8
    (deviceProgram.cu:429), 1200x1024 framebuffer (main.cpp:214). Renders on
    the compiled scene's device; the traversal is "cluster" unless
    overridden (the reference's auto_tune platform switch does not apply)."""
    overrides.setdefault("traversal", "cluster")
    cfg = RenderConfig(width=width, height=height, samples_per_launch=spp,
                       max_depth=max_depth, **overrides)
    return Renderer(cs, probe, cfg, camera)
