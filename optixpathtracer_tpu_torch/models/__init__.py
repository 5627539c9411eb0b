"""Model presets over the engine (port of optixpathtracer_tpu/models; the
`disney_pt` and `foveated` presets — the others are ROADMAP A.10)."""
from __future__ import annotations

from ..builder import CompiledScene
from ..core.camera import Camera
from ..engine.foveated import FoveatedRenderer, FoveationConfig
from ..engine.renderer import Renderer
from ..engine.wavefront import RenderConfig
from ..lights.probe import Probe

__all__ = ["make_disney_pt_renderer", "make_foveated_renderer", "PRESETS"]


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


def make_foveated_renderer(
    cs: CompiledScene, probe: Probe, camera: Camera,
    width=3840, height=2160, max_depth=4, foveation: FoveationConfig | None = None,
    fused: bool | None = None, **overrides,
) -> FoveatedRenderer:
    """Config 5: sv4 VMV'23 — 3-zone foveation at 3840x2160, depth 4,
    radii 157/515, zone spp 1/2/8 (SimplePathtracer.cpp:20-21,135-215).
    fused=True traces all zones in one wavefront launch, False in three.
    None is the port's own rule, measured on the H100: fused at every size.
    The reference fuses only up to 1024x768, a TPU-made limit; on the card
    one launch rendered the city 2.7-2.9x faster at 640x480, 1280x720 and
    1920x1080 and 1.7x faster at 3840x2160, at about twice the peak device
    memory (1.79 GB against 0.81 GB at 4K): PERF.md §6, table "C.3 (a)".
    The traversal is "cluster" unless overridden."""
    if fused is None:
        fused = True
    overrides.setdefault("traversal", "cluster")
    cfg = RenderConfig(width=width, height=height, max_depth=max_depth, **overrides)
    return FoveatedRenderer(cs, probe, cfg, camera, foveation or FoveationConfig(), fused=fused)


PRESETS = {
    "disney_pt": make_disney_pt_renderer,
    "foveated": make_foveated_renderer,
}
