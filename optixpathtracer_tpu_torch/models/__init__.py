"""Model presets over the engine (port of optixpathtracer_tpu/models): the
five BASELINE.json configurations, each a preset over one engine:

  1. 04HelloRaytracing         -> hello_raytracing (primary visibility + shadow)
  2. cuda/whitted.cu spheres   -> whitted (recursive reflect/refract, point lights)
  3. HelloPathtracing_original -> disney_pt (Disney BSDF PT + probe NEE + post)
  4. HelloPathtracing_sv3      -> spectral (hero-wavelength + probe sampling)
  5. HelloPathtracing_sv4      -> foveated (3-zone gaze-contingent PT)

plus the adaptive renderer over disney_pt. Every RenderConfig field passes
through `**overrides`, the engine options (`nee_rr`, `fused_shadows`,
`env_via_bsdf`, the sampling strategy, ...) included. Unless `traversal` is
overridden, `utils/platform.auto_tune` picks it by the scene's device, as
the reference does by platform: the cluster walk on a CUDA device, the
lockstep walk on a CPU; explicit overrides always win. The presets render
on the compiled scene's device; whitted, which builds its own scene, on
`device` ("cuda" by default)."""
from __future__ import annotations

import dataclasses

from ..builder import CompiledScene
from ..core.camera import Camera
from ..engine.adaptive import AdaptiveRenderer
from ..engine.foveated import FoveatedRenderer, FoveationConfig
from ..engine.renderer import Renderer
from ..engine.spectral import SpectralRenderer
from ..engine.wavefront import RenderConfig
from ..lights.probe import Probe
from ..utils.platform import auto_tune
from .hello_raytracing import HelloConfig, HelloRenderer
from .whitted import make_renderer as make_whitted_renderer

__all__ = ["make_hello_renderer", "make_whitted_renderer", "make_disney_pt_renderer",
           "make_spectral_renderer", "make_foveated_renderer", "make_adaptive_renderer",
           "PRESETS"]


def _tuned(cs: CompiledScene, cfg: RenderConfig, overrides: dict) -> RenderConfig:
    """`auto_tune` for the scene's device unless the caller chose the
    traversal; explicit overrides win over its choices."""
    if "traversal" in overrides:
        return cfg
    return dataclasses.replace(auto_tune(cfg, cs.device, cs.num_triangles), **overrides)


def make_hello_renderer(cs: CompiledScene, camera: Camera, width=1200, height=800) -> HelloRenderer:
    """Config 1: flat-shaded primary visibility at 1200x800 (BASELINE.json)."""
    return HelloRenderer(cs, HelloConfig(width=width, height=height), camera)


def make_disney_pt_renderer(
    cs: CompiledScene, probe: Probe, camera: Camera,
    width=1200, height=1024, spp=32, max_depth=8, demand=None, **overrides,
) -> Renderer:
    """Config 3: the original pathtracer — spp 32 (main.cpp:134), depth 8
    (deviceProgram.cu:429), 1200x1024 framebuffer (main.cpp:214).

    demand: optional io.demand.DemandTextureManager, its pool on the
    scene's device: textures shade from the sparse demand-loaded pool
    (pages stream in between launches)."""
    cfg = _tuned(cs, RenderConfig(width=width, height=height, samples_per_launch=spp,
                                  max_depth=max_depth, **overrides), overrides)
    return Renderer(cs, probe, cfg, camera, demand=demand)


def make_spectral_renderer(
    cs: CompiledScene, probe: Probe, camera: Camera,
    width=1200, height=1024, spp=4, max_depth=4, **overrides,
) -> SpectralRenderer:
    """Config 4: sv3 — spectral rendering with probe light sampling, depth 4."""
    cfg = _tuned(cs, RenderConfig(width=width, height=height, samples_per_launch=spp,
                                  max_depth=max_depth, **overrides), overrides)
    return SpectralRenderer(cs, probe, cfg, camera)


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
    memory (1.79 GB against 0.81 GB at 4K): PERF.md §6, table "C.3 (a)"."""
    if fused is None:
        fused = True
    cfg = _tuned(cs, RenderConfig(width=width, height=height, max_depth=max_depth, **overrides),
                 overrides)
    return FoveatedRenderer(cs, probe, cfg, camera, foveation or FoveationConfig(), fused=fused)


def make_adaptive_renderer(
    cs: CompiledScene, probe: Probe, camera: Camera,
    width=1200, height=1024, spp=4, max_depth=4,
    refine_fraction=0.25, warmup_spp: int | None = None, area_light=None,
    **overrides,
) -> AdaptiveRenderer:
    """Variance-guided adaptive sampling over the Disney PT engine: each
    render() after the warm-up refines the top `refine_fraction` of 16x8
    tiles by measured relative variance with `spp` fresh samples."""
    cfg = _tuned(cs, RenderConfig(width=width, height=height, samples_per_launch=spp,
                                  max_depth=max_depth, **overrides), overrides)
    return AdaptiveRenderer(cs, probe, cfg, camera, area_light=area_light,
                            warmup_spp=spp if warmup_spp is None else warmup_spp,
                            refine_spp=spp, refine_fraction=refine_fraction)


PRESETS = {
    "hello_raytracing": make_hello_renderer,
    "whitted": make_whitted_renderer,
    "disney_pt": make_disney_pt_renderer,
    "spectral": make_spectral_renderer,
    "foveated": make_foveated_renderer,
}
