"""The engine options' properties in the port alone: the ports of
tests/test_fused_shadows.py (fused == unfused at rtol 1e-4 / atol 1e-5,
with equal `rays_traced`), tests/test_env_mis.py (env_via_bsdf recovers the
furnace energy the NEE-only estimator loses) and tests/test_nee_scheduling.py
(nee_rr traces fewer rays and is unbiased within 5 %; the final-bounce skip
removes only non-negative contributions). Parity with the JAX renderer is
held in tests/test_torch_engine_options.py.
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import MATERIAL_FLAG_SHADOW_CATCHER, make_material
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.lights.probe import build_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _port_render(cs, probe, frames=1, w=48, h=36, **kw):
    cfg = twf.RenderConfig(width=w, height=h, traversal="cluster", **kw)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=w / h)
    r = Renderer(cs, probe, cfg, cam)
    r.render_n(frames)
    return r


def _boxes(catcher=False):
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8), flags=MATERIAL_FLAG_SHADOW_CATCHER if catcher else 0),
               pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs, CPU)


@pytest.mark.parametrize("catcher, opts", [
    (False, dict(samples_per_launch=4, max_depth=3)),
    (True, dict(samples_per_launch=4, max_depth=3)),
    (False, dict(samples_per_launch=4, max_depth=3, batch_spp=True, sort_rays=True)),
    (False, dict(samples_per_launch=2, max_depth=3, nee_final_bounce=False, nee_rr=0.3)),
], ids=["plain", "catcher", "batch_sort", "skip_rr"])
def test_fused_matches_unfused(catcher, opts):
    """tests/test_fused_shadows.py: the combined sweep changes when the
    shadow rays are traced, never the image or the number of rays."""
    cs = _boxes(catcher)
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32), CPU)
    a = _port_render(cs, probe, fused_shadows=False, **opts)
    b = _port_render(cs, probe, fused_shadows=True, **opts)
    np.testing.assert_allclose(b.accum_image(), a.accum_image(), rtol=1e-4, atol=1e-5)
    assert int(b.last_output.rays_traced) == int(a.last_output.rays_traced)


def _furnace(env_via_bsdf, fused=False, frames=6):
    """tests/test_env_mis.py: a diffuse floor under a uniform sky of 1."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.6, 0.6, 0.6)), pos=(0, -0.1, 0), extent=(60, 0.1, 60))
    cfg = twf.RenderConfig(width=40, height=30, samples_per_launch=8, max_depth=4, traversal="cluster",
                           env_via_bsdf=env_via_bsdf, fused_shadows=fused, batch_spp=True)
    cam = Camera(eye=(0, 3, 8), lookat=(0, 0, -6), up=(0, 1, 0), fov_y=35, aspect_ratio=40 / 30)
    r = Renderer(compile_scene(hs, CPU), build_probe(np.full((16, 32, 3), 1.0, np.float32), CPU), cfg, cam)
    r.render_n(frames)
    return float(r.accum_image()[12:24, 8:32].mean())


def test_env_via_bsdf_recovers_furnace_energy():
    on, off = _furnace(True), _furnace(False)
    assert 0.6 < on < 0.95, on
    assert off < on - 0.05, (off, on)
    np.testing.assert_allclose(_furnace(True, fused=True, frames=2), _furnace(True, frames=2), rtol=1e-4)


def _sched(**kw):
    """tests/test_nee_scheduling.py's scene and probe, one launch."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2), roughness=0.4), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(make_material(color=(0.9, 0.8, 0.2), metallic=1.0, roughness=0.2), pos=(1.2, 0.4, 0.5),
               extent=(0.4, 0.4, 0.4))
    rng = np.random.default_rng(7)
    probe = build_probe((0.3 + rng.random((8, 16, 3)) * 1.5).astype(np.float32), CPU)
    w, h = kw.pop("width", 24), kw.pop("height", 16)
    cfg = twf.RenderConfig(width=w, height=h, traversal="cluster", **kw)
    cam = twf.CameraParams.from_camera(Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                                              aspect_ratio=w / h), CPU)
    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)
    out = twf.trace_wavefront(compile_scene(hs, CPU), probe, cfg, cam, torch.as_tensor(xs),
                              torch.as_tensor(ys), 0)
    return np.stack([c.numpy() for c in out.color]), int(out.rays_traced)


def test_nee_rr_traces_fewer_rays_and_is_unbiased():
    base, rays = _sched(samples_per_launch=4, max_depth=3)
    rr, rr_rays = _sched(samples_per_launch=4, max_depth=3, nee_rr=10.0)
    assert np.isfinite(rr).all() and rr_rays < rays
    # one expanded wavefront of all 192 samples (the same streams as the loop)
    mb, _ = _sched(width=12, height=8, samples_per_launch=192, max_depth=2, batch_spp=True)
    mr, _ = _sched(width=12, height=8, samples_per_launch=192, max_depth=2, nee_rr=0.2, batch_spp=True)
    assert abs(mb.mean() - mr.mean()) / mb.mean() < 0.05, (mb.mean(), mr.mean())


@pytest.mark.parametrize("fused", [False, True])
def test_final_bounce_skip_is_a_subset(fused):
    base, rays = _sched(samples_per_launch=4, max_depth=3, fused_shadows=fused)
    skip, skip_rays = _sched(samples_per_launch=4, max_depth=3, fused_shadows=fused,
                             nee_final_bounce=False)
    assert np.isfinite(skip).all() and skip_rays < rays
    assert np.all(skip <= base + 1e-5)
