"""Port parity, the cross-knob coverage of tests/test_knob_matrix.py:
`fused_shadows`, `nee_rr`, `sort_rays`, `batch_spp` and the sampling
strategies together, on the port's CPU default walk (lockstep, the
reference's). `sort_rays` is bit-identical under every other knob (the path
order is restored at the end of each sample); stochastic knobs are
deterministic for the seed and keep the image's energy near the plain
config's; everything is finite and non-negative. The reference's named
combination also renders equal to the JAX renderer's (rtol / atol 1e-5,
equal rays traced). The full cross product, a slow tier in the reference,
runs here at the same 32x24 size.
"""
import itertools

import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.scene import HostScene as JHost
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.lights.probe import make_test_probe as jax_test_probe
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 32, 24
CAM = dict(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)


@pytest.fixture(scope="module")
def ctx():
    hs = JHost()
    hs.add_box(jmake(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(jmake(color=(0.7, 0.3, 0.2), roughness=0.4), pos=(-0.8, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(jmake(color=(0.2, 0.4, 0.8), metallic=0.9, roughness=0.15), pos=(0.8, 0.4, 0.3),
               extent=(0.4, 0.4, 0.4))
    jcs = jax_compile(hs)
    jp = jax_test_probe(32, 16)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pp = interop.probe_from_arrays(interop.probe_arrays(jp), CPU)
    return jcs, jp, pcs, pp, _render(pcs, pp)[0]


def _render(cs, probe, **knobs):
    r = Renderer(cs, probe, RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=3, **knobs),
                 Camera(**CAM))
    r.render()
    img = r.accum_image()
    assert np.all(np.isfinite(img)) and np.all(img >= 0), knobs
    return img, int(r.last_output.rays_traced)


def test_sort_rays_bit_identical_under_other_knobs(ctx):
    _, _, cs, probe, base = ctx
    np.testing.assert_array_equal(_render(cs, probe, sort_rays=True)[0], base)
    np.testing.assert_array_equal(_render(cs, probe, fused_shadows=True, sort_rays=True)[0],
                                  _render(cs, probe, fused_shadows=True)[0])


def test_fused_nee_rr_sort_combo(ctx):
    """The named combination: deterministic, energy near the plain config,
    sort bit-exact, and equal to the JAX renderer's."""
    jcs, jp, cs, probe, base = ctx
    knobs = dict(fused_shadows=True, nee_rr=0.5, sort_rays=True)
    a, rays = _render(cs, probe, **knobs)
    np.testing.assert_array_equal(_render(cs, probe, **knobs)[0], a)
    assert abs(a.mean() - base.mean()) / base.mean() < 0.15
    np.testing.assert_array_equal(_render(cs, probe, fused_shadows=True, nee_rr=0.5)[0], a)
    jr = JaxRenderer(jcs, jp, JaxConfig(width=W, height=H, samples_per_launch=2, max_depth=3, **knobs),
                     JaxCamera(**CAM))
    jr.render()
    assert int(jr._last.rays_traced) == rays
    np.testing.assert_allclose(a, jr.accum_image(), rtol=1e-5, atol=1e-5)


def test_everything_on(ctx):
    _, _, cs, probe, base = ctx
    a, _ = _render(cs, probe, fused_shadows=True, nee_rr=0.5, sort_rays=True, batch_spp=True,
                   sampling="stratified", sampling_strata=4)
    assert abs(a.mean() - base.mean()) / base.mean() < 0.15


def test_everything_on_sobol(ctx):
    _, _, cs, probe, base = ctx
    a, _ = _render(cs, probe, fused_shadows=True, nee_rr=0.5, sort_rays=True, batch_spp=True,
                   sampling="sobol")
    assert abs(a.mean() - base.mean()) / base.mean() < 0.15


@pytest.mark.parametrize("fused,nee_rr,batch,sampling", list(itertools.product(
    (False, True), (0.0, 0.5), (False, True), ("random", "stratified", "blue", "sobol"))))
def test_knob_cross_product(ctx, fused, nee_rr, batch, sampling):
    _, _, cs, probe, base = ctx
    knobs = dict(fused_shadows=fused, nee_rr=nee_rr, batch_spp=batch, sampling=sampling,
                 sampling_strata=4)
    a, _ = _render(cs, probe, sort_rays=False, **knobs)
    np.testing.assert_array_equal(_render(cs, probe, sort_rays=True, **knobs)[0], a)
    assert abs(a.mean() - base.mean()) / base.mean() < 0.2, knobs
