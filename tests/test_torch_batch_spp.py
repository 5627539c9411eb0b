"""Port parity, batched samples (the cases of tests/test_batch_spp.py):
`batch_spp=True` traces all samples of a launch in one wavefront, drawing
the same RNG streams per (pixel, sample) as the sample loop, so the port's
batched frame matches its sample loop (rtol 5e-3 / atol 5e-4, the
reference's own: the backplate composite averages the samples where the
loop keeps the last) with equal rays traced, and each matches the JAX
renderer's on the same scene (both on the lockstep walk): rays equal and
the accumulation within rtol / atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.scene import HostScene as JHost
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("w, h, spp, depth", [(24, 16, 2, 1), (48, 36, 4, 2)])
def test_batched_spp_matches_sample_loop(w, h, spp, depth):
    hs = JHost()
    hs.add_box(jmake(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(jmake(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    jcs = jax_compile(hs)
    jp = jax_probe(np.full((8, 16, 3), 0.5, np.float32))
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pp = interop.probe_from_arrays(interop.probe_arrays(jp), CPU)
    cam = dict(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=w / h)
    cfg = RenderConfig(width=w, height=h, samples_per_launch=spp, max_depth=depth)
    out = {}
    for batch in (False, True):
        c = dataclasses.replace(cfg, batch_spp=batch)
        pr = Renderer(pcs, pp, c, Camera(**cam))
        pr.render()
        jr = JaxRenderer(jcs, jp, JaxConfig(**dataclasses.asdict(c)), JaxCamera(**cam))
        jr.render()
        assert pr.config.traversal == "lockstep"
        assert int(pr.last_output.rays_traced) == int(jr._last.rays_traced)
        np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
        out[batch] = pr
    np.testing.assert_allclose(out[True].accum_image(), out[False].accum_image(), rtol=5e-3, atol=5e-4)
    assert int(out[True].last_output.rays_traced) == int(out[False].last_output.rays_traced)
