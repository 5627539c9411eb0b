"""Port parity, the BFS walk in the engine (the cases of
tests/test_renderer_bfs.py): the same RNG streams and an exact walk give
the BFS render the lockstep render (rtol 2e-3 / atol 2e-4, the reference's
own; bit for bit within the port where the worklist does not overflow, as
the two keep the same triangles with the same arithmetic), and the port's
BFS render matches the JAX renderer's BFS render on the same scene (rtol /
atol 1e-5, equal rays traced and overflow).
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


def _scene(metal):
    hs = JHost()
    hs.add_box(jmake(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(jmake(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    if metal:
        hs.add_box(jmake(color=(0.2, 0.5, 0.9), metallic=1.0, roughness=0.3), pos=(1.2, 0.4, 0.6),
                   extent=(0.4, 0.4, 0.4))
    return hs


@pytest.mark.parametrize("metal, w, h, spp, depth", [(False, 32, 24, 1, 2), (True, 64, 48, 2, 3)],
                         ids=["fast", "metal"])
def test_bfs_render_matches_lockstep_and_reference(metal, w, h, spp, depth):
    jcs = jax_compile(_scene(metal))
    jp = jax_probe(np.full((16, 32, 3), 0.5, np.float32))
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pp = interop.probe_from_arrays(interop.probe_arrays(jp), CPU)
    cam = dict(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=w / h)
    cfg = RenderConfig(width=w, height=h, samples_per_launch=spp, max_depth=depth)
    bfs = dataclasses.replace(cfg, traversal="bfs", bfs_cap_factor=8)
    r_lock, r_bfs = Renderer(pcs, pp, cfg, Camera(**cam)), Renderer(pcs, pp, bfs, Camera(**cam))
    r_lock.render()
    r_bfs.render()
    assert r_lock.config.traversal == "lockstep" and float(r_bfs.last_output.bfs_overflow) == 0.0
    np.testing.assert_allclose(r_bfs.accum_image(), r_lock.accum_image(), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(r_bfs.accum_image(), r_lock.accum_image())
    jr = JaxRenderer(jcs, jp, JaxConfig(**dataclasses.asdict(bfs)), JaxCamera(**cam))
    jr.render()
    assert int(r_bfs.last_output.rays_traced) == int(jr._last.rays_traced)
    assert float(r_bfs.last_output.bfs_overflow) == float(jr._last.bfs_overflow)
    np.testing.assert_allclose(r_bfs.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
