"""Port parity, an instanced render: the TLAS of tests/test_torch_instancing.py
(rotations, a non-uniform scale, a mirror, two instances overlapping
exactly) rendered by the JAX renderer (its cluster walk, the Pallas kernels
in interpret mode) and by the port, shading normals on, with the coherence
sort and the batched samples: rtol / atol 1e-5 and equal `rays_traced`.
"""
import numpy as np
import torch

from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.lights.probe import build_probe
from tests.test_torch_instancing import tlas_pair

torch.set_num_threads(1)
CPU = torch.device("cpu")
CAM = dict(eye=(18, 12, 18), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=50, aspect_ratio=32 / 24)


def _cfg(mod, **kw):
    return mod.RenderConfig(width=32, height=24, samples_per_launch=2, max_depth=2,
                            traversal="cluster", **kw)


def test_render_equal_to_jax():
    got_cs, want_cs, _ = tlas_pair()
    flags = dict(use_shading_normals=True, sort_rays=True, batch_spp=True)
    sky = np.full((16, 32, 3), 0.6, np.float32)
    sky[2:5, 10:14] = 20.0
    jr = JaxRenderer(want_cs, jax_build_probe(sky), _cfg(jwf, **flags), JaxCamera(**CAM))
    jr.render()
    pr = Renderer(got_cs, build_probe(sky, CPU), _cfg(twf, **flags), Camera(**CAM))
    pr.render()
    assert pr.accum_image().std() > 0.01  # instances in view, not only sky
    np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
    assert int(pr.last_output.rays_traced) == int(jr._last.rays_traced)
