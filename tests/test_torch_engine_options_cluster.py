"""Port parity, the engine's last options against the JAX cluster walk:
one case per option (`fused_shadows`, `env_via_bsdf`, `nee_rr`) on the open
golden scene, the port's cluster walk against the JAX renderer's
(`traversal="cluster"`, its Pallas kernels in interpret mode), the walk
the port runs on the card. tests/test_torch_engine_options.py holds the
same options against the JAX lockstep walk on a glass-free scene; here the
open scene's glass box stays in, as both sides walk the clusters alike.
The JAX scene carries across (`interop`), so both walk one cluster order.
Tolerances: rtol / atol 1e-5 on the accumulation (1.5e-6 read); rays traced
within 0.2 %: on this view one or two of ~1900 rays part with no trace
in the image (the lanes are not traced down; the shading math's ulp-level
differences, ROADMAP C's "BSDF parity tolerance", are the candidate).
`nee_rr` is in tests/test_torch_engine_options_cluster_rr.py (each JAX
interpret-mode compile takes 15-20 s on one CPU thread).
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from tests.golden_scenes import _open_scene, _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 24, 16
CAM = dict(eye=(3.2, 2.2, 4.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)


@pytest.mark.parametrize("opts", [dict(fused_shadows=True), dict(env_via_bsdf=True)],
                         ids=["fused", "env"])
def test_option_equal_to_jax_cluster_walk(opts):
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    base = dict(width=W, height=H, samples_per_launch=2, max_depth=2, traversal="cluster", **opts)
    jr = JaxRenderer(jcs, _sky_probe(), JaxConfig(**base), JaxCamera(**CAM))
    jr.render()
    pr = Renderer(interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU),
                  interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU),
                  RenderConfig(**base), Camera(**CAM))
    pr.render()
    got, want = int(pr.last_output.rays_traced), int(jr._last.rays_traced)
    assert abs(got - want) <= 0.002 * want, (got, want)
    np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
