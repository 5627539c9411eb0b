"""Port parity, the engine's last options: `fused_shadows` (each bounce's
NEE shadow rays ride the next bounce's closest-hit sweep), `env_via_bsdf`
(the probe on BSDF-sampled misses, MIS-weighted) and `nee_rr` (Russian-
roulette shadow-ray scheduling), alone and together with `sort_rays`,
`batch_spp`, `nee_final_bounce=False` and the shadow catcher, against the
JAX renderer (its exact lockstep backend) at rtol / atol 1e-5 with equal
`rays_traced`. The options' properties are held in
tests/test_torch_engine_option_properties.py.
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 24, 16
CAM = dict(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)
BENCH = dict(sort_rays=True, batch_spp=True, nee_final_bounce=False)


def _jax_scene(catcher):
    """tests/test_nee_scheduling.py's scene (a floor, a diffuse box and a
    metal box), its floor a shadow catcher if asked, built with the JAX
    package. (The open golden scene's glass box is not used here: there the
    JAX lockstep backend and the cluster walk split a few edge rays.)"""
    from optixpathtracer_tpu.core.materials import MATERIAL_FLAG_SHADOW_CATCHER as JFLAG
    from optixpathtracer_tpu.core.materials import make_material as jmake
    from optixpathtracer_tpu.core.scene import HostScene as JHost

    hs = JHost()
    hs.add_box(jmake(color=(0.8, 0.8, 0.8), flags=JFLAG if catcher else 0), pos=(0, -0.1, 0),
               extent=(6, 0.1, 6))
    hs.add_box(jmake(color=(0.7, 0.3, 0.2), roughness=0.4), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(jmake(color=(0.9, 0.8, 0.2), metallic=1.0, roughness=0.2), pos=(1.2, 0.4, 0.5),
               extent=(0.4, 0.4, 0.4))
    return hs


@pytest.fixture(scope="module")
def scenes_():
    """The scene, plain and with the catcher floor, compiled by the JAX
    package (with its BVH for the lockstep sweeps) and carried to the port;
    and a sky with a sun (so BSDF-sampled misses matter) in both."""
    sky = np.full((32, 64, 3), 0.35, np.float32)
    sky[4:7, 12:16] = (40.0, 36.0, 30.0)
    sky[20:, :] = 0.08
    jp = jax_build_probe(sky)
    out = {"probe": (jp, interop.probe_from_arrays(interop.probe_arrays(jp), CPU))}
    for name, catcher in (("boxes", False), ("catcher", True)):
        jcs = jax_compile(_jax_scene(catcher), cluster_size=128, build_wide_bvh=False)
        out[name] = (jcs, interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU))
    return out


@pytest.mark.parametrize("scene, opts", [
    ("boxes", dict(fused_shadows=True)),
    ("boxes", dict(env_via_bsdf=True)),
    ("boxes", dict(nee_rr=0.5)),
    ("boxes", dict(fused_shadows=True, sort_rays=True)),
    ("boxes", dict(nee_rr=0.5, env_via_bsdf=True, **BENCH)),
    ("boxes", dict(fused_shadows=True, env_via_bsdf=True, nee_rr=0.5, **BENCH)),
    ("catcher", dict(fused_shadows=True, nee_rr=0.5, batch_spp=True)),
], ids=["fused", "env", "nee_rr", "fused_sort", "env_rr_bench", "all_bench", "catcher_fused_rr"])
def test_render_equal_to_jax(scenes_, scene, opts):
    jcs, pcs = scenes_[scene]
    jp, pp = scenes_["probe"]
    base = dict(width=W, height=H, samples_per_launch=2, max_depth=3, **opts)
    jr = JaxRenderer(jcs, jp, jwf.RenderConfig(traversal="lockstep", **base), JaxCamera(**CAM))
    jr.render_n(2)
    pr = Renderer(pcs, pp, twf.RenderConfig(traversal="cluster", **base), Camera(**CAM))
    pr.render_n(2)
    np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
    assert int(pr.last_output.rays_traced) == int(jr._last.rays_traced)
