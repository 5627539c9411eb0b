"""Port parity, `engine/renderer.Renderer`'s state management: `set_camera`
and `set_probe` restart the progressive accumulation and the next frame
matches the JAX renderer's (rtol / atol 1e-5 on the linear accumulation:
the two trace the same paths, and their f32 shading differs by a few ulps),
and `stats` has the reference's keys.

Both sides render the open golden scene at 24x16, 2 spp, depth 2, the JAX
side through its exact lockstep backend (as tests/test_torch_slice.py), the
port through its cluster backend on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from tests.golden_scenes import _open_scene, _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 24, 16
CFG = dict(width=W, height=H, samples_per_launch=2, max_depth=2)
VIEW_A = dict(eye=(3.2, 2.2, 4.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45)
VIEW_B = dict(eye=(-3.0, 1.6, 3.5), lookat=(0, 0.3, 0), up=(0, 1, 0), fov_y=50)


def _other_sky():
    """A second sky, from a numpy seed: (JAX probe, the port's probe)."""
    sky = np.random.default_rng(5).uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32)
    jp = jax_build_probe(jnp.asarray(sky))
    return jp, interop.probe_from_arrays(interop.probe_arrays(jp), CPU)


@pytest.fixture()
def renderers():
    """(JAX renderer, port renderer) on the same scene, sky and view, each
    two frames into its accumulation."""
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    jr = JaxRenderer(jcs, _sky_probe(), JaxConfig(traversal="lockstep", **CFG),
                     JaxCamera(aspect_ratio=W / H, **VIEW_A))
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    pr = Renderer(pcs, probe, RenderConfig(traversal="cluster", **CFG),
                  Camera(aspect_ratio=W / H, **VIEW_A))
    for r in (jr, pr):
        r.render_n(2)
    return jr, pr


def _assert_next_frame_matches(jr, pr):
    assert pr.subframe_index == jr.subframe_index == 0
    jr.render()
    pr.render()
    assert pr.subframe_index == jr.subframe_index == 1
    got, want = pr.accum_image(), jr.accum_image()
    assert got.shape == want.shape == (H, W, 3) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_set_camera_restarts_accumulation_and_matches_jax(renderers):
    jr, pr = renderers
    before = pr.accum_image().copy()
    # an aspect ratio that is not the framebuffer's: set_camera overrides it
    jr.set_camera(JaxCamera(aspect_ratio=1.0, **VIEW_B))
    pr.set_camera(Camera(aspect_ratio=1.0, **VIEW_B))
    assert pr.camera.aspect_ratio == jr.camera.aspect_ratio == W / H
    _assert_next_frame_matches(jr, pr)
    # the new view replaced the old mean (subframe 0 does not blend)
    assert np.abs(pr.accum_image() - before).max() > 0.05


def test_set_probe_restarts_accumulation_and_matches_jax(renderers):
    jr, pr = renderers
    jp, pp = _other_sky()
    jr.set_probe(jp)
    pr.set_probe(pp)
    assert pr.probe is pp
    _assert_next_frame_matches(jr, pr)


def test_stats_has_the_reference_keys(renderers):
    jr, pr = renderers
    got, want = pr.stats(), jr.stats()
    assert list(got) == list(want) == ["frames", "last_frame_s", "mean_frame_s", "fps", "total_spp"]
    assert got["frames"] == want["frames"] == 2 and got["total_spp"] == want["total_spp"] == 4
    assert got["last_frame_s"] > 0 and got["fps"] == pytest.approx(1.0 / got["mean_frame_s"])


def test_stats_before_the_first_frame():
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    pr = Renderer(pcs, probe, RenderConfig(traversal="cluster", **CFG),
                  Camera(aspect_ratio=W / H, **VIEW_A))
    assert pr.stats() == {"frames": 0}
    assert JaxRenderer(jcs, _sky_probe(), JaxConfig(**CFG)).stats() == {"frames": 0}
