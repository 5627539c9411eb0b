"""Port parity, `engine/renderer.Renderer`'s state management: `set_camera`
and `set_probe` restart the progressive accumulation and the next frame
matches the JAX renderer's (rtol / atol 1e-5 on the linear accumulation:
the two trace the same paths, and their f32 shading differs by a few ulps),
and `stats` has the reference's keys. `aovs` match to the same tolerance,
`denoised_image` to rtol 1e-4 / atol 1e-5 (tests/test_torch_denoise.py),
and a checkpoint written by either package loads in the other and in a
fresh renderer of its own: the next frame matches the continuing renderer's
(bit for bit within the port).

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
from optixpathtracer_tpu_torch.ops.denoise import atrous_denoise
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


def test_aovs_match_jax(renderers):
    jr, pr = renderers
    got, want = pr.aovs(), jr.aovs()
    assert list(got) == list(want) == ["normal", "albedo", "alpha", "depth"]
    assert got["depth"].shape == (H, W) and got["normal"].shape == (H, W, 3)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert got["depth"].max() > 0 and (got["depth"] == 0).any()  # hits and sky


def test_aovs_before_the_first_frame_raise():
    _, pr = _fresh()
    with pytest.raises(RuntimeError):
        pr.aovs()


def test_denoised_image_matches_jax_and_runs_the_port_denoiser(renderers):
    jr, pr = renderers
    np.testing.assert_allclose(pr.denoised_image(), jr.denoised_image(), rtol=1e-4, atol=1e-5)
    depth = pr.aovs()["depth"]
    got = pr.denoised_image(iterations=2, depth=torch.as_tensor(depth.copy()), demodulate=True)
    want = jr.denoised_image(iterations=2, depth=jnp.asarray(depth), demodulate=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    aov = pr.aovs()
    direct = atrous_denoise(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (
        pr.accum_image(), aov["normal"], aov["albedo"]))).numpy()
    np.testing.assert_array_equal(pr.denoised_image(), direct)


def _fresh():
    """A (JAX, port) renderer pair at another size than CFG's, not rendered."""
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    cfg = dict(CFG, width=16, height=8)
    return (JaxRenderer(jcs, _sky_probe(), JaxConfig(traversal="lockstep", **cfg)),
            Renderer(pcs, probe, RenderConfig(traversal="cluster", **cfg)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_the_packages(renderers, writer, tmp_path):
    jr, pr = renderers
    path = str(tmp_path / "ckpt.npz")
    (jr if writer == "jax" else pr).save_checkpoint(path)
    jr2, pr2 = _fresh()
    for r in (jr2, pr2):
        r.load_checkpoint(path)
        assert r.subframe_index == 2 and (r.config.width, r.config.height) == (W, H)
        np.testing.assert_allclose(r.camera.eye, VIEW_A["eye"])
        assert r.camera.aspect_ratio == W / H
    np.testing.assert_allclose(pr2.accum_image(), jr2.accum_image(), rtol=0, atol=0)
    for r in (jr, pr, jr2, pr2):
        r.render()
    # every renderer continues to the same third frame
    want = jr.accum_image()
    for r in (pr, jr2, pr2):
        np.testing.assert_allclose(r.accum_image(), want, rtol=1e-5, atol=1e-5)
    if writer == "port":
        np.testing.assert_array_equal(pr2.accum_image(), pr.accum_image())


def test_checkpoint_layout_is_the_references(renderers, tmp_path):
    jr, pr = renderers
    jr.save_checkpoint(str(tmp_path / "j.npz"))
    pr.save_checkpoint(str(tmp_path / "p"))  # np.savez appends .npz
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
    assert b["accum"].shape == (3, W * H) and int(b["subframe_index"]) == 2
    np.testing.assert_allclose(b["accum"], a["accum"], rtol=1e-5, atol=1e-5)
