"""Port parity, engine/foveated and the wavefront options it needs
(`active_mask`, `sample_lanes`): the same setups through the JAX package
and the port.

- Zone geometry, the static lane enumeration (16x8 tile order, float32
  annulus cull) and the per-frame pixel grids are bit-equal.
- One `trace_wavefront` launch with `active_mask` or `sample_lanes` agrees
  per lane within rtol 1e-4 / atol 1e-5, the tolerance of
  tests/test_torch_wavefront.py (the same RNG streams; only the shading
  math's ulp-level differences remain), and traces exactly as many rays.
- `FoveatedRenderer` in three-launch and fused mode agrees with the JAX
  renderer within 1e-5 over two frames, with equal ray counts; the port's
  fused image equals its three-launch image (no antialiasing: the setup of
  tests/test_foveated_fused.py); the `foveated` golden holds at
  sqrt-space RMSE 2e-3. `foveated_s` misses it on one sample, as the JAX
  renderer itself does when run eagerly (see the last test).

The JAX side traces with its exact lockstep backend, the port with its
cluster backend, on identical scene state (`interop`), in the scene of
tests/test_foveated_fused.py. Per-lane checks avoid the open golden scene:
there a one-ulp ray difference (jitted XLA contracts a*b+c into FMA; the
port rounds every op) can move a bounce origin onto the glass box's bottom
face, which is coplanar with the ground, and the exact-t tie between the two
faces then falls to the other one: 2 lanes of 3072 take other paths. Fed
the same ray, every backend picks the same triangle.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera
from optixpathtracer_tpu.core.materials import make_material as jax_material
from optixpathtracer_tpu.core.scene import HostScene as JaxHostScene
from optixpathtracer_tpu.engine import foveated as jfov
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.engine import foveated as tfov
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.models import PRESETS, make_foveated_renderer
from tests import golden_scenes as tests_golden

torch.set_num_threads(1)
CPU = torch.device("cpu")
RMSE_TOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (width, height, FoveationConfig kwargs)
ZONE_SETUPS = {
    "sv4_3840x2160": (3840, 2160, {}),
    "small_48x32_r8_16": (48, 32, dict(inner_radius=8, outer_radius=16)),
}
ZONE_NAMES = ("periphery", "ring", "fovea")


def _zones(setup):
    w, h, kw = ZONE_SETUPS[setup]
    return w, h, jfov.FoveationConfig(**kw).zones(w, h), tfov.FoveationConfig(**kw).zones(w, h)


@pytest.mark.parametrize("setup", sorted(ZONE_SETUPS))
def test_zones_match_reference(setup):
    _, _, jz, tz = _zones(setup)
    assert [dataclasses.astuple(z) for z in tz] == [dataclasses.astuple(z) for z in jz]
    assert [z.name for z in tz] == list(ZONE_NAMES)


@pytest.mark.parametrize("zone", ZONE_NAMES)
@pytest.mark.parametrize("setup", sorted(ZONE_SETUPS))
def test_zone_lanes_bit_equal(setup, zone):
    _, _, jz, tz = _zones(setup)
    k = ZONE_NAMES.index(zone)
    jx, jy, jc = jfov._zone_lanes(jz[k])
    tx, ty, tc_ = tfov._zone_lanes(tz[k])
    assert tc_ == jc and tx.dtype == jx.dtype and ty.dtype == jy.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


# setup -> gaze in buffer coordinates: the centre, on an edge, in a corner
GAZES = {
    "sv4_3840x2160": {"centre": (1920, 1080), "edge": (0, 871), "corner": (3839, 2159)},
    "small_48x32_r8_16": {"centre": (24, 16), "edge": (0, 13), "corner": (47, 31)},
}


@pytest.mark.parametrize("gaze", ["centre", "edge", "corner"])
@pytest.mark.parametrize("setup", sorted(ZONE_SETUPS))
def test_zone_pixels_match_reference(setup, gaze):
    w, h, jz, tz = _zones(setup)
    g = GAZES[setup][gaze]
    jcfg = jwf.RenderConfig(width=w, height=h)
    tcfg = twf.RenderConfig(width=w, height=h)
    for j, t in zip(jz, tz):
        want = jfov._zone_pixels(jcfg, j, jnp.asarray(g, jnp.int32))
        got = tfov._zone_pixels(tcfg, t, g, CPU)
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=t.name)


# ---- trace_wavefront with active_mask / sample_lanes ------------------------

def _box_scene_jax():
    """tests/test_foveated_fused.py's scene: a slab and a box under a
    uniform sky, and its camera at 48x32."""
    hs = JaxHostScene()
    hs.add_box(jax_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(jax_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    jcs = jax_compile(hs, cluster_size=128, build_wide_bvh=False)
    jprobe = jax_probe(np.full((8, 16, 3), 0.5, np.float32))
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=48 / 32)
    return jcs, jprobe, cam


@pytest.fixture(scope="module")
def scene_pair():
    """(JAX compiled scene, JAX probe, port scene, port probe, camera) with
    identical scene state on both sides."""
    jcs, jprobe, cam = _box_scene_jax()
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pprobe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    return jcs, jprobe, pcs, pprobe, cam


def _check_launch(got, want):
    assert int(got.rays_traced) == int(want.rays_traced)
    for field in ("color", "alpha", "normal", "albedo"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                       err_msg=field)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-4, atol=1e-5)


def _launch_pair(pair, flags, w, h, xs, ys, subframe, **lane_args):
    jcs, jprobe, pcs, pprobe, cam = pair
    base = dict(width=w, height=h, max_depth=2, **flags)
    want = jwf.trace_wavefront(
        jcs, jprobe, jwf.RenderConfig(traversal="lockstep", **base),
        jwf.CameraParams.from_camera(cam), jnp.asarray(xs), jnp.asarray(ys), jnp.uint32(subframe),
        **{k: jnp.asarray(v) for k, v in lane_args.items()})
    got = twf.trace_wavefront(
        pcs, pprobe, twf.RenderConfig(traversal="cluster", **base),
        twf.CameraParams.from_camera(cam, CPU), torch.as_tensor(xs), torch.as_tensor(ys), subframe,
        **{k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32 else v)
           for k, v in lane_args.items()})
    return got, want


LAUNCH_FLAGS = {
    "bench_batch_spp": dict(samples_per_launch=2, sort_rays=True, batch_spp=True,
                            nee_final_bounce=False),
    "spp_loop": dict(samples_per_launch=2),
}


@pytest.mark.parametrize("flags", sorted(LAUNCH_FLAGS))
def test_trace_wavefront_active_mask_vs_jax(scene_pair, flags):
    w, h = 48, 32
    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)
    active = np.random.default_rng(5).random(w * h) < 0.6
    got, want = _launch_pair(scene_pair, LAUNCH_FLAGS[flags], w, h, xs, ys, 3,
                             active_mask=active)
    _check_launch(got, want)
    # culled lanes trace nothing: fewer rays than the unmasked launch
    full, _ = _launch_pair(scene_pair, LAUNCH_FLAGS[flags], w, h, xs, ys, 3)
    assert 0 < int(got.rays_traced) < int(full.rays_traced)
    assert float(got.alpha.x[~torch.as_tensor(active)].abs().max()) == 0.0


def test_trace_wavefront_sample_lanes_vs_jax(scene_pair):
    """One sample per lane with its own counter (uint32, some above 2^31),
    several lanes per pixel, and a culling mask: the fused launch's shape."""
    w, h = 48, 32
    rng = np.random.default_rng(6)
    n = 2000
    xs = rng.integers(0, w, n).astype(np.int32)
    ys = rng.integers(0, h, n).astype(np.int32)
    lanes = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lanes[:500] = np.arange(500, dtype=np.uint32) % 8  # small counters, as the fused launch's
    active = rng.random(n) < 0.7
    flags = dict(samples_per_launch=1, sort_rays=True, nee_final_bounce=False)
    got, want = _launch_pair(scene_pair, flags, w, h, xs, ys, 0, sample_lanes=lanes,
                             active_mask=active)
    _check_launch(got, want)


# ---- FoveatedRenderer -------------------------------------------------------

FOV = dict(inner_radius=8, outer_radius=16)
GAZE = (20, 12)  # image coordinates, off centre: the y flip matters


@pytest.fixture(scope="module")
def jax_foveated():
    """JAX FoveatedRenderer, three-launch and fused, two frames each:
    (scene state, flags, camera, {fused: (accum image, last_rays, frame)})."""
    jcs, jprobe, cam = _box_scene_jax()
    flags = dict(width=48, height=32, max_depth=1, antialias=False, batch_spp=True, sort_rays=True)
    out = {}
    for fused in (False, True):
        r = jfov.FoveatedRenderer(jcs, jprobe, jwf.RenderConfig(traversal="lockstep", **flags),
                                  cam, jfov.FoveationConfig(**FOV), fused=fused)
        r.set_gaze(*GAZE)
        for _ in range(2):
            frame = r.render()
        out[fused] = (r.accum_image(), r.last_rays, frame)
    state = (interop.compiled_scene_arrays(jcs), interop.probe_arrays(jprobe))
    return state, flags, cam, out


def _port_foveated(jax_foveated, fused, frames=2):
    (scene_arrays, probe_arrays), flags, cam, _ = jax_foveated
    pcs = interop.compiled_scene_from_arrays(scene_arrays, CPU)
    probe = interop.probe_from_arrays(probe_arrays, CPU)
    r = tfov.FoveatedRenderer(pcs, probe, twf.RenderConfig(traversal="cluster", **flags), cam,
                              tfov.FoveationConfig(**FOV), fused=fused)
    r.set_gaze(*GAZE)
    frame = None
    for _ in range(frames):
        frame = r.render()
    return r, frame


@pytest.mark.parametrize("fused", [False, True], ids=["three_launch", "fused"])
def test_foveated_renderer_vs_jax(jax_foveated, fused):
    want, want_rays, want_frame = jax_foveated[3][fused]
    r, frame = _port_foveated(jax_foveated, fused)
    got = r.accum_image()
    assert got.shape == want.shape == (32, 48, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert r.last_rays == want_rays > 0
    assert frame.shape == (32, 48, 4) and frame.dtype == np.uint8
    assert np.abs(frame.astype(int) - want_frame.astype(int)).max() <= 1
    assert r.subframe_index == 2 and r.stats()["frames"] == 2


def test_port_fused_equals_three_launches(jax_foveated):
    """tests/test_foveated_fused.py on the port alone: one frame and two."""
    for frames in (1, 2):
        (a, _), (b, _) = (_port_foveated(jax_foveated, f, frames) for f in (False, True))
        np.testing.assert_allclose(b.accum_image(), a.accum_image(), rtol=1e-5, atol=1e-5)
        assert a.last_rays == b.last_rays


def test_set_camera_restarts_accumulation(jax_foveated):
    r, _ = _port_foveated(jax_foveated, False, frames=1)
    r.set_camera(r.camera)
    assert r.subframe_index == 0
    assert r.render(download=False) is None and r.subframe_index == 1


def test_foveated_golden():
    want = np.load(os.path.join(REPO, "tests", "goldens", "foveated.npz"))["image"]
    got = scenes.render_foveated_golden("foveated", CPU)
    assert got.shape == want.shape
    assert scenes.golden_rmse(got, want) <= RMSE_TOL


def test_foveated_s_golden_sample_depends_on_xla_fusion():
    """The `foveated_s` golden misses 2e-3 (RMSE 2.38e-3) on one sample of
    one fovea pixel, and so does the JAX renderer itself when it runs
    eagerly (`jax.disable_jit()`: 2.38e-3, while the port agrees with that
    eager render to RMSE 3e-7). The golden was rendered by jitted zone
    programs, where XLA fuses a*b+c into one FMA; eager JAX and the port
    round every op. On this pixel's fovea sample 6 (counter subframe * 8 +
    6 at subframe 0, traced here as subframe 6 at 1 spp: the same stream;
    depth 1) a one-ulp ray difference flips the path, so the fused and the
    eager reference differ by 0.47, and the port equals the eager one."""
    jcs = jax_compile(tests_golden._open_scene(), cluster_size=128, build_wide_bvh=False)
    jprobe = tests_golden._sky_probe()
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pprobe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    cam = tests_golden._cam_s((3.2, 2.2, 4.0), (0, 0.4, 0))
    x, y = 19, 11  # buffer coordinates of image pixel (row 20, column 19)
    base = dict(width=48, height=32, max_depth=1, samples_per_launch=1)
    want = {unroll: float(jwf.trace_wavefront(
        jcs, jprobe, jwf.RenderConfig(traversal="lockstep", unroll=unroll, **base),
        jwf.CameraParams.from_camera(cam), jnp.asarray([x], jnp.int32), jnp.asarray([y], jnp.int32),
        jnp.uint32(6)).color.x[0]) for unroll in (False, True)}
    got = float(twf.trace_wavefront(
        pcs, pprobe, twf.RenderConfig(traversal="cluster", **base),
        twf.CameraParams.from_camera(cam, CPU), torch.tensor([x], dtype=torch.int32),
        torch.tensor([y], dtype=torch.int32), 6).color.x[0])
    assert abs(want[False] - want[True]) > 0.1  # fused vs eager reference
    np.testing.assert_allclose(got, want[True], rtol=1e-5)


def test_make_foveated_renderer_preset():
    assert PRESETS["foveated"] is make_foveated_renderer
    cs = compile_scene(scenes.open_scene(), CPU)
    probe = scenes.sky_probe(CPU)
    r4k = make_foveated_renderer(cs, probe, scenes.open_camera(3840, 2160))
    assert (r4k.config.width, r4k.config.height, r4k.config.max_depth) == (3840, 2160, 4)
    # auto_tune on a CPU: the lockstep walk (the cluster walk on a card);
    # fused at every size: the port's measured rule
    assert r4k.config.traversal == "lockstep" and r4k.fused is True
    assert r4k.fov == tfov.FoveationConfig()
    assert [(z.factor, z.spp) for z in r4k.zones] == [(4, 1), (2, 2), (1, 8)]
    small = make_foveated_renderer(cs, probe, scenes.open_camera(640, 480), width=640, height=480,
                                   foveation=tfov.FoveationConfig(inner_radius=34, outer_radius=114,
                                                                  fovea_spp=4))
    assert small.fused is True and small.zones[2].spp == 4
