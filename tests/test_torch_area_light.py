"""Port parity, the parallelogram area light: `lights/lights`, the quad NEE
(`_quad_nee`, `quad_light_pdf`) and its MIS weight on emissive hits, and
the `Renderer` with `area_light=`, against the JAX package; and the port of
tests/test_area_light.py's noise test. (`AdaptiveRenderer(area_light=)` is
held in tests/test_torch_adaptive.py, the cornell goldens in
tests/test_torch_file_scenes.py.)

The light's fields, its draws (`sample_parallelogram`) and the pdfs are
bit-equal; the quad NEE's contributions agree to rtol 1e-5 (the BSDF
evaluation's ulp-level differences, as in tests/test_torch_probe_disney.py)
and its RNG states bit for bit. Renders compare at rtol / atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.rng import RngState as JRng
from optixpathtracer_tpu.core.rng import tea as jtea
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.lights import lights as jlights
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.rng import RngState, tea
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.lights import lights as tlights
from optixpathtracer_tpu_torch.lights.probe import build_probe
from tests.golden_scenes import _cornell_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
LIGHT = dict(corner=(-0.5, 2.96, -0.5), v1=(1.0, 0, 0), v2=(0, 0, 1.0), emission=(15.0, 13.0, 10.0))
SKEW = dict(corner=(0.3, 1.7, -0.2), v1=(0.7, 0.1, -0.2), v2=(-0.1, 0.05, 0.9), emission=(3.0, 2.0, 1.0))


def _jv(a):
    return JVec3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _tv(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("spec", [LIGHT, SKEW])
def test_quad_light_fields_and_interop(spec):
    got, want = tlights.QuadLight.make(**spec, device=CPU), jlights.QuadLight.make(**spec)
    for name in ("corner", "v1", "v2", "emission", "normal"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.dtype == torch.float32 and a.dim() == 0
            _eq(a.numpy(), b)
    _eq(got.area.numpy(), want.area)
    back = interop.quad_light_arrays(interop.quad_light_from_arrays(interop.quad_light_arrays(want), CPU))
    for k, v in interop.quad_light_arrays(got).items():
        _eq(back[k], v)


def test_light_table_equal():
    specs = [tlights.make_point_light((1, 2, 3), (0.5, 0.25, 1), 4.0),
             tlights.make_ambient_light((1, 1, 1), 0.8),
             tlights.make_parallelogram_light(LIGHT["corner"], LIGHT["v1"], LIGHT["v2"], LIGHT["emission"])]
    jspecs = [jlights.make_point_light((1, 2, 3), (0.5, 0.25, 1), 4.0),
              jlights.make_ambient_light((1, 1, 1), 0.8),
              jlights.make_parallelogram_light(LIGHT["corner"], LIGHT["v1"], LIGHT["v2"], LIGHT["emission"])]
    assert specs == jspecs
    for lights, jl in ((specs, jspecs), ([], [])):
        got, want = tlights.build_lights(lights, CPU), jlights.build_lights(jl)
        assert got.count == want.count
        for name in ("kind", "intensity"):
            _eq(getattr(got, name).numpy(), getattr(want, name))
        for name in ("position", "v1", "v2", "color"):
            for a, b in zip(getattr(got, name), getattr(want, name)):
                _eq(a.numpy(), b)


@pytest.mark.parametrize("spec", [LIGHT, SKEW])
def test_sample_parallelogram_bit_equal(spec):
    n = 4096
    seeds = np.arange(n, dtype=np.int64) * 7 + 3
    got_l, want_l = tlights.QuadLight.make(**spec, device=CPU), jlights.QuadLight.make(**spec)
    got = tlights.sample_parallelogram(got_l.corner, got_l.v1, got_l.v2,
                                       RngState.seed(tea(torch.as_tensor(seeds), 5)))
    want = jlights.sample_parallelogram(want_l.corner, want_l.v1, want_l.v2,
                                        JRng.seed(jtea(jnp.asarray(seeds.astype(np.uint32)), 5)))
    for a, b in zip(got[0], want[0]):  # the state: one randf2 drawn
        _eq(a.numpy().astype(np.uint32), b)
    for a, b in zip(got[1], want[1]):
        _eq(a.numpy(), b)
    for a, b in zip(got[2], want[2]):
        _eq(a.numpy(), b)
    _eq(got[3].numpy(), want[3])


def test_quad_light_pdf_bit_equal():
    rng = np.random.default_rng(1)
    n = 4096
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = (1.0, 0.0, 0.0)  # grazing: cos 0, the 1e-9 floor
    t = rng.uniform(0.01, 5, n).astype(np.float32)
    for spec in (LIGHT, SKEW):
        got = twf.quad_light_pdf(tlights.QuadLight.make(**spec, device=CPU), _tv(p), _tv(d),
                                 torch.as_tensor(t))
        want = jwf.quad_light_pdf(jlights.QuadLight.make(**spec), _jv(p), _jv(d), jnp.asarray(t))
        _eq(got.numpy(), want)


@pytest.fixture(scope="module")
def cornell():
    """The cornell golden scene compiled by the JAX package (with its BVH
    for the lockstep sweeps) and the same arrays in the port."""
    jcs = jax_compile(_cornell_scene(), cluster_size=128, build_wide_bvh=False)
    return jcs, interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)


def test_quad_nee_equal_to_jax(cornell):
    """`_quad_nee` on the shaded hits of 4096 camera rays into the cornell
    box (its shadow rays through each package's any-hit sweep)."""
    jcs, pcs = cornell
    cam = scenes.cornell_camera(64, 64)
    rng = np.random.default_rng(2)
    n = 4096
    uu, vv, ww = cam.uvw_frame()
    sx, sy = rng.uniform(-1, 1, (2, n, 1))
    d = (sx * uu[None] + sy * vv[None] + ww[None]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray(cam.eye, np.float32), (n, 3)).copy()
    rec = twf.closest_hit_cluster(pcs.clusters, _tv(o), _tv(d), 1e-3, 1e16)
    n_hit, mat, albedo, _ = twf._hit_geometry(pcs, rec, _tv(d), False)
    p_hit = _tv(o) + _tv(d) * rec.t
    mat_id = pcs.scene.take_shade(torch.clamp(rec.tri, min=0).to(torch.int64))[7]
    jmat = jcs.scene.materials.take(jnp.asarray(mat_id.numpy()))
    dark = (mat.emission.x + mat.emission.y + mat.emission.z) == 0.0
    active = rec.hit & dark
    assert 0.5 < active.float().mean() < 1.0  # the emitter's lanes are off
    eta_o = mat.index_of_refraction()  # eta_i = 1: every ray starts in air
    seeds = np.arange(n, dtype=np.int64)
    as_np = [np.stack([c.numpy() for c in v], 1) for v in (p_hit, n_hit, albedo)]
    wo = -d
    cfg = dict(width=64, height=64, shadow_t_min=0.01)
    got = twf._quad_nee(pcs, twf.RenderConfig(traversal="cluster", **cfg),
                        tlights.QuadLight.make(**LIGHT, device=CPU), p_hit, n_hit, _tv(wo), mat, albedo,
                        torch.ones(n), eta_o, active, RngState.seed(tea(torch.as_tensor(seeds), 9)))
    want = jwf._quad_nee(jcs, jwf.RenderConfig(traversal="lockstep", **cfg), jlights.QuadLight.make(**LIGHT),
                         _jv(as_np[0]), _jv(as_np[1]), _jv(wo), jmat, _jv(as_np[2]), jnp.ones(n),
                         jnp.asarray(eta_o.numpy()), jnp.asarray(active.numpy()),
                         JRng.seed(jtea(jnp.asarray(seeds.astype(np.uint32)), 9)))
    for a, b in zip(got[0], want[0]):
        _eq(a.numpy().astype(np.uint32), b)
    lit = np.stack([c.numpy() for c in got[1]], 1)
    want_lit = np.stack([np.asarray(c) for c in want[1]], 1)
    np.testing.assert_allclose(lit, want_lit, rtol=1e-5, atol=1e-6)
    traced = got[2].numpy()
    assert (traced <= active.numpy()).all() and 0.3 < traced.mean()
    assert ((lit > 0).any(1) <= traced).all() and (lit > 0).any(1).mean() > 0.2  # some occluded, most lit


def _jax_render(jcs, cfg, cam, light, frames, **kw):
    r = JaxRenderer(jcs, jax_build_probe(np.full((8, 16, 3), 1e-6, np.float32)), cfg,
                    JaxCamera(**cam), area_light=light, **kw)
    r.render_n(frames)
    return r


@pytest.mark.parametrize("flags", [
    dict(emission_all_bounces=True),
    dict(emission_all_bounces=True, sort_rays=True, batch_spp=True, nee_final_bounce=False),
    dict(emission_all_bounces=False),
])
def test_renderer_area_light_equal_to_jax(cornell, flags):
    """The cornell box under its quad light: the quad NEE on every shaded
    bounce, and (with emission_all_bounces) the MIS weight on emissive hits
    on the quad, in the peeled last bounce too (nee_final_bounce=False)."""
    jcs, pcs = cornell
    w, h = 24, 16
    cam = dict(eye=(0, 1.5, 5.6), lookat=(0, 1.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=w / h)
    base = dict(width=w, height=h, samples_per_launch=2, max_depth=3, **flags)
    jr = _jax_render(jcs, jwf.RenderConfig(traversal="lockstep", **base), cam,
                     jlights.QuadLight.make(**LIGHT), 2)
    pr = Renderer(pcs, scenes.dark_probe(CPU), twf.RenderConfig(traversal="cluster", **base),
                  Camera(**cam), area_light=scenes.cornell_light(CPU))
    pr.render_n(2)
    np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
    # the count leaves the quad NEE's shadow rays out, as the reference's does
    assert int(pr.last_output.rays_traced) == int(jr._last.rays_traced)


def _noise_render(area_light, frames, spp=4):
    """tests/test_area_light.py's scene: a floor, a block and an emissive
    panel that is also geometry, so BSDF paths can hit it."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.7, 0.7, 0.7)), pos=(0, -0.1, 0), extent=(4, 0.1, 4))
    hs.add_box(make_material(color=(0.6, 0.2, 0.2)), pos=(0, 0.4, 0), extent=(0.4, 0.4, 0.4))
    hs.add_box(make_material(color=(0.8, 0.8, 0.8), emission=(12.0, 12.0, 12.0)),
               pos=(0.0, 2.5, 0.0), extent=(0.6, 0.02, 0.6))
    cfg = twf.RenderConfig(width=48, height=36, samples_per_launch=spp, max_depth=3,
                           emission_all_bounces=True, traversal="cluster")
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.5, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=48 / 36)
    light = tlights.QuadLight.make(corner=(-0.6, 2.48, -0.6), v1=(1.2, 0, 0), v2=(0, 0, 1.2),
                                   emission=(12.0, 12.0, 12.0), device=CPU) if area_light else None
    r = Renderer(compile_scene(hs, CPU), build_probe(np.full((8, 16, 3), 1e-5, np.float32), CPU), cfg, cam,
                 area_light=light)
    r.render_n(frames)
    return r.accum_image()


def test_quad_nee_reduces_noise():
    a = _noise_render(True, frames=2)
    bf = _noise_render(False, frames=2)

    def roughness(img):
        # pixel-to-pixel variation on the flat floor region (bottom third)
        floor = img[24:, 4:44]
        return np.abs(np.diff(floor, axis=1)).mean()

    assert roughness(a) < roughness(bf) * 0.6, (roughness(a), roughness(bf))
