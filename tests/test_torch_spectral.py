"""Port parity, engine/spectral (and shade/disney's `cspec0_override`):
`trace_spectral` against the JAX package's, run eagerly on its CPU path
(`jax.disable_jit()`, the lockstep backend: XLA's fused programs contract
a*b+c into FMAs, which the port, like eager JAX, does not; see
tests/test_torch_spectral_golden.py), on the open golden scene carried
across with `interop`; `bsdf_eval` with and without the override; the
`spectral_s` golden; tests/test_spectral_engine.py's spectral-against-RGB
bounds held by the port; the preset.

Tolerances: colors rtol 1e-5 / atol 1e-6 on 99 % of lanes, every lane
within 1e-4 (measured: 99.7 % and 1.2e-5); `bsdf_eval` as
tests/test_torch_probe_disney.py holds it (99 % of lanes at rtol 1e-5 /
atol 1e-6, every lane within 4x the reference's one-ulp spread), and
bit-identical with cspec0_override=None; the golden within sqrt-space RMSE
2e-3 (tests/test_goldens.py); the RGB bounds those of
tests/test_spectral_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.engine import spectral as jspectral
from optixpathtracer_tpu.engine.wavefront import CameraParams as JCam
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JConfig
from optixpathtracer_tpu.shade import disney as jdisney
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine import spectral as tspectral
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import CameraParams, RenderConfig
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.models import PRESETS, make_spectral_renderer
from optixpathtracer_tpu_torch.shade import disney as tdisney
from tests import golden_scenes
from tests.test_torch_probe_disney import _close_conditioned, _materials, _shading_inputs, _ulp_spread

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_trace_spectral_equal_to_eager_jax():
    w, h = 24, 16
    jcs = jax_compile(golden_scenes._open_scene(), cluster_size=128)
    jprobe = golden_scenes._sky_probe()
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pprobe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    cam = scenes.open_camera(w, h)
    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)
    with jax.disable_jit():
        want = jspectral.trace_spectral(
            jcs, jprobe, JConfig(width=w, height=h, samples_per_launch=2, max_depth=2, traversal="lockstep"),
            JCam.from_camera(cam), jnp.asarray(xs), jnp.asarray(ys), jnp.uint32(1))
    got = tspectral.trace_spectral(
        pcs, pprobe, RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=2, traversal="cluster"),
        CameraParams.from_camera(cam, CPU), torch.as_tensor(xs), torch.as_tensor(ys), 1)
    g = np.stack([c.numpy() for c in got], -1)
    wa = np.stack([np.asarray(c) for c in want], -1)
    assert np.isclose(g, wa, rtol=1e-5, atol=1e-6).all(-1).mean() >= 0.99
    np.testing.assert_allclose(g, wa, rtol=1e-4, atol=1e-5)
    assert g.max() > 0.5 and g.min() >= 0


def _eval_args():
    """tests/test_torch_probe_disney.py's BSDF inputs (seeds 30 and 31)."""
    jmt, tmt = _materials(30)
    (jn, jv, jl, jei), (tn, tv, tl, tei) = _shading_inputs(31)
    jeo = jnp.where(jei == 1.0, jmt.index_of_refraction(), 1.0)
    teo = torch.where(tei == 1.0, tmt.index_of_refraction(), 1.0)
    return (jmt, jn, jv, jl, jei, jeo), (tmt, tn, tv, tl, tei, teo)


@pytest.mark.parametrize("override", ["zero", "one", "albedo"])
def test_bsdf_eval_cspec0_override(override):
    (jmt, jn, jv, jl, jei, jeo), (tmt, tn, tv, tl, tei, teo) = _eval_args()
    pick = {"zero": (lambda v: v * 0.0), "one": (lambda v: v * 0.0 + 1.0), "albedo": (lambda v: v)}[override]
    jo, to = pick(jmt.color), pick(tmt.color)
    want = jdisney.bsdf_eval(jmt, jmt.color, jei, jeo, jn, jv, jl, cspec0_override=jo)
    got = tdisney.bsdf_eval(tmt, tmt.color, tei, teo, tn, tv, tl, cspec0_override=to)
    spreads = _ulp_spread(lambda n_, v_, l_: tuple(jdisney.bsdf_eval(jmt, jmt.color, jei, jeo, n_, v_, l_,
                                                                      cspec0_override=jo)), (jn, jv, jl))
    for a, b, sp in zip(got, want, spreads):
        _close_conditioned(a.numpy(), b, sp)


def test_bsdf_eval_without_override_is_unchanged():
    _, (tmt, tn, tv, tl, tei, teo) = _eval_args()
    plain = tdisney.bsdf_eval(tmt, tmt.color, tei, teo, tn, tv, tl)
    none = tdisney.bsdf_eval(tmt, tmt.color, tei, teo, tn, tv, tl, cspec0_override=None)
    for a, b in zip(plain, none):
        assert torch.equal(a, b)


def test_spectral_s_golden():
    got = scenes.render_preset_golden("spectral_s", CPU)
    want = np.load("tests/goldens/spectral_s.npz")["image"]
    assert got.shape == want.shape
    assert scenes.golden_rmse(got, want) <= 2e-3


def _engine_scene(boxes):
    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    for mat, pos, ext in boxes:
        hs.add_box(mat, pos=pos, extent=ext)
    return compile_scene(hs, CPU)


def _spectral_and_rgb(cs):
    probe = build_probe(np.full((16, 32, 3), 0.5, np.float32), CPU)
    cfg = RenderConfig(width=48, height=36, samples_per_launch=8, max_depth=2, traversal="cluster")
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=48 / 36)
    sr = make_spectral_renderer(cs, probe, cam, 48, 36, 8, 2, traversal="cluster")
    assert sr.config == cfg
    sr.render()
    img_s = sr.render()
    rr = Renderer(cs, probe, cfg, cam)
    rr.render_n(2)
    return img_s, rr.accum_image()


def test_spectral_render_close_to_rgb_render():
    """tests/test_spectral_engine.py: untinted diffuse, the two engines agree."""
    img_s, img_r = _spectral_and_rgb(_engine_scene([
        (make_material(color=(0.7, 0.25, 0.15)), (0, 0.5, 0), (0.5, 0.5, 0.5))]))
    assert np.isfinite(img_s).all() and img_s.min() >= -1e-3
    assert abs(img_s.mean() - img_r.mean()) / img_r.mean() < 0.15
    half = img_s.shape[0] // 2
    for sl in (slice(0, half), slice(half, None)):
        assert abs(img_s[sl].mean() - img_r[sl].mean()) / max(img_r[sl].mean(), 1e-6) < 0.25


def test_spectral_tinted_metallic_error_bound():
    """tests/test_spectral_engine.py: the joint-affine reconstruction keeps
    tinted metal and specular-tinted plastic within 3 % of the RGB engine."""
    img_s, img_r = _spectral_and_rgb(_engine_scene([
        (make_material(color=(0.9, 0.5, 0.2), metallic=1.0, roughness=0.3), (-0.7, 0.5, 0), (0.5, 0.5, 0.5)),
        (make_material(color=(0.2, 0.4, 0.9), roughness=0.2, specular=0.8, specular_tint=1.0),
         (0.8, 0.4, 0.3), (0.4, 0.4, 0.4))]))
    assert np.isfinite(img_s).all()
    assert abs(img_s.mean() - img_r.mean()) / img_r.mean() < 0.03


def test_spectral_preset():
    assert PRESETS["spectral"] is make_spectral_renderer
    cs = compile_scene(scenes.open_scene(), CPU)
    r = make_spectral_renderer(cs, scenes.sky_probe(CPU), scenes.open_camera(32, 24), 32, 24, spp=1,
                               max_depth=1, traversal="cluster")
    assert r.config.traversal == "cluster" and r.config.samples_per_launch == 1
    img = r.render()
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert r.render(download=False) is None and r.subframe_index == 2
    # the CPU default (auto_tune) is the lockstep walk, the reference's, and
    # its frame is the cluster walk's (both exact)
    r2 = make_spectral_renderer(cs, scenes.sky_probe(CPU), scenes.open_camera(32, 24), 32, 24,
                                spp=1, max_depth=1)
    assert r2.config.traversal == "lockstep"
    np.testing.assert_array_equal(r2.render(), img)
