"""Port parity, the engine's `sampling=` strategies ("stratified", "blue",
"sobol") against the JAX package.

Bit-exact: `_ld_bases` (stratified and blue, at strata counts that are
powers of two and that are not, with sample counters near 2**32 so that
`ctr + off` wraps), `_sobol_pair` at several depths, and the RNG state that
`probe_sample(u12=...)` / `bsdf_sample(u12=...)` hand back (a caller pair
skips exactly the draws it replaces). The probe and BSDF outputs under a
caller pair follow tests/test_torch_probe_disney.py's tolerances. Renders:
the open golden scene at 24x16, 2 spp, depth 2, two frames per strategy,
with and without `sort_rays` + `batch_spp`, against the JAX renderer at
rtol / atol 1e-5 on the linear accumulation, as
tests/test_torch_renderer.py holds the random strategy. And Sobol through
the foveated renderer (`sample_lanes`), progressive, in the fused launch and
in three launches, against the JAX renderer (rtol / atol 1e-5) and each
other (the setup of tests/test_torch_foveated.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import foveated as jfov
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.lights import probe as jprobe
from optixpathtracer_tpu.shade import disney as jdisney
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core import math as tm
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.rng import rand_bits, randf2
from optixpathtracer_tpu_torch.engine import foveated as tfov
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.lights import probe as tprobe
from optixpathtracer_tpu_torch.shade import disney as tdisney
from tests.golden_scenes import _open_scene, _sky_probe
from tests.test_torch_foveated import _box_scene_jax
from tests.test_torch_probe_disney import (
    _close,
    _close_conditioned,
    _image,
    _materials,
    _shading_inputs,
    _states,
    _ulp_spread,
    _vclose,
    jm,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 4096
SALTS = (jwf._LD_SALT_AA, jwf._LD_SALT_NEE, jwf._LD_SALT_BSDF)


def _pix_ctr(seed, n=N):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 1200 * 800, n).astype(np.uint32)
    ctr = rng.integers(0, 64, n).astype(np.uint32)
    ctr[: n // 4] = (2**32 - 1 - rng.integers(0, 64, n // 4)).astype(np.uint32)  # wraps
    return pix, ctr


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _same_f32(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))


def test_salts_equal():
    assert (twf._LD_SALT_AA, twf._LD_SALT_NEE, twf._LD_SALT_BSDF) == SALTS


@pytest.mark.parametrize("sampling, m", [("stratified", 16), ("stratified", 9), ("stratified", 36),
                                         ("blue", 16), ("blue", 9), ("blue", 64)])
def test_ld_bases_bit_exact(sampling, m):
    pix, ctr = _pix_ctr(m)
    for salt in SALTS:
        want = jwf._ld_bases(jwf.RenderConfig(sampling=sampling, sampling_strata=m),
                             jnp.asarray(pix), jnp.asarray(ctr), salt)
        got = twf._ld_bases(twf.RenderConfig(sampling=sampling, sampling_strata=m),
                            _t(pix), _t(ctr), salt)
        _same_f32(got[0], want[0])
        _same_f32(got[1], want[1])
        assert got[2] == want[2]


def test_blue_noise_table_equal():
    for m in (9, 16):
        _same_f32(twf._blue_noise_table(m), jwf._blue_noise_table(m))


@pytest.mark.parametrize("depth", [0, 1, 3, 7, 100000])  # large: depth * 0x9E3779B9 wraps
def test_sobol_pair_bit_exact(depth):
    pix, ctr = _pix_ctr(depth + 100)
    for salt in SALTS:
        want = jwf._sobol_pair(jnp.asarray(pix), jnp.asarray(ctr), jnp.uint32(depth), salt)
        got = twf._sobol_pair(_t(pix), _t(ctr), depth, salt)
        _same_f32(got[0], want[0])
        _same_f32(got[1], want[1])


def test_bad_strategy_and_nonsquare_strata_raise():
    pix = torch.zeros((4,), dtype=torch.int64)
    with pytest.raises(ValueError):
        twf._ld_bases(twf.RenderConfig(sampling="halton"), pix, pix, 1)
    with pytest.raises(ValueError):
        twf._ld_bases(twf.RenderConfig(sampling="stratified", sampling_strata=12), pix, pix, 1)
    cs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(_jax_scene()), CPU)
    for kw in (dict(sampling="halton"), dict(sampling="stratified", sampling_strata=12)):
        r = Renderer(cs, tprobe.build_probe(_image("sky"), CPU),
                     twf.RenderConfig(width=16, height=8, traversal="cluster", **kw),
                     Camera(aspect_ratio=2.0, **VIEW))
        with pytest.raises(ValueError):
            r.render()


def _u12(seed, n=N):
    u = np.random.default_rng(seed).random((2, n)).astype(np.float32)
    return (jnp.asarray(u[0]), jnp.asarray(u[1])), (torch.as_tensor(u[0]), torch.as_tensor(u[1]))


def test_probe_sample_with_u12_does_not_advance_the_state():
    img = _image("sky")
    jp, tp = jprobe.build_probe(img), tprobe.build_probe(img, CPU)
    js, ts = _states(51)
    ju, tu = _u12(52)
    js2, jd, jc, jpdf, jrow, jcol = jprobe.probe_sample_texel(jp, js, u12=ju)
    ts2, td, tc, tpdf, trow, tcol = tprobe.probe_sample_texel(tp, ts, u12=tu)
    assert ts2 is ts and js2 is js
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    _vclose(td, jd)
    _vclose(tc, jc)
    _close(tpdf, jpdf)
    # the pair the stream would have drawn gives the stream's own sample
    adv, r1, r2 = randf2(ts)
    plain = tprobe.probe_sample(tp, ts)
    via = tprobe.probe_sample(tp, ts, u12=(r1, r2))
    for a, b in zip((*plain[1], *plain[2], plain[3]), (*via[1], *via[2], via[3])):
        assert torch.equal(a, b)
    assert torch.equal(plain[0].s1, adv.s1) and torch.equal(plain[0].s2, adv.s2)


def test_bsdf_sample_with_u12_skips_only_the_direction_draws():
    jmt, tmt = _materials(60)
    (jn, jv, _, jei), (tn, tv, _, tei) = _shading_inputs(61)
    jeo = jnp.where(jei == 1.0, jmt.index_of_refraction(), 1.0)
    teo = torch.where(tei == 1.0, tmt.index_of_refraction(), 1.0)
    ju, jb = jm.basis_from_vector(jn)
    tu, tb = tm.basis_from_vector(tn)
    js, ts = _states(62)
    jpair, tpair = _u12(63)
    js2, jr = jdisney.bsdf_sample(jmt, jei, jeo, ju, jb, jn, jv, js, u12=jpair)
    ts2, tr = tdisney.bsdf_sample(tmt, tei, teo, tu, tb, tn, tv, ts, u12=tpair)
    # four draws (u_lobe, u_f, u_half, u_ss) advance the state, not six
    four = ts
    for _ in range(4):
        four, _ = rand_bits(four)
    assert torch.equal(ts2.s1, four.s1) and torch.equal(ts2.s2, four.s2)
    np.testing.assert_array_equal(ts2.s1.numpy().astype(np.uint32), np.asarray(js2.s1))
    np.testing.assert_array_equal(tr.event.numpy(), np.asarray(jr.event))

    def sample(n, v):
        u, b = jm.basis_from_vector(n)
        res = jdisney.bsdf_sample(jmt, jei, jeo, u, b, n, v, js, u12=jpair)[1]
        return (*res.light, res.pdf)

    for a, b, sp in zip((*tr.light, tr.pdf), (*jr.light, jr.pdf), _ulp_spread(sample, (jn, jv))):
        _close_conditioned(a, b, sp)


W, H = 24, 16
VIEW = dict(eye=(3.2, 2.2, 4.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45)


def _jax_scene():
    return jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)


@pytest.mark.parametrize("flags", [{}, dict(sort_rays=True, batch_spp=True)], ids=["plain", "sort_batch"])
@pytest.mark.parametrize("sampling, m", [("stratified", 9), ("blue", 16), ("sobol", 64)])
def test_render_matches_jax(sampling, m, flags):
    cfg = dict(width=W, height=H, samples_per_launch=2, max_depth=2, sampling=sampling,
               sampling_strata=m, **flags)
    jcs = _jax_scene()
    jr = JaxRenderer(jcs, _sky_probe(), jwf.RenderConfig(traversal="lockstep", **cfg),
                     JaxCamera(aspect_ratio=W / H, **VIEW))
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    pr = Renderer(pcs, probe, twf.RenderConfig(traversal="cluster", **cfg),
                  Camera(aspect_ratio=W / H, **VIEW))
    jr.render_n(2)
    pr.render_n(2)
    got, want = pr.accum_image(), jr.accum_image()
    assert got.shape == want.shape == (H, W, 3) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a few lanes' later bounces may branch apart on one-ulp shading
    # differences (the random strategy does so too), so the rays agree to 1 %
    assert int(pr.last_output.rays_traced) == pytest.approx(float(jr._last.rays_traced), rel=0.01)


def test_sobol_flows_through_the_foveated_renderer():
    jcs, jp, cam = _box_scene_jax()
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pp = interop.probe_from_arrays(interop.probe_arrays(jp), CPU)
    flags = dict(width=48, height=32, max_depth=2, antialias=False, batch_spp=True, sort_rays=True,
                 sampling="sobol", russian_roulette=True)
    fov = dict(inner_radius=8, outer_radius=16, progressive=True)
    images = {}
    for fused in (False, True):
        jr = jfov.FoveatedRenderer(jcs, jp, jwf.RenderConfig(traversal="lockstep", **flags), cam,
                                   jfov.FoveationConfig(**fov), fused=fused)
        pr = tfov.FoveatedRenderer(pcs, pp, twf.RenderConfig(traversal="cluster", **flags), cam,
                                   tfov.FoveationConfig(**fov), fused=fused)
        for r in (jr, pr):
            r.set_gaze(20, 12)
            for _ in range(2):
                r.render()
        np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
        assert pr.last_rays == pytest.approx(jr.last_rays, rel=0.01)
        images[fused] = pr.accum_image()
    np.testing.assert_allclose(images[True], images[False], rtol=1e-5, atol=1e-5)
