"""Port parity, core modules: RNG, Vec3 math, sampling warps, materials.

The same numpy inputs go through optixpathtracer_tpu (JAX, CPU) and
optixpathtracer_tpu_torch (PyTorch, CPU). Tolerances:
  * RNG: bit-exact (integer math);
  * f32 elementwise math: rtol 1e-6, atol 1e-7 (XLA and PyTorch may take
    sin/cos/sqrt a ulp apart);
  * material tables: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core import materials as jmat
from optixpathtracer_tpu.core import math as jm
from optixpathtracer_tpu.core import rng as jrng
from optixpathtracer_tpu.core import sampling as jsamp
from optixpathtracer_tpu_torch.core import materials as tmat
from optixpathtracer_tpu_torch.core import math as tm
from optixpathtracer_tpu_torch.core import rng as trng
from optixpathtracer_tpu_torch.core import sampling as tsamp

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL, ATOL = 1e-6, 1e-7


def _u32(seed, n=4096):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _vec(rng, n=1024, unit=True):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    if unit:
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    return jm.Vec3(*(jnp.asarray(a[:, i]) for i in range(3))), tm.Vec3(*(_t(a[:, i]) for i in range(3)))


def _vclose(tv, jv):
    for a, b in zip(tv, jv):
        _close(a, b)


@pytest.mark.parametrize("rounds", [1, 4, 16])
def test_tea_bit_exact(rounds):
    a, b = _u32(1), _u32(2)
    want = np.asarray(jrng.tea(jnp.asarray(a), jnp.asarray(b), rounds=rounds))
    got = trng.tea(_t(a.astype(np.int64)), _t(b.astype(np.int64)), rounds=rounds).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


def test_mul32_low_bits_exact():
    a, b = _u32(3).astype(np.uint64), _u32(4).astype(np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)
    got = trng.mul32(_t(a.astype(np.int64)), _t(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint64), want)


def test_rand_bits_and_randf_stream_bit_exact():
    seeds = _u32(5)
    js = jrng.RngState.seed(jnp.asarray(seeds))
    ts = trng.RngState.seed(_t(seeds.astype(np.int64)))
    np.testing.assert_array_equal(ts.s1.numpy().astype(np.uint32), np.asarray(js.s1))
    np.testing.assert_array_equal(ts.s2.numpy().astype(np.uint32), np.asarray(js.s2))
    for _ in range(8):  # a stream, not one step
        js, jb = jrng.rand_bits(js)
        ts, tb = trng.rand_bits(ts)
        np.testing.assert_array_equal(tb.numpy().astype(np.uint32), np.asarray(jb))
        js, jf = jrng.randf(js)
        ts, tf = trng.randf(ts)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))  # bitwise equal f32
        js, ja, jb2 = jrng.randf2(js)
        ts, ta, tb2 = trng.randf2(ts)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb2.numpy(), np.asarray(jb2))


def test_per_pixel_seeding_bit_exact():
    # the engine's seeding: Random(tea4(pixel, sample counter))
    pix = np.arange(4096, dtype=np.uint32)
    js = jrng.RngState.for_pixels(jnp.asarray(pix), 7)
    ts = trng.RngState.seed(trng.tea(_t(pix.astype(np.int64)), 7))
    np.testing.assert_array_equal(ts.s1.numpy().astype(np.uint32), np.asarray(js.s1))
    np.testing.assert_array_equal(
        trng.as_i32_bits(ts.s2).numpy().view(np.uint32), np.asarray(js.s2))


@pytest.mark.parametrize(
    "name", ["dot", "cross", "normalize", "safe_normalize", "faceforward", "luminance",
             "basis_from_vector", "refract", "local_to_world"])
def test_vec3_ops(name):
    rng = np.random.default_rng(10)
    ja, ta = _vec(rng)
    jb, tb = _vec(rng)
    jc, tc = _vec(rng, unit=False)
    if name == "dot":
        _close(tm.dot(ta, tc), jm.dot(ja, jc))
    elif name == "cross":
        _vclose(tm.cross(ta, tc), jm.cross(ja, jc))
    elif name == "normalize":
        _vclose(tm.normalize(tc), jm.normalize(jc))
    elif name == "safe_normalize":
        z = np.zeros(8, np.float32)
        _vclose(tm.safe_normalize(tm.Vec3(_t(z), _t(z), _t(z))),
                jm.safe_normalize(jm.Vec3(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z))))
        _vclose(tm.safe_normalize(tc), jm.safe_normalize(jc))
    elif name == "faceforward":
        _vclose(tm.faceforward(ta, tb, tc), jm.faceforward(ja, jb, jc))
    elif name == "luminance":
        _close(tm.luminance(tc), jm.luminance(jc))
    elif name == "basis_from_vector":
        for got, want in zip(tm.basis_from_vector(ta), jm.basis_from_vector(ja)):
            _vclose(got, want)
    elif name == "refract":
        (tw, tok), (jw, jok) = tm.refract(ta, tb, 1.0 / 1.5), jm.refract(ja, jb, 1.0 / 1.5)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        ok = np.asarray(jok)
        for a, b in zip(tw, jw):
            _close(a.numpy()[ok], np.asarray(b)[ok])
    elif name == "local_to_world":
        _vclose(tm.local_to_world(tc, ta, tb, ta), jm.local_to_world(jc, ja, jb, ja))


@pytest.mark.parametrize(
    "warp", ["uniform_sample_hemisphere", "uniform_sample_disc", "cosine_sample_hemisphere"])
def test_sampling_warps(warp):
    rng = np.random.default_rng(11)
    u1, u2 = (rng.random(4096).astype(np.float32) for _ in range(2))
    got = list(getattr(tsamp, warp)(_t(u1), _t(u2)))
    want = [np.asarray(c) for c in getattr(jsamp, warp)(jnp.asarray(u1), jnp.asarray(u2))]
    if warp == "cosine_sample_hemisphere":
        # z = sqrt(1 - x^2 - y^2) amplifies the ulp-level sin/cos difference
        # of x, y near the rim; hold z^2 to the error x, y can carry (a few
        # 1e-8 each, doubled by the squares)
        np.testing.assert_allclose(got[2].numpy() ** 2, want[2] ** 2, rtol=0, atol=3e-7)
        got, want = got[:2], want[:2]
    for a, b in zip(got, want):
        _close(a, b)


def _random_materials(seed, n=12):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(n):
        mats.append(tmat.make_material(
            color=tuple(rng.random(3)), emission=tuple(rng.random(3) * 2),
            metallic=float(rng.random()), roughness=float(rng.random()),
            transmission=float(rng.random() > 0.7), eta=float(rng.choice([0.0, 1.5])),
            subsurface=float(rng.random()), clearcoat=float(rng.random()),
            specular_tint=float(rng.random()), flags=int(rng.integers(0, 2)),
        ))
    return mats


def test_make_material_matches_reference():
    assert tmat.make_material() == jmat.make_material()
    kw = dict(color=(0.1, 0.2, 0.3), roughness=0.4, transmission=1.0, eta=1.5)
    assert tmat.make_material(**kw) == jmat.make_material(**kw)
    with pytest.raises(KeyError):
        tmat.make_material(nonsense=1.0)


def test_build_table_rows_and_fields_exact():
    mats = _random_materials(13)
    jt = jmat.build_table(mats)
    tt = tmat.build_table(mats, CPU)
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    idx = np.random.default_rng(14).integers(0, len(mats), 300)
    jg = jt.take(jnp.asarray(idx))
    tg = tt.take(_t(idx))
    for field in jmat.MaterialTable._fields:
        if field == "rows":
            continue
        a, b = getattr(tg, field), getattr(jg, field)
        if isinstance(b, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(tg.index_of_refraction(), jg.index_of_refraction())


# -- the rest of core/sampling: warps, stratified draws, MIS heuristics -------

def _uniforms(seed, n=2048):
    u = np.random.default_rng(seed).random((2, n)).astype(np.float32)
    return u[0], u[1]


@pytest.mark.parametrize("name", ["uniform_sample_sphere", "uniform_sample_triangle"])
def test_sampling_warps_match_jax(name):
    u1, u2 = _uniforms(31)
    want = getattr(jsamp, name)(jnp.asarray(u1), jnp.asarray(u2))
    got = getattr(tsamp, name)(_t(u1), _t(u2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", ["power_heuristic", "balance_heuristic"])
def test_mis_heuristics_match_jax(name):
    rng = np.random.default_rng(32)
    f_pdf, g_pdf = (rng.gamma(1.0, 2.0, 2048).astype(np.float32) for _ in range(2))
    f_pdf[:8] = 0.0  # both pdfs zero: the guarded denominator
    g_pdf[:4] = 0.0
    nf, ng = np.float32(1.0), np.float32(2.0)
    want = getattr(jsamp, name)(nf, jnp.asarray(f_pdf), ng, jnp.asarray(g_pdf))
    got = getattr(tsamp, name)(float(nf), _t(f_pdf), float(ng), _t(g_pdf))
    _close(got, want)
    assert np.isfinite(got.numpy()).all()


def _stratified_inputs(seed, n=2048):
    c = np.random.default_rng(seed).integers(0, 1 << 20, n, dtype=np.int64).astype(np.int32)
    seeds = _u32(seed + 1, n)
    return c, jrng.RngState.seed(jnp.asarray(seeds)), trng.RngState.seed(_t(seeds.astype(np.int64)))


def _same_state(ts, js):
    np.testing.assert_array_equal(ts.s1.numpy().astype(np.uint32), np.asarray(js.s1))
    np.testing.assert_array_equal(ts.s2.numpy().astype(np.uint32), np.asarray(js.s2))


def test_stratified_sample_1d_matches_jax():
    c, js, ts = _stratified_inputs(33)
    js, want = jsamp.stratified_sample_1d(jnp.asarray(c), 16, js)
    ts, got = tsamp.stratified_sample_1d(_t(c), 16, ts)
    _same_state(ts, js)  # the same draws taken from the stream
    _close(got, want)
    assert (np.floor(got.numpy() * 16) == c % 16).all()  # each sample in its stratum


def test_stratified_sample_2d_matches_jax():
    c, js, ts = _stratified_inputs(34)
    js, wx, wy = jsamp.stratified_sample_2d(jnp.asarray(c), 8, 4, js)
    ts, gx, gy = tsamp.stratified_sample_2d(_t(c), 8, 4, ts)
    _same_state(ts, js)
    _close(gx, wx)
    _close(gy, wy)


def test_uniform_grid_sample_2d_matches_jax():
    c, _, _ = _stratified_inputs(35)
    wx, wy = jsamp.uniform_grid_sample_2d(jnp.asarray(c), 8, 4)
    gx, gy = tsamp.uniform_grid_sample_2d(_t(c), 8, 4)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
