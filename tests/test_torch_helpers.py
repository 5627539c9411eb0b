"""Port parity of the public helpers the port lacked until ROADMAP A.1's
last helper slice: `core/rng.lcg` / `rnd_step`, the device Morton path
(`bvh/morton.expand_bits_10`, `morton3d`, `popcount32`, `clz32`,
`morton_codes`), `core/math.min_component` / `max_component` / `vabs` /
`vexp` / `vsqrt`, and the keyword arguments of `normalize(a, eps)` and
`safe_normalize(a, fallback)`. Integer results are held bit for bit against
the JAX package; the Morton codes also against the port's host
`np_morton_codes`. Float helpers: bit for bit where both sides are exact (min,
max, abs, a division by a power of two); `exp` and `sqrt` within 1 ulp
(rtol 2e-7), unit vectors through `rsqrt` within 2 ulps of 1 (atol
2.4e-7): the two CPU libraries round them differently (ATen's `sqrt`
parts from the correctly rounded result, XLA's, on 32 of 6144 lanes here;
XLA's `rsqrt` is an approximation, ATen's is 1 / sqrt)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.bvh import morton as jmorton
from optixpathtracer_tpu.core import math as jm
from optixpathtracer_tpu.core import rng as jrng
from optixpathtracer_tpu_torch.bvh import morton
from optixpathtracer_tpu_torch.core import math as tm
from optixpathtracer_tpu_torch.core import rng

U32_EDGES = np.array([0, 1, 2, 3, 1023, 1024, 0x00FFFFFF, 0x01000000, 0x7FFFFFFF, 0x80000000,
                      0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32_words(n=4096, seed=0):
    w = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([U32_EDGES, w])


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_lcg_and_rnd_step_chain_bit_equal():
    """Eight chained steps from every edge word and 4096 random ones."""
    js = jnp.asarray(_u32_words())
    ts = _t(_u32_words())
    for _ in range(8):
        js, jv = jrng.rnd_step(js)
        ts, tv = rng.rnd_step(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        assert tv.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert float(tv.min()) >= 0.0 and float(tv.max()) < 1.0
    s, v = rng.lcg(_t(U32_EDGES))
    js, jv = jrng.lcg(jnp.asarray(U32_EDGES))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv).astype(np.int64))


@pytest.mark.parametrize("name", ["expand_bits_10", "popcount32", "clz32"])
def test_bit_utilities_bit_equal(name):
    x = _u32_words()
    got = getattr(morton, name)(_t(x)).numpy()
    want = np.asarray(getattr(jmorton, name)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    if name != "expand_bits_10":
        assert got.dtype == np.int32


def test_morton3d_bit_equal_with_clipping():
    """Scaled coordinates in and out of [0, 1024), fractional and whole."""
    r = np.random.default_rng(1)
    xyz = [np.concatenate([r.uniform(-50, 1100, 2048), [0.0, 0.99, 1023.0, 1023.99, 1024.0, -0.5]])
           .astype(np.float32) for _ in range(3)]
    got = morton.morton3d(*(torch.as_tensor(a) for a in xyz)).numpy()
    want = np.asarray(jmorton.morton3d(*(jnp.asarray(a) for a in xyz)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("kind", ["uniform", "dyadic", "diagonal"])
def test_morton_codes_bit_equal_to_jax_and_host(kind):
    """`morton_codes` (float32, as the JAX device path) against JAX on
    random, dyadic and diagonal centroids, and against the host's float64
    `np_morton_codes` wherever both quantise exactly: the dyadic grid and
    the diagonal (on random centroids float32 and float64 may round a
    coordinate across a cell edge, so there the host codes are held only to
    the same order of magnitude of parting: at most 1 % of the codes)."""
    r = np.random.default_rng(2)
    if kind == "uniform":
        c = r.uniform(-5, 5, (4096, 3)).astype(np.float32)
    elif kind == "dyadic":
        c = (r.integers(0, 1024, (4096, 3)) / 64.0).astype(np.float32)
        c[0], c[1] = 0.0, 1024 / 64.0  # the joint box is [0, 16]^3: every quantisation exact
    else:
        t = np.linspace(0, 1, 100, dtype=np.float32)
        c = np.stack([t, t, t], axis=1)
    cols = [c[:, k] for k in range(3)]
    got = morton.morton_codes(*(torch.as_tensor(a) for a in cols)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmorton.morton_codes(*(jnp.asarray(a) for a in cols)))
                                  .astype(np.int64))
    host = morton.np_morton_codes(c).astype(np.int64)
    if kind == "uniform":
        assert np.mean(host != got) <= 0.01
    else:
        np.testing.assert_array_equal(got, host)
    if kind == "diagonal":
        assert np.all(np.diff(got) >= 0)


def _vec(seed, n=2048, lo=-3.0, hi=3.0):
    a = np.random.default_rng(seed).uniform(lo, hi, (3, n)).astype(np.float32)
    a[:, :4] = 0.0  # zero-length lanes
    a[0, 1], a[1, 2] = 1e-17, -3e-18  # squares below the normalisers' floor, above float32's denormals
    return a, tm.Vec3(*(torch.as_tensor(v) for v in a)), jm.Vec3(*(jnp.asarray(v) for v in a))


@pytest.mark.parametrize("name", ["min_component", "max_component", "vabs", "vsqrt", "vexp"])
def test_component_helpers(name):
    a, tv, jv = _vec(3, lo=0.0 if name == "vsqrt" else -3.0)
    got, want = getattr(tm, name)(tv), getattr(jm, name)(jv)
    got = np.stack(got) if isinstance(got, tm.Vec3) else got.numpy()
    want = np.stack([np.asarray(w) for w in want]) if isinstance(want, jm.Vec3) else np.asarray(want)
    if name in ("vexp", "vsqrt"):
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("eps", [0.0, 1e-12, 0.25])
def test_normalize_eps(eps):
    a, tv, jv = _vec(4)
    got = np.stack(tm.normalize(tv, eps=eps))
    want = np.stack([np.asarray(w) for w in jm.normalize(jv, eps=eps)])
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    if eps == 0.0:
        np.testing.assert_array_equal(got, np.stack(tm.normalize(tv)))


@pytest.mark.parametrize("fallback", [None, (0.0, 1.0, 0.0)])
def test_safe_normalize_fallback(fallback):
    a, tv, jv = _vec(5)
    tf = jf = None
    if fallback is not None:
        tf = tm.Vec3(*(torch.full((a.shape[1],), f) for f in fallback))
        jf = jm.Vec3(*(jnp.full((a.shape[1],), f, jnp.float32) for f in fallback))
    got = np.stack(tm.safe_normalize(tv, fallback=tf))
    want = np.stack([np.asarray(w) for w in jm.safe_normalize(jv, fallback=jf)])
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    zero = (a == 0).all(axis=0)
    np.testing.assert_array_equal(got[:, zero], want[:, zero])
    if fallback is not None:
        assert (got[1, zero] == 1.0).all()


def test_rng_state_for_pixels_bit_equal():
    """`RngState.for_pixels` (the property tests' streams) equals the
    reference's, and its first draws too."""
    pix = np.arange(4096, dtype=np.uint32)
    for sub in (0, 7, 2**32 - 1):
        js = jrng.RngState.for_pixels(jnp.asarray(pix), sub)
        ts = rng.RngState.for_pixels(torch.as_tensor(pix.astype(np.int64)), sub)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
        _, tv = rng.randf(ts)
        _, jv = jrng.randf(js)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_public_constants_equal():
    """The public constants the port lacked beside these helpers."""
    from optixpathtracer_tpu.bvh import clusters as jclusters
    from optixpathtracer_tpu.core import materials as jmaterials
    from optixpathtracer_tpu.ops import traverse as jtraverse
    from optixpathtracer_tpu_torch.bvh import clusters
    from optixpathtracer_tpu_torch.core import materials
    from optixpathtracer_tpu_torch.ops import traverse

    assert clusters.NUM_ROWS == jclusters.NUM_ROWS
    assert materials.MATERIAL_FLAG_NONE == jmaterials.MATERIAL_FLAG_NONE
    assert traverse.ROOT_REF == jtraverse.ROOT_REF
