"""Port parity, core/sobol and core/sampling's blue-noise tables.

Every `core/sobol` function is bit-exact against the JAX package on the
same numpy-seeded uint32 inputs, the edges 0, 1, 2**31 - 1, 2**31 and
2**32 - 1 included; both blue-noise tables are bit-equal for several
(m, seed). The port's byte-table formulation of the bit reversal and the
second dimension is held against the reference's shift ladder and 32-step
XOR this way. Then the properties tests/test_sobol.py pins, on the port's
own functions: the (0,2)-net property under shuffle and scramble, the
scramble as a dyadic tree permutation, and marginal uniformity over seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core import sampling as jsampling
from optixpathtracer_tpu.core import sobol as jsobol
from optixpathtracer_tpu_torch.core import sampling as tsampling
from optixpathtracer_tpu_torch.core import sobol as tsobol

torch.set_num_threads(1)
EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)


def _u32(n, seed):
    """n numpy-seeded uint32 words with the edges first."""
    x = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[:EDGES.size] = EDGES
    return x


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _bits(a):
    """uint32 (JAX) or int64-held uint32 (port) as int64 numpy."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64)


def test_direction_numbers_equal():
    np.testing.assert_array_equal(tsobol._dim2_directions(), jsobol._dim2_directions())
    np.testing.assert_array_equal(tsobol._V2, jsobol._V2)


@pytest.mark.parametrize("name", ["reverse_bits32", "_sobol_dim2"])
def test_unary_functions_bit_exact(name):
    x = _u32(1 << 16, 0)
    want = getattr(jsobol, name)(jnp.asarray(x))
    got = getattr(tsobol, name)(_t(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["_laine_karras", "nested_uniform_scramble"])
def test_scrambles_bit_exact(name):
    x, s = _u32(1 << 16, 1), _u32(1 << 16, 2)[::-1].copy()  # edges on both operands
    want = getattr(jsobol, name)(jnp.asarray(x), jnp.asarray(s))
    got = getattr(tsobol, name)(_t(x), _t(s))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_u32_to_unit_bit_exact_and_clamped():
    x = _u32(1 << 16, 3)
    want = np.asarray(jsobol._u32_to_unit(jnp.asarray(x)))
    got = tsobol._u32_to_unit(_t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[EDGES.size - 1] == np.float32(0.999999)  # 0xFFFFFFFF rounds up to 2**32
    assert got[0] == 0.0 and got.max() < 1.0


@pytest.mark.parametrize("fn", ["sobol02_bits", "sobol02_point"])
def test_sobol02_bit_exact(fn):
    args = [_u32(1 << 15, s) for s in (4, 5, 6, 7)]
    want = getattr(jsobol, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(tsobol, fn)(*(_t(a) for a in args))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if fn == "sobol02_point":
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.parametrize("fn", ["best_candidate_blue_noise", "projective_blue_noise"])
@pytest.mark.parametrize("m, seed", [(16, 0), (9, 7), (36, 3), (64, 7)])
def test_blue_noise_tables_bit_equal(fn, m, seed):
    for kw in ({}, dict(candidates=24)):
        want = getattr(jsampling, fn)(m, seed=seed, **kw)
        got = getattr(tsampling, fn)(m, seed=seed, **kw)
        assert got.dtype == want.dtype == np.float32 and got.shape == (m, 2)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_nested_uniform_scramble_is_dyadic_tree_permutation():
    n = 1 << 10
    x = torch.arange(n, dtype=torch.int64)
    y = tsobol.nested_uniform_scramble(x << 22, 0xDEADBEEF).numpy() >> 22
    assert sorted(y.tolist()) == list(range(n))  # a permutation
    for k in (2, 5, 8):
        blocks = y.reshape(-1, 1 << k) >> k
        assert (blocks == blocks[:, :1]).all(), f"block size 2^{k} not aligned"


@pytest.mark.parametrize("seed", [0, 3, 987654321])
@pytest.mark.parametrize("k", [4, 8])
def test_02_net_property_survives_shuffle_and_scramble(seed, k):
    n = 1 << k
    idx = torch.arange(n, dtype=torch.int64)
    s = torch.full((n,), seed, dtype=torch.int64)
    x, y = (v.numpy() for v in tsobol.sobol02_point(idx, s, s + 101, s + 777))
    for a in range(k + 1):
        b = k - a
        cells = (x * (1 << a)).astype(int) * (1 << b) + (y * (1 << b)).astype(int)
        assert len(np.unique(cells)) == n, f"partition 2^{a}x2^{b}"


def test_scramble_marginally_uniform_over_seeds():
    seeds = _t(np.random.default_rng(1).integers(0, 2**32, 4000, dtype=np.uint64))
    idx = torch.full((4000,), 9, dtype=torch.int64)
    x, y = tsobol.sobol02_point(idx, seeds, seeds ^ 0x9E37, (seeds * 3) & 0xFFFFFFFF)
    for v in (x.numpy(), y.numpy()):
        assert abs(v.mean() - 0.5) < 0.02
        assert ((v >= 0) & (v < 1)).all()
