"""Port parity, the lockstep walk and its primitive tests (the cases of
tests/test_traverse.py): `ops/traverse.py` and `ops/intersect.py` against
the JAX package on the same numpy-seeded soups and rays.

`tri` is held bit for bit everywhere. The JAX walk runs compiled inside
`lax.while_loop`, where XLA fuses the Möller–Trumbore arithmetic (the C.5 /
C.8 mechanism: a few ulps of the operands, more on u/v of ill-conditioned
triangles), so against it t/u/v are held to the reference tests' own
tolerances (tests/torch_backend_cases.py); against the same JAX walk run
eagerly (`jax.disable_jit()`: one rounding per operation, as the port)
they are held bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.ops import intersect as jint
from optixpathtracer_tpu.ops import traverse as jtr
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import intersect as tint
from optixpathtracer_tpu_torch.ops import traverse as ttr
from tests.torch_backend_cases import CPU, assert_records_equal, compiled, rays, soup


def test_closest_hit_matches_reference_and_brute_force(rng):
    pcs, jcs = compiled(soup(rng), leaf_size=4)
    (o, d), (jo, jd) = rays(rng, 256)
    got = ttr.closest_hit(pcs.bvh, pcs.scene, o, d, 1e-3, 1e16)
    want = jtr.closest_hit(jcs.bvh, jcs.scene, jo, jd, 1e-3, 1e16)
    assert_records_equal(got, want, exact_floats=False)
    with jax.disable_jit():
        assert_records_equal(got, jtr.closest_hit(jcs.bvh, jcs.scene, jo, jd, 1e-3, 1e16))
    bf = ttr.brute_force_closest_hit(pcs.scene, o, d, 1e-3, 1e16)
    with jax.disable_jit():
        assert_records_equal(bf, jtr.brute_force_closest_hit(jcs.scene, jo, jd, 1e-3, 1e16))
    hits = got.hit.numpy()
    np.testing.assert_array_equal(hits, bf.t.numpy() < ttr.BIG_T)
    np.testing.assert_array_equal(got.t.numpy()[hits], bf.t.numpy()[hits])
    assert 0.2 < hits.mean() < 1.0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_closest_hit_various_leaf_sizes(rng, k):
    pair = soup(rng, n_tris=77)
    (o, d), (jo, jd) = rays(rng, 128)
    pcs, jcs = compiled(pair, leaf_size=k)
    got = ttr.closest_hit(pcs.bvh, pcs.scene, o, d)
    assert_records_equal(got, jtr.closest_hit(jcs.bvh, jcs.scene, jo, jd), exact_floats=False)
    base, _ = compiled(pair, leaf_size=4)
    ref = ttr.closest_hit(base.bvh, base.scene, o, d)
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-6)


def test_any_hit_consistent_with_closest_and_reference(rng):
    pcs, jcs = compiled(soup(rng), leaf_size=4)
    (o, d), (jo, jd) = rays(rng, 256)
    occ = ttr.any_hit(pcs.bvh, pcs.scene, o, d, 1e-3, 1e16).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jtr.any_hit(jcs.bvh, jcs.scene, jo, jd, 1e-3, 1e16)))
    np.testing.assert_array_equal(occ, ttr.closest_hit(pcs.bvh, pcs.scene, o, d, 1e-3, 1e16).hit.numpy())


def test_tmax_respected(rng):
    pcs, jcs = compiled(soup(rng), leaf_size=4)
    (o, d), (jo, jd) = rays(rng, 256)
    t_full = ttr.closest_hit(pcs.bvh, pcs.scene, o, d).t.numpy()
    lim = np.where(t_full < ttr.BIG_T, t_full * 0.5, 1e16).astype(np.float32)
    cut = ttr.closest_hit(pcs.bvh, pcs.scene, o, d, 1e-3, torch.as_tensor(lim))
    assert not np.any(cut.hit.numpy() & (t_full < 1e15))
    want = jtr.closest_hit(jcs.bvh, jcs.scene, jo, jd, 1e-3, jnp.asarray(lim))
    assert_records_equal(cut, want, exact_floats=False)


def test_miss_keeps_t_max_and_check_every_changes_nothing(rng, monkeypatch):
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.materials import make_material
    from optixpathtracer_tpu_torch.core.scene import HostScene

    hs = HostScene()
    hs.add_box(make_material(), pos=(0, 0, 0), extent=(1, 1, 1))
    cs = compile_scene(hs, CPU)
    rec = ttr.closest_hit(cs.bvh, cs.scene, Vec3(*(torch.tensor([c]) for c in (10.0, 10.0, 10.0))),
                          Vec3(*(torch.tensor([c]) for c in (1.0, 0.0, 0.0))))
    assert not bool(rec.hit[0]) and float(rec.t[0]) >= 1e15
    # the loop condition read every k iterations: the same bits
    pcs, _ = compiled(soup(rng), leaf_size=4)
    (o, d), _ = rays(rng, 300)
    recs = []
    for k in (1, 7):
        monkeypatch.setattr(ttr, "CHECK_EVERY", k)
        recs.append(ttr.closest_hit(pcs.bvh, pcs.scene, o, d))
    a, b = recs
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())


def test_intersect_primitives_match_reference(rng):
    """ray_triangle, ray_aabb and ray_sphere bit for bit against the
    reference's eager functions."""
    n = 4096
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    o, d, a, b, c, r = f(n, 3), f(n, 3), f(n, 3), f(n, 3), f(n, 3), np.abs(f(n)) + 0.1
    tmin, tmax = np.full(n, 1e-3, np.float32), np.abs(f(n)) * 4
    P = lambda x: Vec3(*(torch.as_tensor(x[:, k]) for k in range(3)))  # noqa: E731
    J = lambda x: JVec3(*(jnp.asarray(x[:, k]) for k in range(3)))  # noqa: E731
    T = torch.as_tensor
    got = tint.ray_triangle(P(o), P(d), P(a), P(b), P(c), T(tmin), T(tmax))
    want = jint.ray_triangle(J(o), J(d), J(a), J(b), J(c), jnp.asarray(tmin), jnp.asarray(tmax))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert 0 < got[0].numpy().mean() < 1
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    inv = 1.0 / np.where(np.abs(d) > 1e-20, d, 1e-20)
    np.testing.assert_array_equal(
        tint.ray_aabb(P(o), P(inv), P(lo), P(hi), T(tmin), T(tmax)).numpy(),
        np.asarray(jint.ray_aabb(J(o), J(inv), J(lo), J(hi), jnp.asarray(tmin), jnp.asarray(tmax))))
    got = tint.ray_sphere(P(o), P(d), P(c), T(r), T(tmin), T(tmax))
    want = jint.ray_sphere(J(o), J(d), J(c), jnp.asarray(r), jnp.asarray(tmin), jnp.asarray(tmax))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    # rsqrt is XLA's there and torch's here, a few ulps apart: t to rtol
    # 1e-5 (atol 1e-6 where its roots cancel); the normals, differences of
    # operands up to ~4, to atol 1e-5
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=1e-6)
    for x, y in zip(got[2:], want[2:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)
