"""Port parity, the binary LBVH (tests/test_bvh.py's cases): `bvh/lbvh.py`
and `bvh/morton.py` of the port against the JAX package on the same
numpy-seeded triangles. The Morton codes, the Karras tree, its levels and
the refit are integer or exact float32 min/max arithmetic, so every array
is held bit for bit, on the native C++ builder and on the numpy path
(OPTIX_TPU_NO_NATIVE=1) alike.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optixpathtracer_tpu.bvh import lbvh as jlbvh
from optixpathtracer_tpu.bvh import morton as jmorton
from optixpathtracer_tpu_torch.bvh import lbvh, morton

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reference_native():
    from tests.torch_backend_cases import reference_native_libs

    reference_native_libs()


@pytest.fixture(params=["native", "numpy"])
def builder(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    return request.param


def _random_tris(rng, n, scale=1.0):
    c = rng.random((n, 3), dtype=np.float32) * scale
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05 * scale
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.05 * scale
    return c, c + e1, c + e2


def _validate_tree(left, right, num_leaves):
    """Every leaf reachable exactly once; children form a proper binary tree."""
    if num_leaves == 1:
        return
    seen_leaves, seen_nodes, stack = [], set(), [0]
    while stack:
        node = stack.pop()
        assert node not in seen_nodes, "internal node visited twice"
        seen_nodes.add(node)
        for c in (left[node], right[node]):
            if c < 0:
                seen_leaves.append(-(c + 1))
            else:
                stack.append(int(c))
    assert sorted(seen_leaves) == list(range(num_leaves))
    assert len(seen_nodes) == num_leaves - 1


def _assert_same_build(got, want):
    """Port BuildResult (tensors on the CPU) == JAX BuildResult, bit for bit."""
    np.testing.assert_array_equal(got.order, want.order)
    assert got.padded_count == want.padded_count and got.depth == want.depth
    b, jb = got.bvh, want.bvh
    assert b.leaf_size == jb.leaf_size and b.num_leaves == jb.num_leaves
    np.testing.assert_array_equal(b.child_left.numpy(), np.asarray(jb.child_left))
    np.testing.assert_array_equal(b.child_right.numpy(), np.asarray(jb.child_right))
    for name in ("left_min", "left_max", "right_min", "right_max"):
        for c, jc in zip(getattr(b, name), getattr(jb, name)):
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc), err_msg=name)
    for k, v in got.host.items():
        np.testing.assert_array_equal(v, want.host[k], err_msg=k)


def test_clz32_matches_reference(rng):
    x = np.concatenate([np.array([0, 1, 2, 0x80000000, 0xFFFFFFFF, 0x00010000], np.uint32),
                        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    got = morton.np_clz32(x)
    np.testing.assert_array_equal(got[:6], [32, 31, 30, 0, 0, 15])
    np.testing.assert_array_equal(got, jmorton.np_clz32(x))
    np.testing.assert_array_equal(got, np.asarray(jmorton.clz32(jnp.asarray(x))))


def test_morton_codes_match_reference(rng):
    """The port's host Morton codes equal the JAX package's numpy and jnp
    codes, and sort monotonically along a diagonal."""
    ctr = rng.uniform(-5, 5, (4096, 3))
    np.testing.assert_array_equal(morton.np_morton_codes(ctr), jmorton.np_morton_codes(ctr))
    t = np.linspace(0, 1, 100, dtype=np.float32)
    diag = np.stack([t, t, t], axis=1)
    codes = morton.np_morton_codes(diag)
    assert np.all(np.diff(codes.astype(np.int64)) >= 0)
    want = np.asarray(jmorton.morton_codes(*(jnp.asarray(diag[:, k]) for k in range(3))))
    np.testing.assert_array_equal(codes, want)


@pytest.mark.parametrize("n", [5, 16, 33, 200, 1000])
def test_karras_tree_topology(rng, builder, n):
    v0, v1, v2 = _random_tris(rng, n)
    got = lbvh.build_bvh(v0, v1, v2, leaf_size=4, device=CPU)
    _assert_same_build(got, jlbvh.build_bvh(v0, v1, v2, leaf_size=4))
    _validate_tree(got.host["left"], got.host["right"], got.bvh.num_leaves)


def test_refit_parent_contains_children(rng, builder):
    v0, v1, v2 = _random_tris(rng, 300)
    res = lbvh.build_bvh(v0, v1, v2, leaf_size=4, device=CPU)
    _assert_same_build(res, jlbvh.build_bvh(v0, v1, v2, leaf_size=4))
    h = res.host
    lmin, lmax, rmin, rmax = h["lmin"], h["lmax"], h["rmin"], h["rmax"]
    root_min = np.minimum(lmin[0], rmin[0])
    root_max = np.maximum(lmax[0], rmax[0])
    allv = np.concatenate([v0, v1, v2])
    assert np.all(allv >= root_min) and np.all(allv <= root_max)
    for node in range(res.bvh.num_internal):
        for child, cmin, cmax in ((h["left"][node], lmin[node], lmax[node]),
                                  (h["right"][node], rmin[node], rmax[node])):
            if child >= 0:  # exact refit: the stored box is the union of the child's
                np.testing.assert_array_equal(np.minimum(lmin[child], rmin[child]), cmin)
                np.testing.assert_array_equal(np.maximum(lmax[child], rmax[child]), cmax)


def test_single_leaf_scene(rng, builder):
    v0, v1, v2 = _random_tris(rng, 3)
    res = lbvh.build_bvh(v0, v1, v2, leaf_size=4, device=CPU)
    assert res.bvh.num_internal == 1 and res.padded_count == 4
    _assert_same_build(res, jlbvh.build_bvh(v0, v1, v2, leaf_size=4))
    assert np.all(np.isinf(res.host["rmin"]))  # the duplicate right child is empty


def test_equal_morton_codes_tie_break_by_index(rng, builder):
    """Coincident centroids: `_np_delta` falls back to index bits, as the
    reference's does, and the tree stays within the lockstep stack."""
    c = np.repeat(rng.uniform(-1, 1, (7, 3)).astype(np.float32), 37, axis=0)
    e = rng.normal(0, 0.01, c.shape).astype(np.float32)
    v0, v1, v2 = c, c + e, c - e
    codes = morton.np_morton_codes((v0.astype(np.float64) + v1 + v2) / 3.0)
    i = np.arange(len(codes) - 1)
    srt = np.sort(codes)
    np.testing.assert_array_equal(lbvh._np_delta(srt, i, i + 1, len(srt)),
                                  jlbvh._np_delta(srt, i, i + 1, len(srt)))
    res = lbvh.build_bvh(v0, v1, v2, leaf_size=2, device=CPU)
    _assert_same_build(res, jlbvh.build_bvh(v0, v1, v2, leaf_size=2))
    assert res.depth + 1 <= lbvh.TRAVERSAL_STACK_DEPTH


def test_tree_deeper_than_the_stack_raises(monkeypatch):
    """The depth assert of the reference: a tree that cannot fit the
    lockstep stack is refused at build time."""
    v = np.zeros((64, 3), np.float32)
    v[:, 0] = np.arange(64, dtype=np.float32)
    monkeypatch.setattr(lbvh, "TRAVERSAL_STACK_DEPTH", 4)
    with pytest.raises(ValueError, match="exceeds the lockstep traversal stack"):
        lbvh.build_bvh(v, v + 0.1, v + 0.2, leaf_size=1, device=CPU)
