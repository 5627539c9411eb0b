"""Port parity, the native acceleration-structure builders (the cases of
tests/test_accel_native.py): `bvh/native.py`, the port's ctypes loader of
its own copy of the C++ source (`csrc/host/accel.cpp`), against the port's
numpy builders and against the JAX package's native library. Both packages
compile the same source with the same command (`g++ -O2 -shared -fPIC`), so
even `treelet_order`, whose intra-partition order numpy leaves unspecified,
is held bit for bit against the reference's native order; against numpy it
keeps the contract (cluster radius within 10 %).
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.bvh import native as jnative
from optixpathtracer_tpu_torch.bvh import native
from optixpathtracer_tpu_torch.bvh.clusters import SUPER, _cluster_tables_np, treelet_order
from optixpathtracer_tpu_torch.bvh.lbvh import _np_karras_tree, _np_levels, _np_refit
from optixpathtracer_tpu_torch.bvh.morton import np_morton_codes
from optixpathtracer_tpu_torch.bvh.wide import collapse
from optixpathtracer_tpu_torch.utils import host_build

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reference_native():
    from tests.torch_backend_cases import reference_native_libs

    reference_native_libs()


def _random_tris(n, seed, dupes=False):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-20, 20, (n, 3))
    if dupes:  # coincident centroids exercise the Morton/Karras tie-breaks
        k = max(1, n // 8)
        ctr[rng.integers(0, n, k)] = ctr[rng.integers(0, n, k)]
    e1 = rng.normal(0, 0.5, (n, 3))
    e2 = rng.normal(0, 0.5, (n, 3))
    v0 = (ctr - (e1 + e2) / 3).astype(np.float32)
    return v0, (v0 + e1).astype(np.float32), (v0 + e2).astype(np.float32)


def _np_binary(v0, v1, v2, leaf_size):
    """The port's numpy lbvh.build_bvh host stage, stage by stage."""
    t = v0.shape[0]
    pad_to = max(leaf_size, ((t + leaf_size - 1) // leaf_size) * leaf_size)
    codes = np_morton_codes((v0.astype(np.float64) + v1 + v2) / 3.0)
    order = np.argsort(codes, kind="stable")
    if pad_to > t:
        order = np.concatenate([order, np.repeat(order[-1:], pad_to - t)])
    num_leaves = pad_to // leaf_size
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    lf_min = tri_min[order].reshape(num_leaves, leaf_size, 3).min(axis=1)
    lf_max = tri_max[order].reshape(num_leaves, leaf_size, 3).max(axis=1)
    left, right = _np_karras_tree(codes[order][::leaf_size].copy())
    level, depth = _np_levels(left, right)
    lmin, lmax, rmin, rmax = _np_refit(left, right, lf_min.astype(np.float32),
                                       lf_max.astype(np.float32), level)
    return dict(order=order, left=left, right=right, lmin=lmin, lmax=lmax, rmin=rmin,
                rmax=rmax, depth=depth)


def test_library_builds_from_the_port_sources():
    """The port's library comes from csrc/host/accel.cpp into _build/,
    keyed by the source and flags, and the switch turns it off."""
    assert native.get_lib() is not None
    so = [p.name for p in host_build.BUILD_DIR.glob("libaccel-*.so")]
    assert so and (host_build.SRC_DIR / "accel.cpp").exists()
    assert host_build.GXX_FLAGS == ("-O2", "-shared", "-fPIC")


@pytest.mark.parametrize("n,seed,dupes", [
    (1, 0, False), (3, 1, False), (4, 2, False), (97, 3, False),
    (1000, 4, False), (1000, 5, True), (4096, 6, True),
])
def test_build_binary_bit_exact(n, seed, dupes):
    v0, v1, v2 = _random_tris(n, seed, dupes)
    ref = _np_binary(v0, v1, v2, leaf_size=4)
    nat = native.build_binary(v0, v1, v2, leaf_size=4)
    jnat = jnative.build_binary(v0, v1, v2, leaf_size=4)
    for k in ("order", "left", "right", "lmin", "lmax", "rmin", "rmax", "level"):
        if k != "level":
            np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(nat[k], jnat[k], err_msg=k)
    assert nat["depth"] == ref["depth"] == jnat["depth"]


@pytest.mark.parametrize("n,seed,width", [
    (40, 0, 8), (1000, 1, 8), (1000, 2, 4), (4096, 3, 8), (8, 4, 8),
])
def test_wide_collapse_bit_exact(n, seed, width):
    v0, v1, v2 = _random_tris(n, seed, dupes=True)
    ref = _np_binary(v0, v1, v2, leaf_size=4)
    args = (ref["left"], ref["right"], ref["lmin"], ref["lmax"], ref["rmin"], ref["rmax"],
            len(ref["left"]) + 1, width)
    bbox_ref, refs_ref, depth_ref = collapse(*args)
    bbox, refs, depth = native.wide_collapse(*args)
    jbbox, jrefs, jdepth = jnative.wide_collapse(*args)
    assert depth == depth_ref == jdepth
    np.testing.assert_array_equal(refs, refs_ref)
    np.testing.assert_array_equal(bbox, bbox_ref)
    np.testing.assert_array_equal(refs, jrefs)
    np.testing.assert_array_equal(bbox, jbbox)


def _cluster_radii(ctr, order, c):
    n = len(order) // c * c
    grouped = ctr[order[:n]].reshape(-1, c, 3)
    half = (grouped.max(axis=1) - grouped.min(axis=1)) / 2
    return np.sqrt((half * half).sum(axis=1))


@pytest.mark.parametrize("n,seed", [(1000, 0), (5000, 1), (130, 2)])
def test_treelet_order_contract(n, seed, monkeypatch):
    """A permutation whose aligned cluster runs are as tight as the numpy
    builder's (mean bounding radius within 10 %)."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-30, 30, (n, 3))
    ctr[: n // 4, 1] *= 0.01  # a flattened slab region like the city ground
    c = 64
    nat = native.treelet_order(ctr, c, SUPER)
    assert sorted(nat.tolist()) == list(range(n))
    np.testing.assert_array_equal(treelet_order(ctr, c), nat)  # native by default
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    ref = treelet_order(ctr, c)
    assert native.treelet_order(ctr, c, SUPER) is None
    assert _cluster_radii(ctr, nat, c).mean() <= _cluster_radii(ctr, ref, c).mean() * 1.10


@pytest.mark.parametrize("n,seed,c", [(1000, 0, 128), (5000, 1, 64), (130, 2, 64),
                                      (150_000, 3, 256)])
def test_treelet_order_equals_reference_native(n, seed, c):
    """The port's native order is the JAX package's native order, bit for
    bit (the same C++ source and flags), on the city's scale too."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-30, 30, (n, 3))
    ctr[: n // 4, 1] *= 0.01
    ctr[rng.integers(0, n, n // 10)] = ctr[rng.integers(0, n, n // 10)]  # equal centroids
    np.testing.assert_array_equal(native.treelet_order(ctr, c, SUPER),
                                  jnative.treelet_order(ctr, c, SUPER))


@pytest.mark.parametrize("n,seed,c", [(1, 0, 128), (130, 1, 64), (1000, 2, 128),
                                      (1100, 3, 128)])
def test_cluster_tables_bit_exact(n, seed, c):
    v0, v1, v2 = _random_tris(n, seed)
    ref = _cluster_tables_np(v0, v1, v2, n, c)
    nat = native.cluster_tables(v0, v1, v2, n, c)
    jnat = jnative.cluster_tables(v0, v1, v2, n, c)
    for k in ("rows", "spheres", "super_spheres", "scene_aabb", "local_aabb"):
        np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(nat[k], jnat[k], err_msg=k)


def test_cluster_tables_num_real_below_input():
    """num_real < len(input): the tail becomes degenerate padding."""
    v0, v1, v2 = _random_tris(300, 7)
    ref = _cluster_tables_np(v0, v1, v2, 257, 64)
    nat = native.cluster_tables(v0, v1, v2, 257, 64)
    for k in ("rows", "spheres", "super_spheres", "scene_aabb"):
        np.testing.assert_array_equal(nat[k], ref[k], err_msg=k)


def test_end_to_end_compile_scene_native_matches_numpy(monkeypatch):
    """compile_scene on the native builder and on numpy: the same LBVH, wide
    BVH and shading soup, and the same lockstep hits on random rays; the
    clusters differ only in their order (the treelet contract)."""
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.materials import make_material
    from optixpathtracer_tpu_torch.core.math import Vec3
    from optixpathtracer_tpu_torch.core.scene import HostScene
    from optixpathtracer_tpu_torch.ops.traverse import closest_hit

    def build():
        hs = HostScene()
        rng = np.random.default_rng(11)
        for _ in range(12):
            hs.add_box(make_material(color=(0.7, 0.7, 0.7)), rng.uniform(-4, 4, 3), (0.8, 1.2, 0.6))
        return compile_scene(hs, CPU)

    cs_nat = build()
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    cs_np = build()
    np.testing.assert_array_equal(cs_nat.scene.shade_rows.numpy(), cs_np.scene.shade_rows.numpy())
    np.testing.assert_array_equal(cs_nat.wide.table.numpy().view(np.uint32),
                                  cs_np.wide.table.numpy().view(np.uint32))
    rng = np.random.default_rng(12)
    o = rng.uniform(-6, 6, (256, 3)).astype(np.float32)
    d = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ov, dv = (Vec3(*(torch.as_tensor(a[:, k]) for k in range(3))) for a in (o, d))
    a, b = closest_hit(cs_nat.bvh, cs_nat.scene, ov, dv), closest_hit(cs_np.bvh, cs_np.scene, ov, dv)
    np.testing.assert_array_equal(a.tri.numpy(), b.tri.numpy())
    np.testing.assert_array_equal(a.t.numpy(), b.t.numpy())
