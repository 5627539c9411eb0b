"""Port parity, the BFS walk over the wide BVH (the cases of
tests/test_traverse_bfs.py): `ops/traverse_bfs.py` against the JAX package
on the same numpy-seeded soups and rays. The JAX BFS runs eagerly (no jit),
one rounding per operation as the port, so where `overflow == 0` the
records are held bit for bit; the overflow counts are held equal at every
capacity, and the results where the worklist truncates too. The rays aim
at the soup, so the exact cases take cap_factor 32 (the reference's tests
shoot random directions, mostly misses, at 8).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optixpathtracer_tpu.ops import traverse_bfs as jbfs
from optixpathtracer_tpu.ops.traverse import brute_force_closest_hit as jax_brute
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh
from optixpathtracer_tpu_torch.ops import traverse_bfs as tbfs
from optixpathtracer_tpu_torch.ops.traverse import BIG_T, brute_force_closest_hit
from tests.torch_backend_cases import CPU, assert_records_equal, compiled, rays, soup


def test_bfs_matches_reference_and_brute_force(rng):
    pcs, jcs = compiled(soup(rng, 300), leaf_size=4, wide_width=8)
    (o, d), (jo, jd) = rays(rng, 512)
    res = tbfs.closest_hit_bfs(pcs.wide, o, d, 1e-3, 1e16, cap_factor=32)
    want = jbfs.closest_hit_bfs(jcs.wide, jo, jd, 1e-3, 1e16, cap_factor=32)
    assert float(res.overflow) == float(want.overflow) == 0.0
    assert_records_equal(res.record, want.record)
    bf = brute_force_closest_hit(pcs.scene, o, d, 1e-3, 1e16)
    hits = res.record.hit.numpy()
    np.testing.assert_array_equal(hits, bf.t.numpy() < BIG_T)
    np.testing.assert_allclose(res.record.t.numpy()[hits], bf.t.numpy()[hits], rtol=1e-4, atol=1e-5)
    assert 0.2 < hits.mean() < 1.0
    np.testing.assert_array_equal(np.asarray(jax_brute(jcs.scene, jo, jd).tri) >= 0, hits)


@pytest.mark.parametrize("width", [4, 8, 16])
def test_bfs_wide_widths(rng, width):
    pair = soup(rng, 150)
    (o, d), (jo, jd) = rays(rng, 256)
    pcs, jcs = compiled(pair, leaf_size=4, wide_width=width)
    res = tbfs.closest_hit_bfs(pcs.wide, o, d, cap_factor=32)
    want = jbfs.closest_hit_bfs(jcs.wide, jo, jd, cap_factor=32)
    assert float(res.overflow) == float(want.overflow) == 0.0, width
    assert_records_equal(res.record, want.record)


def test_bfs_any_hit(rng):
    pcs, jcs = compiled(soup(rng, 300), leaf_size=4)
    (o, d), (jo, jd) = rays(rng, 512)
    occ, ovf = tbfs.any_hit_bfs(pcs.wide, o, d, 1e-3, 1e16, cap_factor=32)
    jocc, jovf = jbfs.any_hit_bfs(jcs.wide, jo, jd, 1e-3, 1e16, cap_factor=32)
    assert float(ovf) == float(jovf) == 0.0
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), brute_force_closest_hit(pcs.scene, o, d).hit.numpy())


def test_bfs_tmax(rng):
    pcs, jcs = compiled(soup(rng, 300), leaf_size=4)
    (o, d), (jo, jd) = rays(rng, 256)
    t_full = tbfs.closest_hit_bfs(pcs.wide, o, d, 1e-3, 1e16, cap_factor=32).record.t.numpy()
    lim = np.where(t_full < BIG_T, t_full * 0.5, 1e16).astype(np.float32)
    cut = tbfs.closest_hit_bfs(pcs.wide, o, d, 1e-3, torch.as_tensor(lim), cap_factor=32)
    assert not np.any(cut.record.hit.numpy() & (t_full < 1e15))
    want = jbfs.closest_hit_bfs(jcs.wide, jo, jd, 1e-3, jnp.asarray(lim), cap_factor=32)
    assert_records_equal(cut.record, want.record)


def test_bfs_single_box():
    hs = HostScene()
    hs.add_box(make_material(), pos=(0, 0, 0), extent=(1, 1, 1))
    cs = compile_scene(hs, CPU)
    o = Vec3(*(torch.tensor(c) for c in ([3.0, 10.0], [0.0, 10.0], [0.0, 10.0])))
    d = Vec3(*(torch.tensor(c) for c in ([-1.0, 1.0], [0.0, 0.0], [0.0, 0.0])))
    res = tbfs.closest_hit_bfs(cs.wide, o, d)
    assert bool(res.record.hit[0]) and not bool(res.record.hit[1])
    np.testing.assert_allclose(float(res.record.t[0]), 2.0, rtol=1e-5)


@pytest.mark.parametrize("cap_factor", [1, 2])
def test_bfs_overflow_count_and_truncation_equal_to_reference(rng, cap_factor):
    """Under a worklist too small for the scene, the dropped-candidate count
    and the truncated results equal the reference's (ties in the sort keys
    aside, where the reference's unstable sort may order otherwise)."""
    pcs, jcs = compiled(soup(rng, 300, edge=0.3), leaf_size=4, wide_width=8)
    (o, d), (jo, jd) = rays(rng, 1024, aim=2.0)
    res = tbfs.closest_hit_bfs(pcs.wide, o, d, cap_factor=cap_factor)
    want = jbfs.closest_hit_bfs(jcs.wide, jo, jd, cap_factor=cap_factor)
    assert float(res.overflow) > 0.0
    assert float(res.overflow) == float(want.overflow)
    assert_records_equal(res.record, want.record)
    occ, ovf = tbfs.any_hit_bfs(pcs.wide, o, d, cap_factor=cap_factor)
    jocc, jovf = jbfs.any_hit_bfs(jcs.wide, jo, jd, cap_factor=cap_factor)
    assert float(ovf) == float(jovf) > 0.0
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_bfs_tie_rule_last_pair_in_worklist_order():
    """Two coincident triangles in two leaves of one node tie on t in the
    same level. The candidates of a pair sort stably by (near rank, near):
    the equal boxes keep slot order, so leaf 1's pair comes last in the
    worklist and sets the payload (the reference's CPU scatter applies its
    duplicate writes in order, and ends on the same pair). The lockstep
    walk and the dense scan keep the first (strict `<`)."""
    from optixpathtracer_tpu_torch.ops.dense import closest_hit_dense
    from optixpathtracer_tpu_torch.ops.traverse import closest_hit

    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    verts = np.concatenate([tri, tri])
    hs = HostScene()
    hs.add_mesh(Mesh(vertices=verts, indices=np.array([[0, 1, 2], [3, 4, 5]], np.int32),
                     material=make_material()))
    cs = compile_scene(hs, CPU, leaf_size=1)
    assert cs.wide.num_leaves == 2 and cs.wide.depth == 2
    n = 64
    g = np.random.default_rng(5)
    o = np.stack([g.uniform(0.05, 0.4, n), g.uniform(0.05, 0.4, n), np.full(n, 2.0)], 1).astype(np.float32)
    ov = Vec3(*(torch.as_tensor(o[:, k]) for k in range(3)))
    dv = Vec3(torch.zeros(n), torch.zeros(n), torch.full((n,), -1.0))
    res = tbfs.closest_hit_bfs(cs.wide, ov, dv)
    assert float(res.overflow) == 0.0
    np.testing.assert_array_equal(res.record.tri.numpy(), np.ones(n, np.int32))
    np.testing.assert_array_equal(res.record.t.numpy(), np.full(n, 2.0, np.float32))
    for first in (closest_hit(cs.bvh, cs.scene, ov, dv), closest_hit_dense(cs.wide, ov, dv)):
        np.testing.assert_array_equal(first.tri.numpy(), np.zeros(n, np.int32))
    # the JAX BFS on the same scene keeps the same pair
    from optixpathtracer_tpu.builder import compile_scene as jax_compile
    from optixpathtracer_tpu.core.materials import make_material as jmake
    from optixpathtracer_tpu.core.math import Vec3 as JVec3
    from optixpathtracer_tpu.core.scene import HostScene as JHost, Mesh as JMesh

    jhs = JHost()
    jhs.add_mesh(JMesh(vertices=verts, indices=np.array([[0, 1, 2], [3, 4, 5]], np.int32),
                       material=jmake()))
    jcs = jax_compile(jhs, leaf_size=1)
    jres = jbfs.closest_hit_bfs(jcs.wide, JVec3(*(jnp.asarray(c.numpy()) for c in ov)),
                                JVec3(*(jnp.asarray(c.numpy()) for c in dv)))
    np.testing.assert_array_equal(np.asarray(jres.record.tri), res.record.tri.numpy())


def test_bfs_truncates_on_the_city_as_the_reference_does():
    """bench.py's gate rays (half camera, half interior) on a 2000-box city
    at cap 8: the worklist overflows, as the reference's does, by the same
    count, and the truncated records are the reference's bit for bit (the
    card's `bfs_city` phase holds the 150k-triangle city's against the
    CPU)."""
    from bench import build_city_scene as jax_city
    from chip_smoke import mixed_rays
    from optixpathtracer_tpu.builder import compile_scene as jax_compile
    from optixpathtracer_tpu.core.math import Vec3 as JVec3
    from optixpathtracer_tpu_torch import scenes

    hs = scenes.build_city_scene(n_boxes=2000)
    cs = compile_scene(hs, CPU, leaf_size=8, cluster_size=256)
    jcs = jax_compile(jax_city(n_boxes=2000), leaf_size=8, cluster_size=256)
    o, d = mixed_rays(cs, hs, scenes.city_camera(1200, 800), 2048, 42, CPU)
    res = tbfs.closest_hit_bfs(cs.wide, o, d, 1e-3, 1e16, cap_factor=8)
    want = jbfs.closest_hit_bfs(jcs.wide, JVec3(*(jnp.asarray(c.numpy()) for c in o)),
                                JVec3(*(jnp.asarray(c.numpy()) for c in d)), 1e-3, 1e16, cap_factor=8)
    assert float(res.overflow) > 0 and float(res.overflow) == float(want.overflow)
    assert_records_equal(res.record, want.record)
