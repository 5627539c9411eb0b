"""Port parity, `ops/traverse_cluster.closest_hit_cluster_exec_stats`
against the JAX package's (its Pallas sweeps in interpret mode), on the
bench's hostile scene (small) and the 400-box city, through both walks.

Tolerances: t within 1e-6 relative to max(1, |t|), as
tests/test_torch_traverse_cluster.py holds the sweeps' t (XLA contracts the
reference's Moller-Trumbore arithmetic, in interpret mode and under
`jax.disable_jit()` alike: 145 of the hostile scene's 1024 lanes part by
1-3 ulp), and bit-equal to the port's own `closest_hit_cluster` t, which
takes the same walk. The executed-pair counts are in different
units (see the port's docstring): the port counts 16 x C pairs for each
16-ray sub-block that runs a member, the reference (block // groups) x C
for each 128-ray block that does, so the port's count equals its own
`SweepWork.lane_pairs` exactly and lies in (0, reference count].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_RAYS = 640  # five 128-ray blocks, the last partly camera rays, partly interior


def _scene(name):
    if name == "hostile":
        return bench.build_hostile_scene(n_boxes=120, terrain_grid=(48, 16))
    return bench.build_city_scene(n_boxes=400)


@pytest.fixture(scope="module", params=["hostile", "city400"])
def scene(request):
    jcs = jax_compile(_scene(request.param), leaf_size=8, wide_width=8, build_wide_bvh=False,
                      cluster_size=256)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    return jcs.clusters, pcs.clusters


def _rays(cl):
    """Camera rays of the bench's city camera beside interior rays in the
    scene's box, (N_RAYS, 3) f32 each."""
    rng = np.random.default_rng(11)
    half = N_RAYS // 2
    uu, vv, ww = scenes.city_camera(64, 48).uvw_frame()
    d0 = rng.uniform(-1, 1, (half, 1)) * uu[None] + rng.uniform(-1, 1, (half, 1)) * vv[None] + ww[None]
    o0 = np.broadcast_to(np.float32([55.0, 18.0, 55.0]), (half, 3))
    bb = cl.scene_aabb.numpy()
    o1 = bb[0:3] + rng.uniform(0.05, 0.95, (half, 3)) * (bb[3:6] - bb[0:3])
    d1 = rng.normal(0, 1, (half, 3))
    o = np.concatenate([o0, o1]).astype(np.float32)
    d = np.concatenate([d0, d1]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("hier", [True, False], ids=["node", "flat"])
def test_exec_stats_against_reference(scene, hier):
    jcl, pcl = scene
    o, d = _rays(pcl)
    jt, jpairs = jtc.closest_hit_cluster_exec_stats(
        jcl, JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
        JVec3(*(jnp.asarray(d[:, i]) for i in range(3))), 1e-3, 1e16, interpret=True, hier=hier)
    ov = Vec3(*(torch.as_tensor(np.ascontiguousarray(o[:, i])) for i in range(3)))
    dv = Vec3(*(torch.as_tensor(np.ascontiguousarray(d[:, i])) for i in range(3)))
    t, pairs = tc.closest_hit_cluster_exec_stats(pcl, ov, dv, 1e-3, 1e16, hier=hier)

    want = np.asarray(jt, np.float64)
    assert t.shape == want.shape
    assert (np.abs(t.numpy() - want) / np.maximum(1.0, np.abs(want))).max() <= 1e-6
    c = pcl.cluster_size
    if hier:
        work = tc.sweep_work_hier(pcl.rows, pcl.xf_inv, pcl.node_tables,
                                  tc.block_cull_nodes(pcl, ov, dv, 1e-3, 1e16), c)
    else:
        work = tc.sweep_work(pcl.rows, pcl.xf_inv, tc.block_cull(pcl, ov, dv, 1e-3, 1e16), c)
    assert isinstance(pairs, int)
    assert pairs == work.lane_pairs == work.visits * 16 * c
    ref_pairs = float(jpairs)
    assert ref_pairs % (128 * c) == 0  # interpret mode: one group, 128 rays a visit
    assert 0 < pairs <= ref_pairs


def test_exec_stats_routes_as_closest_hit_cluster(scene, monkeypatch):
    """hier=None takes the walk closest_hit_cluster takes (the node walk
    from HIER_MIN_ENTRIES entries); its t is the sweep's, padded to whole ray blocks."""
    _, pcl = scene
    o, d = _rays(pcl)
    ov = Vec3(*(torch.as_tensor(np.ascontiguousarray(o[:, i])) for i in range(3)))
    dv = Vec3(*(torch.as_tensor(np.ascontiguousarray(d[:, i])) for i in range(3)))
    for threshold, hier in ((pcl.num_entries, True), (pcl.num_entries + 1, False)):
        monkeypatch.setattr(tc, "HIER_MIN_ENTRIES", threshold)
        t, pairs = tc.closest_hit_cluster_exec_stats(pcl, ov, dv)
        t_w, pairs_w = tc.closest_hit_cluster_exec_stats(pcl, ov, dv, hier=hier)
        assert pairs == pairs_w and torch.equal(t, t_w)
        rec = tc.closest_hit_cluster(pcl, ov, dv)
        assert t.shape[0] % tc.BLOCK == 0 and (t[N_RAYS:] == 0).all()
        np.testing.assert_array_equal(torch.where(rec.tri < 0, tc.BIG_T, t[:N_RAYS]).numpy(),
                                      rec.t.numpy())
