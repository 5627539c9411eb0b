"""Port parity, the hierarchical (node) cluster walk: the node tables, the
node cull and the plain PyTorch versions of kernels K4a/K4b against the
JAX package — its `_node_tables`, its `block_cull_nodes` (XLA cull), its
hier Pallas kernels in interpret mode and its dense oracle — on identical
cluster sets (carried across with `interop`); the routing of hier=None;
and the scale scene `scenes.build_big_scene` against bench.py's.

Tolerances, as tests/test_torch_traverse_cluster.py: tables, cull bits,
counts, node order, winning triangles and occlusion bit-exact; keys and t
within 1e-6 relative to max(1, |x|); u/v within 1e-5 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from optixpathtracer_tpu.core.materials import build_table as jax_build_table
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.core.materials import build_table
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from tests.test_torch_traverse_cluster import _two_entry_scene
from tests.test_traverse_hier import _soup_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_RAYS = 512


def _soup(n_tris):
    """test_traverse_hier.py's soup at cluster_size 8: (reference, port)
    ClusterSets."""
    jcs = _soup_scene(n_tris=n_tris, cluster_size=8)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    return jcs.clusters, pcs.clusters


def _rays(n, seed):
    """test_traverse_hier.py's rays, for both packages."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
            JVec3(*(jnp.asarray(d[:, i]) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(o[:, i])) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(d[:, i])) for i in range(3))))


def _rel_close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= tol


@pytest.fixture(scope="module")
def soup():
    """The 1800-triangle soup at cluster_size 8: 29 entries, so the last
    node holds 3 sentinel entries."""
    return _soup(1800)


# closest-hit case -> (t_max of both packages, number of rays)
def _case(name):
    rng = np.random.default_rng(21)
    n = 177 if name == "ragged_n" else N_RAYS
    if name == "dead_and_per_ray_tmax":
        t_max = np.where(rng.random(n) < 0.33, 0.0, rng.uniform(2, 20, n)).astype(np.float32)
        return jnp.asarray(t_max), torch.as_tensor(t_max), n
    return 1e16, 1e16, n


@pytest.fixture(scope="module")
def closest_runs(soup):
    """Each case through the port (hier and flat) and through the JAX
    package's hier kernels (interpret mode) and dense oracle, once."""
    jcs, pcs = soup
    out = {}
    for name in ("random", "dead_and_per_ray_tmax", "ragged_n"):
        tmax_j, tmax_t, n = _case(name)
        jo, jd, to, td = _rays(n, 1)
        out[name] = dict(
            port=tc.closest_hit_cluster_hier(pcs, to, td, 1e-3, tmax_t),
            flat=tc.closest_hit_cluster(pcs, to, td, 1e-3, tmax_t, hier=False),
            jax=jtc.closest_hit_cluster_hier(jcs, jo, jd, 1e-3, tmax_j, interpret=True),
            oracle=jtc.reference_closest(jcs, jo, jd, 1e-3, tmax_j),
            t_max=np.broadcast_to(np.asarray(tmax_j), (n,)),
        )
    return out


@pytest.mark.parametrize("n_tris", [1800, 2048])
def test_node_tables_bit_equal(n_tris):
    jcs, pcs = _soup(n_tris)
    assert (pcs.num_entries % tc.NODE != 0) == (n_tris == 1800)
    got = pcs.node_tables
    want = jtc._node_tables(jcs.super_spheres, jcs.spheres, jcs.entry_row, jcs.entry_xf)
    for name, g, w in zip(tc.NodeTables._fields, got, want):
        assert g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert pcs.node_tables is got  # built once per ClusterSet


def test_block_cull_nodes_bit_equal(soup):
    jcs, pcs = soup
    jo, jd, to, td = _rays(N_RAYS, 2)
    got = tc.block_cull_nodes(pcs, to, td, 1e-3, 1e16)
    node_sph_t = jtc._node_tables(jcs.super_spheres, jcs.spheres, jcs.entry_row,
                                  jcs.entry_xf)[0]
    want = jtc.block_cull_nodes(jcs, node_sph_t, jo, jd, 1e-3, 1e16, 128, pallas_cull=False)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    for f in ("bits_lo", "bits_hi"):
        np.testing.assert_array_equal(getattr(got, f).numpy().view(np.uint32),
                                      np.asarray(getattr(want, f)))
    _rel_close(got.keys.numpy(), np.asarray(want.keys))
    _rel_close(got.rays8.numpy(), np.asarray(want.rays8))
    assert (got.count[: N_RAYS // tc.BLOCK] > 0).all()  # padding blocks are dead


def _check_hits(got, want):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    _rel_close(got.t.numpy(), np.asarray(want.t))
    hit = np.asarray(want.tri) >= 0
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[hit], np.asarray(want.v)[hit], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "dead_and_per_ray_tmax", "ragged_n"])
def test_closest_hier_vs_pallas_interpret_and_oracle(closest_runs, case):
    run = closest_runs[case]
    got = run["port"]
    _check_hits(got, run["jax"])
    _check_hits(got, run["oracle"])
    np.testing.assert_array_equal(got.tri.numpy(), run["flat"].tri.numpy())
    assert (got.tri.numpy() >= 0).sum() > 30  # the rays actually hit geometry
    dead = run["t_max"] == 0.0
    assert (got.tri.numpy()[dead] == -1).all() and (got.t.numpy()[dead] == tc.BIG_T).all()


@pytest.mark.parametrize("t_max", [14.0, 1e16])
def test_any_hier_vs_pallas_interpret_and_oracle(soup, t_max):
    jcs, pcs = soup
    jo, jd, to, td = _rays(N_RAYS, 6)
    occ, ovf = tc.any_hit_cluster_hier(pcs, to, td, 1e-2, t_max)
    assert float(ovf) == 0.0
    ref = jtc.reference_closest(jcs, jo, jd, 1e-2, t_max)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref.tri) >= 0)
    if t_max == 14.0:
        jocc, _ = jtc.any_hit_cluster_hier(jcs, jo, jd, 1e-2, t_max, interpret=True)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), tc.any_hit_cluster(pcs, to, td, 1e-2, t_max,
                                                                  hier=False)[0].numpy())
    assert 0 < int(occ.sum()) < N_RAYS


def test_threshold_and_node_match_reference():
    # the node layout is the reference's; the threshold is the port's own,
    # measured on the card (tests/test_torch_route_rules.py pins it), where
    # the reference keeps its TPU-made 3072
    assert tc.NODE == jtc.NODE
    assert jtc.HIER_MIN_ENTRIES == 3072 and tc.HIER_MIN_ENTRIES == 8


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tc, name)

    def spy(*args):
        calls.append(name)
        return real(*args)

    monkeypatch.setattr(tc, name, spy)
    return calls


def test_hier_none_routes_by_entry_count(soup, monkeypatch):
    """hier=None takes the node walk exactly from HIER_MIN_ENTRIES entries
    on, read at call time, and the node walk's winners are the oracle's."""
    jcs, pcs = soup
    jo, jd, to, td = _rays(N_RAYS, 9)
    closest_calls = _spy(monkeypatch, "_closest_hier_torch")
    any_calls = _spy(monkeypatch, "_any_hier_torch")
    monkeypatch.setattr(tc, "HIER_MIN_ENTRIES", pcs.num_entries + 1)
    flat = tc.closest_hit_cluster(pcs, to, td)
    tc.any_hit_cluster(pcs, to, td)
    assert closest_calls == [] and any_calls == []
    monkeypatch.setattr(tc, "HIER_MIN_ENTRIES", pcs.num_entries)
    hier = tc.closest_hit_cluster(pcs, to, td)
    occ, _ = tc.any_hit_cluster(pcs, to, td, 1e-2, 14.0)
    assert len(closest_calls) == 1 and len(any_calls) == 1
    want = jtc.reference_closest(jcs, jo, jd, 1e-3, 1e16)
    np.testing.assert_array_equal(hier.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(hier.tri.numpy(), flat.tri.numpy())
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jtc.reference_closest(jcs, jo, jd, 1e-2, 14.0).tri) >= 0)


def test_hier_sweeps_have_no_fallback(soup):
    _, pcs = soup
    _, _, to, td = _rays(64, 7)
    cr = tc.block_cull_nodes(pcs, to, td, 1e-3, 1e16)
    meta = cr._replace(**{f: getattr(cr, f).to("meta") for f in cr._fields})
    nt = tc.NodeTables(*(a.to("meta") for a in pcs.node_tables))
    args = (pcs.rows.to("meta"), pcs.xf_inv.to("meta"), nt, meta, pcs.cluster_size)
    with pytest.raises(ValueError, match="no kernel"):
        tc.closest_hier_sweep(*args)
    with pytest.raises(ValueError, match="no kernel"):
        tc.any_hier_sweep(*args)


def test_sweep_work_hier_counts_a_hand_built_walk():
    # one ray, one node (2 entries + 6 sentinels): the re-cull, taken once on
    # the ray's whole reach, names cluster 0 (hits at z = 5 and 5.5) and
    # cluster 8 (z = 20..23)
    cs, o, d = _two_entry_scene()
    nt = cs.node_tables
    cr = tc.block_cull_nodes(cs, o, d, 1e-3, 1e16)
    assert int(cr.count[0, 0]) == 1 and int(cr.count.sum()) == 1
    t, tri = tc._closest_hier_torch(cs.rows, cs.xf_inv, nt, cr, 4)
    assert float(t[0]) == 5.0 and int(tri[0]) == 1
    # closest: both members run all 4 columns (no key gate within a node);
    # the block stages both, 9 x 4 f32 each, and the node's six box rows
    work = tc.sweep_work_hier(cs.rows, cs.xf_inv, nt, cr, 4)
    assert work == tc.SweepWork(8, 2, slab_tests=64, lane_pairs=128, nodes=1, staged=2)
    assert work.staged_bytes(4) == 2 * 9 * 4 * 4 + 6 * 64 * 4
    # any-hit: column 1 of cluster 0 occludes after 2 columns, and cluster 8,
    # named only by the ray now occluded, is neither run nor staged
    work = tc.sweep_work_hier(cs.rows, cs.xf_inv, nt, cr, 4, any_hit=True)
    assert work == tc.SweepWork(2, 1, slab_tests=64, lane_pairs=32, nodes=1, staged=1)


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_work_hier_stages_within_the_re_cull(soup, any_hit):
    _, pcs = soup
    _, _, to, td = _rays(N_RAYS, 11)
    nt = pcs.node_tables
    cr = tc.block_cull_nodes(pcs, to, td, 1e-2, 14.0)
    work = tc.sweep_work_hier(pcs.rows, pcs.xf_inv, nt, cr, pcs.cluster_size, any_hit=any_hit)
    assert 0 < work.nodes <= int(cr.count.sum())
    # a staged member has a visit, and a visit belongs to one staged member
    assert 0 < work.staged <= work.visits <= work.staged * 8
    assert work.staged <= work.nodes * tc.NODE * tc.SUPER


def _sweep_work_hier_host_reads(rows, xf_inv, nt, cr, c, any_hit=False):
    """`tc.sweep_work_hier` as it was before its staging count moved to the
    device: the running (block, cluster) pairs of each visit read back to
    the host and made unique there."""
    best = cr.rays8[:, 7].clone()
    occ = torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    tm_all, tM_all = cr.rays8[:, 6], cr.rays8[:, 7]
    dlen = tc._dlen(cr.rays8)
    work = [0, 0, 0, 0, 0, 0]
    last = [(-1, -1)]

    def bound():
        if any_hit:
            return torch.where(occ, 0.0, torch.clamp(tM_all * dlen, max=tc._BIG)).reshape(-1, tc.BLOCK).amax(dim=1)
        return torch.clamp(best * dlen, max=tc._BIG).reshape(-1, tc.BLOCK).amax(dim=1)

    def on_recull(rays, tcur):
        work[2] = work[2] + (tcur > rays[:, :, 6]).sum() * (tc.NODE * tc.SUPER)
        work[4] += rays.shape[0]

    def visit(ray_idx, gate, tm, tM, det, up, vp, tp, cid):
        go = gate & ~occ[ray_idx] if any_hit else gate
        run = go.any(dim=1)
        pairs = torch.stack([ray_idx[run, 0] // tc.BLOCK, cid[run].to(torch.int64)], dim=1)
        if pairs.shape[0]:
            uniq = torch.unique_consecutive(pairs, dim=0)
            work[5] += uniq.shape[0] - (tuple(uniq[0].tolist()) == last[0])
            last[0] = tuple(uniq[-1].tolist())
        tc._run_visit(work, go, *tc._mt_t(det, up, vp, tp), tm, tM, ray_idx, best, occ, c, any_hit)

    tcur_of = (lambda: torch.where(occ, tm_all, tM_all)) if any_hit else (lambda: best)
    tc._walk_hier(rows, xf_inv, nt, cr, c, tcur_of, bound, visit, on_recull)
    return tc.SweepWork(*(int(w) for w in work))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed,t_max", [(11, 14.0), (5, 1e16), (9, 4.0)])
def test_sweep_work_hier_counts_equal_the_host_read_walk(soup, any_hit, seed, t_max):
    """The device-side staging count equals the host-read one it replaced,
    every count of SweepWork bit for bit."""
    _, pcs = soup
    _, _, to, td = _rays(N_RAYS, seed)
    cr = tc.block_cull_nodes(pcs, to, td, 1e-2, t_max)
    args = (pcs.rows, pcs.xf_inv, pcs.node_tables, cr, pcs.cluster_size)
    want = _sweep_work_hier_host_reads(*args, any_hit=any_hit)
    assert want.staged > 0
    assert tc.sweep_work_hier(*args, any_hit=any_hit) == want


def _hier_sweep_args(pcs, c):
    _, _, to, td = _rays(64, 7)
    cr = tc.block_cull_nodes(pcs, to, td, 1e-3, 1e16)
    return pcs.rows, pcs.xf_inv, pcs.node_tables, cr, c


def test_check_hier_sweep_refuses_a_cluster_size_not_a_multiple_of_4(soup):
    _, pcs = soup
    rows, xf_inv, nt, cr, _ = _hier_sweep_args(pcs, 8)
    rows6 = torch.zeros((rows.shape[0], rows.shape[1], tc.SUPER * 6))
    with pytest.raises(ValueError, match="multiple of 4"):
        tc._check_hier_sweep(rows6, xf_inv, nt, cr, 6)
    assert tc._check_hier_sweep(rows, xf_inv, nt, cr, 8) == tuple(cr.ids.shape)


@pytest.mark.parametrize("which", ["rows", "csph"])
def test_check_hier_sweep_refuses_tables_off_a_16_byte_boundary(soup, which):
    _, pcs = soup
    rows, xf_inv, nt, cr, c = _hier_sweep_args(pcs, pcs.cluster_size)

    def shifted(a):  # the same values, one float past a 16-byte boundary
        buf = torch.zeros(a.numel() + 4, dtype=a.dtype)
        off = 1 + (-(buf.data_ptr() // 4)) % 4
        out = buf[off : off + a.numel()].view(a.shape)
        out.copy_(a)
        assert out.data_ptr() % 16 == 4 and out.is_contiguous()
        return out

    if which == "rows":
        rows = shifted(rows)
    else:
        nt = nt._replace(csph=shifted(nt.csph))
    with pytest.raises(ValueError, match="16-byte boundary"):
        tc._check_hier_sweep(rows, xf_inv, nt, cr, c)


def test_build_big_scene_matches_bench():
    kw = dict(n_boxes=100, terrain_grid=(32, 16))
    mine, ref = scenes.build_big_scene(**kw), bench.build_big_scene(**kw)
    assert len(mine.meshes) == len(ref.meshes) > 10
    for a, b in zip(mine.meshes, ref.meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.material == b.material
    np.testing.assert_array_equal(
        build_table([m.material for m in mine.meshes], CPU).rows.numpy(),
        np.asarray(jax_build_table([m.material for m in ref.meshes]).rows))
    assert scenes.BIG8X_TERRAIN_GRID == (2048, 2048)
