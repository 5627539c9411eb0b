"""Port parity, ops/traverse_cluster: the cull, the closest-hit and any-hit
sweeps (plain PyTorch versions of kernels K1-K3) against the JAX package —
its XLA cull twin, its Pallas kernels in interpret mode and its dense
oracle — on identical cluster sets (carried across with `interop`).

Tolerances: cull bits, counts, entry order, winning triangles and occlusion
are bit-exact. Keys and t within 1e-6 relative to max(1, |x|), u/v within
1e-5 absolute, as tests/test_traverse_cluster.py allows (XLA may contract
differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_hostile_scene
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.bvh.clusters import build_clusters as jax_build_clusters
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.bvh.clusters import build_clusters
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from tests.golden_scenes import _open_scene, _sky_probe
from torch_cull_cases import hostile_rays8

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _random_tris(rng, t, extent=2.0, size=0.3):
    ctr = rng.uniform(-extent, extent, (t, 3)).astype(np.float32)
    v = [ctr + rng.normal(0, size, (t, 3)).astype(np.float32) for _ in range(3)]
    order = np.argsort(ctr[:, 0], kind="stable")
    return [a[order] for a in v]


def _rays(o, d):
    return (JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
            JVec3(*(jnp.asarray(d[:, i]) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(o[:, i])) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(d[:, i])) for i in range(3))))


def _random_rays(rng, n, extent=4.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _rays(o, d)


def _hostile_rays(rng, n=512):
    half = n // 2
    o1 = rng.uniform(-40, 40, (half, 3)).astype(np.float32)
    o1[:, 1] = rng.uniform(0.5, 6.0, half)
    d1 = rng.normal(0, 1, (half, 3)).astype(np.float32)
    o2 = rng.uniform(-40, 40, (half, 3)).astype(np.float32)
    o2[:, 1] = rng.uniform(-1.0, 3.0, half)
    d2 = rng.normal(0, 1, (half, 3)).astype(np.float32)
    d2[:, 1] *= 0.05  # grazing: the slab test's worst case on slivers
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _rays(o, d)


def _port(jcs):
    """The reference ClusterSet carried across into the port."""
    return interop.compiled_scene_from_arrays(
        interop.compiled_scene_arrays(_Compiled(jcs)), CPU).clusters


class _Compiled:
    """Minimal CompiledScene view around a bare reference ClusterSet."""

    def __init__(self, clusters):
        from optixpathtracer_tpu.core.materials import build_table

        n = clusters.num_slots
        self.clusters = clusters
        self.scene = type("S", (), {"shade_rows": np.zeros((n, 32), np.float32),
                                    "materials": build_table([])})()
        self.num_triangles = n


@pytest.fixture(scope="module")
def random_scene():
    rng = np.random.default_rng(0)
    v0, v1, v2 = _random_tris(rng, 300)
    jcs = jax_build_clusters(v0, v1, v2, 300, cluster_size=64)
    return jcs, _port(jcs)


@pytest.fixture(scope="module")
def hostile_scene():
    jcs = jax_compile(build_hostile_scene(n_boxes=60, terrain_grid=(32, 16)),
                      build_wide_bvh=False, cluster_size=64).clusters
    return jcs, _port(jcs)


def _rel_close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= tol


def test_key_constant_matches_cuda_literal():
    # _cull_math's (1.0 - 4e-7) is a Python double rounded to f32; the CUDA
    # source writes it as the literal 0.9999996f
    assert np.float32(1.0 - 4e-7) == np.float32("0.9999996")


def test_port_cluster_build_equals_reference_build():
    rng = np.random.default_rng(1)
    v0, v1, v2 = _random_tris(rng, 500)
    jcs = jax_build_clusters(v0, v1, v2, 500, cluster_size=64)
    pcs = build_clusters(v0, v1, v2, 500, CPU, cluster_size=64)
    for f in ("rows", "spheres", "super_spheres", "scene_aabb", "entry_row", "xf_inv"):
        np.testing.assert_array_equal(getattr(pcs, f).numpy(), np.asarray(getattr(jcs, f)))


@pytest.mark.parametrize("dead_frac", [0.0, 0.4])
def test_cull_vs_xla_and_pallas_interpret(random_scene, dead_frac):
    jcs, pcs = random_scene
    rng = np.random.default_rng(2)
    jo, jd, to, td = _random_rays(rng, 1024)
    t_max = np.where(rng.random(1024) < dead_frac, 0.0, rng.uniform(0.5, 8, 1024)).astype(np.float32)
    rays8 = tc._pack_rays8(pcs, to, td, 1e-3, torch.as_tensor(t_max))
    jrays8 = jtc._pack_rays8(jcs, jo, jd, 1e-3, jnp.asarray(t_max), 128)
    _rel_close(rays8.numpy(), np.asarray(jrays8))
    sph_t = tc.sphere_table(pcs)
    jsph = jnp.asarray(sph_t.numpy())
    jr8 = jnp.asarray(rays8.numpy())  # identical inputs for the three culls
    key, lo, hi, count = tc._cull_torch(rays8, sph_t)
    for jkey, jlo, jhi, jcount in (jtc._cull_xla(jr8, jsph, block=128),
                                   jtc._cull_pallas(jr8, jsph, block=128, interpret=True)):
        np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        _rel_close(key.numpy(), np.asarray(jkey))
    assert int(count.sum()) > 0


def test_block_cull_outputs(hostile_scene):
    jcs, pcs = hostile_scene
    jo, jd, to, td = _hostile_rays(np.random.default_rng(3), 1024)
    got = tc.block_cull(pcs, to, td, 1e-3, 1e16)
    want = jtc.block_cull(jcs, jo, jd, 1e-3, 1e16, 128, pallas_cull=False)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for f in ("ids", "rowix", "xfix"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("bits_lo", "bits_hi"):
        np.testing.assert_array_equal(getattr(got, f).numpy().view(np.uint32),
                                      np.asarray(getattr(want, f)))
    _rel_close(got.keys.numpy(), np.asarray(want.keys))
    _rel_close(got.rays8.numpy(), np.asarray(want.rays8))


def _check_hits(got, want, uv=True):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    _rel_close(got.t.numpy(), np.asarray(want.t))
    if uv:
        np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "dead_and_per_ray_tmax", "ragged_n"])
def test_closest_vs_pallas_interpret_and_oracle(random_scene, case):
    jcs, pcs = random_scene
    rng = np.random.default_rng(4)
    n = 177 if case == "ragged_n" else 300
    jo, jd, to, td = _random_rays(rng, n)
    t_max = 1e16
    if case == "dead_and_per_ray_tmax":
        t_max = np.where(rng.random(n) < 0.33, 0.0, rng.uniform(1, 8, n)).astype(np.float32)
    tmax_j = jnp.asarray(t_max) if case == "dead_and_per_ray_tmax" else t_max
    tmax_t = torch.as_tensor(t_max) if case == "dead_and_per_ray_tmax" else t_max
    got = tc.closest_hit_cluster(pcs, to, td, 1e-3, tmax_t)
    _check_hits(got, jtc.closest_hit_cluster(jcs, jo, jd, 1e-3, tmax_j, interpret=True))
    _check_hits(got, jtc.reference_closest(jcs, jo, jd, 1e-3, tmax_j))
    _check_hits(tc.reference_closest(pcs, to, td, 1e-3, tmax_t),
                jtc.reference_closest(jcs, jo, jd, 1e-3, tmax_j))
    assert (got.tri.numpy() >= 0).sum() > 8  # the rays actually hit geometry
    if case == "dead_and_per_ray_tmax":
        dead = t_max == 0.0
        assert (got.tri.numpy()[dead] == -1).all() and (got.t.numpy()[dead] == tc.BIG_T).all()


def test_closest_exact_on_hostile_geometry(hostile_scene):
    jcs, pcs = hostile_scene
    jo, jd, to, td = _hostile_rays(np.random.default_rng(5))
    got = tc.closest_hit_cluster(pcs, to, td, 1e-3, 1e16)
    _check_hits(got, jtc.closest_hit_cluster(jcs, jo, jd, 1e-3, 1e16, interpret=True))
    want = jtc.reference_closest(jcs, jo, jd, 1e-3, 1e16)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hits = np.asarray(want.tri) >= 0
    assert hits.sum() > 512 // 4
    np.testing.assert_allclose(got.t.numpy()[hits], np.asarray(want.t)[hits], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("scene", ["random", "hostile"])
def test_any_hit_vs_pallas_interpret_and_oracle(random_scene, hostile_scene, scene):
    jcs, pcs = random_scene if scene == "random" else hostile_scene
    rng = np.random.default_rng(6)
    jo, jd, to, td = _random_rays(rng, 256) if scene == "random" else _hostile_rays(rng, 256)
    t_max = 10.0 if scene == "random" else 1e16
    occ, ovf = tc.any_hit_cluster(pcs, to, td, 1e-2, t_max)
    assert float(ovf) == 0.0
    ref = jtc.reference_closest(jcs, jo, jd, 1e-2, t_max)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref.tri) >= 0)
    if scene == "random":
        jocc, _ = jtc.any_hit_cluster(jcs, jo, jd, 1e-2, t_max, interpret=True)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < int(occ.sum()) < 256


def test_interop_round_trip():
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    arrays = interop.compiled_scene_arrays(jcs)
    pcs = interop.compiled_scene_from_arrays(arrays, CPU)
    back = interop.compiled_scene_arrays(pcs)
    assert arrays.keys() == back.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    jp = _sky_probe()
    parr = interop.probe_arrays(jp)
    pp = interop.probe_from_arrays(parr, CPU)
    for k, v in interop.probe_arrays(pp).items():
        np.testing.assert_array_equal(v, parr[k], err_msg=k)
    # a probe built by the port carries across the same way
    mine = build_probe(np.full((4, 8, 3), 0.5, np.float32), CPU)
    assert interop.probe_arrays(mine)["rgbp"].shape == (32, 4)


def _two_entry_scene(c=4):
    """Two entries of 8 clusters of c triangles. The ray from (1.5, 1.5, 0)
    along +z meets cluster 0 (column 1 at z = 5, column 3 at z = 5.5;
    columns 0 and 2 lie beside it) and cluster 8 (every column, z = 20);
    clusters 1-7 and 9-15 lie far beside it."""
    def tri(x, y, z, size=2.0):
        return [(x, y, z), (x + size, y, z), (x, y + size, z)]

    tris = []
    for cl in range(2 * tc.SUPER):
        for j in range(c):
            if cl == 0:
                tris.append(tri(1.0, 1.0, 5.0) if j == 1 else tri(1.0, 1.0, 5.5) if j == 3
                            else tri(3.0, 3.0, 5.0))
            elif cl == tc.SUPER:
                tris.append(tri(1.0, 1.0, 20.0 + j))
            else:
                tris.append(tri(50.0 + cl, 50.0, 5.0 if cl < tc.SUPER else 20.0))
    v = np.asarray(tris, np.float32)
    cs = build_clusters(v[:, 0], v[:, 1], v[:, 2], len(tris), CPU, cluster_size=c)
    o = Vec3(*(torch.tensor([x]) for x in (1.5, 1.5, 0.0)))
    d = Vec3(*(torch.tensor([x]) for x in (0.0, 0.0, 1.0)))
    return cs, o, d


def _scheduled_bits(cr):
    """(sub-block, member) cull bits of every block's surviving entries."""
    live = torch.arange(cr.ids.shape[1])[None] < cr.count
    words = torch.stack([cr.bits_lo, cr.bits_hi]).to(torch.int64) & 0xFFFFFFFF
    return int(sum(((words >> b) & 1)[:, live].sum() for b in range(32)))


def test_sweep_work_counts_a_hand_built_walk():
    cs, o, d = _two_entry_scene()
    cr = tc.block_cull(cs, o, d, 1e-3, 1e16)
    assert int(cr.count[0, 0]) == 2 and int(cr.count.sum()) == 2
    assert _scheduled_bits(cr) == 2  # sub-block 0 x clusters 0 and 8
    t, tri = tc._closest_torch(cs.rows, cs.xf_inv, cr, 4)
    assert float(t[0]) == 5.0 and int(tri[0]) == 1
    # closest: cluster 0 sets best = 5, so entry 1 (key ~20) fails the gate
    # (the visit's 16 lanes issue the 4 columns: 64 lane pairs)
    assert tc.sweep_work(cs.rows, cs.xf_inv, cr, 4) == tc.SweepWork(4, 1, lane_pairs=64)
    # any-hit: column 1 occludes, after 2 columns; entry 1 is never run
    assert tc.sweep_work(cs.rows, cs.xf_inv, cr, 4, any_hit=True) == tc.SweepWork(2, 1, lane_pairs=32)
    assert tc.SweepWork(4, 1).ops == 4 * tc.MT_OPS


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_work_within_the_cull_bits(random_scene, any_hit):
    _, pcs = random_scene
    _, _, to, td = _random_rays(np.random.default_rng(8), 512)
    cr = tc.block_cull(pcs, to, td, 1e-2 if any_hit else 1e-3, 6.0)
    work = tc.sweep_work(pcs.rows, pcs.xf_inv, cr, pcs.cluster_size, any_hit=any_hit)
    bits = _scheduled_bits(cr)
    assert 0 < work.visits <= bits
    assert 0 < work.pairs <= work.lane_pairs <= work.visits * (tc.BLOCK // 8) * pcs.cluster_size


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_work_hier_within_the_node_walk(random_scene, any_hit):
    _, pcs = random_scene
    _, _, to, td = _random_rays(np.random.default_rng(9), 512)
    cr = tc.block_cull_nodes(pcs, to, td, 1e-3, 6.0)
    nt = pcs.node_tables
    work = tc.sweep_work_hier(pcs.rows, pcs.xf_inv, nt, cr, pcs.cluster_size, any_hit=any_hit)
    # each visited node re-culls at most its block's 128 rays against 64 boxes
    assert 0 < work.slab_tests <= int(cr.count.sum()) * tc.BLOCK * tc.NODE * tc.SUPER
    assert work.slab_tests % (tc.NODE * tc.SUPER) == 0
    assert 0 < work.visits
    assert 0 < work.pairs <= work.lane_pairs <= work.visits * (tc.BLOCK // 8) * pcs.cluster_size
    assert work.ops == work.pairs * tc.MT_OPS + work.slab_tests * tc.SLAB_OPS


@pytest.mark.parametrize("walk", ["flat", "node"])
def test_plain_walks_do_not_depend_on_their_chunk(random_scene, monkeypatch, walk):
    """One (block, sub-block) visit a chunk gives the plain sweeps' results
    and the counted work of the card's chunk (`_MT_ELEMS_CUDA`)."""
    _, pcs = random_scene
    _, _, to, td = _random_rays(np.random.default_rng(10), 512)
    c, nt = pcs.cluster_size, pcs.node_tables
    if walk == "flat":
        cr, cr_s = tc.block_cull(pcs, to, td, 1e-3, 6.0), tc.block_cull(pcs, to, td, 1e-2, 6.0)
        run = lambda: (*tc._closest_torch(pcs.rows, pcs.xf_inv, cr, c), tc._any_torch(pcs.rows, pcs.xf_inv, cr_s, c),
                       *(tc.sweep_work(pcs.rows, pcs.xf_inv, x, c, any_hit=a) for x, a in ((cr, False), (cr_s, True))))
    else:
        cr, cr_s = tc.block_cull_nodes(pcs, to, td, 1e-3, 6.0), tc.block_cull_nodes(pcs, to, td, 1e-2, 6.0)
        run = lambda: (*tc._closest_hier_torch(pcs.rows, pcs.xf_inv, nt, cr, c),
                       tc._any_hier_torch(pcs.rows, pcs.xf_inv, nt, cr_s, c),
                       *(tc.sweep_work_hier(pcs.rows, pcs.xf_inv, nt, x, c, any_hit=a)
                         for x, a in ((cr, False), (cr_s, True))))
    monkeypatch.setattr(tc, "_MT_ELEMS", tc._MT_ELEMS_CUDA)
    t, tri, occ, work, work_s = run()
    monkeypatch.setattr(tc, "_MT_ELEMS", (tc.BLOCK // 8) * c)
    t1, tri1, occ1, work1, work1_s = run()
    assert torch.equal(t, t1) and torch.equal(tri, tri1) and torch.equal(occ, occ1)
    assert (work, work_s) == (work1, work1_s) and work.visits > 1 and work_s.visits > 1


def test_kernel_dispatch_has_no_fallback(random_scene):
    _, pcs = random_scene
    _, _, to, td = _random_rays(np.random.default_rng(7), 64)
    rays8 = tc._pack_rays8(pcs, to, td, 1e-3, 1e16)
    # CPU tensors take the plain version; any other device launches or raises
    with pytest.raises(ValueError, match="no kernel"):
        tc.cull_blocks(rays8.to("meta"), *(t.to("meta") for t in pcs.cull_tables))
    # hier=True is the node walk (K4), here through its plain versions
    np.testing.assert_array_equal(tc.closest_hit_cluster(pcs, to, td, hier=True).tri.numpy(),
                                  tc.closest_hit_cluster(pcs, to, td, hier=False).tri.numpy())
    np.testing.assert_array_equal(tc.any_hit_cluster(pcs, to, td, hier=True)[0].numpy(),
                                  tc.any_hit_cluster(pcs, to, td, hier=False)[0].numpy())


# -- kernel K1 on hostile rays, and its group pre-test -------------------------

def _tables(pcs, table):
    """(member table, group boxes) of the flat cull or of the node cull."""
    if table == "flat":
        return pcs.cull_tables
    nt = pcs.node_tables
    return nt.node_sph_t, nt.node_box_t


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_cull_hostile_rays_bit_equal_to_reference(random_scene, reference):
    """NaN and infinite origins and directions, zero direction components,
    t_max <= t_min, a block of dead rays, boxes at ray origins: the plain
    K1 gives the reference's key / lo / hi / count bit for bit (a NaN key
    counts as equal to a NaN key)."""
    _, pcs = random_scene
    sph_t = tc.sphere_table(pcs)
    rays8 = hostile_rays8(11, 16, sph_t.numpy())
    key, lo, hi, count = tc._cull_torch(torch.as_tensor(rays8), sph_t)
    jr8, jsph = jnp.asarray(rays8), jnp.asarray(sph_t.numpy())
    if reference == "xla":
        jkey, jlo, jhi, jcount = jtc._cull_xla(jr8, jsph, block=128)
    else:
        jkey, jlo, jhi, jcount = jtc._cull_pallas(jr8, jsph, block=128, interpret=True)
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), np.asarray(jhi))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))  # NaN == NaN here
    assert int(count[4].sum()) == 0  # the block of dead rays
    assert int(count.sum()) > 0 and np.isnan(key.numpy()).any()


@pytest.mark.parametrize("table", ["flat", "node"])
@pytest.mark.parametrize("scene", ["random", "hostile"])
def test_group_boxes_hold_their_members(random_scene, hostile_scene, scene, table):
    _, pcs = random_scene if scene == "random" else hostile_scene
    sph_t, grp_t = _tables(pcs, table)
    s = grp_t.shape[1]
    assert grp_t.shape == (8, s) and sph_t.shape == (8, s * 8)
    mem = sph_t.double().reshape(8, 8, s)  # (row, member, group)
    g = grp_t.double()
    # containment in real arithmetic (float64 holds these sums exactly enough)
    assert bool((g[0:3] - g[4:7] <= (mem[0:3] - mem[4:7]).amin(dim=1)).all())
    assert bool((g[0:3] + g[4:7] >= (mem[0:3] + mem[4:7]).amax(dim=1)).all())


@pytest.mark.parametrize("table", ["flat", "node"])
@pytest.mark.parametrize("scene", ["random", "hostile"])
def test_group_pretest_passes_every_cull_bit(random_scene, hostile_scene, scene, table):
    """Wherever `_cull_torch` sets a bit of (sub-block, member of a group),
    the plain version of the kernel's pre-test passes (sub-block, group):
    skipping the groups it rejects drops no bit. Flat and node tables, the
    node table's far-sentinel entries included."""
    _, pcs = random_scene if scene == "random" else hostile_scene
    sph_t, grp_t = _tables(pcs, table)
    rng = np.random.default_rng(12)
    _, _, to, td = _random_rays(rng, 1024) if scene == "random" else _hostile_rays(rng, 1024)
    rays8 = torch.cat([tc._pack_rays8(pcs, to, td, 1e-3, 1e16),
                       torch.as_tensor(hostile_rays8(13, 16, sph_t.numpy()))])
    _, lo, hi, _ = tc._cull_torch(rays8, sph_t)
    may = tc._group_pretest_torch(rays8, grp_t)  # (NR, 8, S)
    words = torch.stack([lo, hi], dim=1).to(torch.int64) & 0xFFFFFFFF  # (NR, 2, S)
    sub_bits = torch.stack([(words[:, s8 // 4] >> (8 * (s8 % 4))) & 0xFF for s8 in range(8)], dim=1)
    assert int((sub_bits != 0).sum()) > 0
    assert not bool(((sub_bits != 0) & ~may).any())
    if scene == "hostile" and table == "node":
        assert bool((~may).any())  # and it does reject something
    # the work the kernel must do is what this counts
    work = tc.cull_work(rays8, sph_t, grp_t)
    live = int((rays8[:, 7] > rays8[:, 6]).sum())
    assert live * grp_t.shape[1] <= work.slab_tests <= live * (grp_t.shape[1] + sph_t.shape[1])
