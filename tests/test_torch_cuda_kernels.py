"""The CUDA kernels K1-K6 against their plain PyTorch versions, on the card,
and the quality pipeline's plain tensor code (Sobol, `_ld_bases`, the
À-Trous denoiser) on the card against the CPU.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and skip
elsewhere. On the card (no jax there, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Kernel outputs must be bit-equal: the kernels are built with --fmad=false
and no fast math, and compute op for op what the plain versions compute.
The Sobol words and stratum bases are bit-equal too (integer arithmetic and
exact float steps); the denoiser agrees to a stated tolerance.
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch.bvh.clusters import build_clusters
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import gather
from optixpathtracer_tpu_torch.ops import sc_worklist as sw
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from torch_cull_cases import hostile_rays8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _scene_and_rays(device, cluster_size, n=4096, seed=0, t=3000):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-4, 4, (t, 3)).astype(np.float32)
    v = [ctr + rng.normal(0, 0.3, (t, 3)).astype(np.float32) for _ in range(3)]
    order = np.argsort(ctr[:, 0], kind="stable")
    cs = build_clusters(*(a[order] for a in v), t, device, cluster_size=cluster_size)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(1, 20, n)).astype(np.float32)

    def v3(a):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device) for i in range(3)))

    return cs, v3(o), v3(d), torch.as_tensor(t_max, device=device)


@pytest.mark.parametrize("cluster_size", [60, 64, 256, 1024])  # 1024: K2/K3's slots opt in above 48 KiB
def test_kernels_bit_equal_to_plain(cuda, cluster_size):
    cs, o, d, t_max = _scene_and_rays(cuda, cluster_size)
    rays8 = tc._pack_rays8(cs, o, d, 1e-3, t_max)
    sph_t, grp_t = cs.cull_tables
    before = dict(tc.launch_counts)
    for k, p in zip(tc.cull_blocks(rays8, sph_t, grp_t), tc._cull_torch(rays8, sph_t)):
        assert torch.equal(k, p)
    cr = tc.block_cull(cs, o, d, 1e-3, t_max)
    t_k, tri_k, vis = tc.closest_sweep(cs.rows, cs.xf_inv, cr, cluster_size)
    t_p, tri_p = tc._closest_torch(cs.rows, cs.xf_inv, cr, cluster_size)
    assert torch.equal(t_k, t_p) and torch.equal(tri_k, tri_p)
    assert int(vis.sum()) > 0
    occ_k = tc.any_sweep(cs.rows, cs.xf_inv, cr, cluster_size)
    assert torch.equal(occ_k, tc._any_torch(cs.rows, cs.xf_inv, cr, cluster_size))
    after = dict(tc.launch_counts)
    assert after["cull"] - before.get("cull", 0) == 2  # cull_blocks + block_cull
    assert after["closest"] - before.get("closest", 0) == 1
    assert after["any"] - before.get("any", 0) == 1


@pytest.mark.parametrize("cluster_size", [64, 256])
def test_closest_visits_equal_sweep_work(cuda, cluster_size):
    cs, o, d, t_max = _scene_and_rays(cuda, cluster_size, seed=4)
    cr = tc.block_cull(cs, o, d, 1e-3, t_max)
    _, _, vis = tc.closest_sweep(cs.rows, cs.xf_inv, cr, cluster_size)
    assert int(vis.sum()) == tc.sweep_work(cs.rows, cs.xf_inv, cr, cluster_size).visits > 0


def _v3(a, device):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device) for i in range(3)))


def _sweeps_equal_plain(cs, cr, c):
    t_k, tri_k, vis = tc.closest_sweep(cs.rows, cs.xf_inv, cr, c)
    t_p, tri_p = tc._closest_torch(cs.rows, cs.xf_inv, cr, c)
    assert torch.equal(t_k, t_p) and torch.equal(tri_k, tri_p)
    assert torch.equal(tc.any_sweep(cs.rows, cs.xf_inv, cr, c), tc._any_torch(cs.rows, cs.xf_inv, cr, c))
    return tri_k, vis


def _tie_grid(device, c, n=4096):
    """A 32 x 32 grid of unit quads at y = 0 (two triangles on a shared
    diagonal), laid down twice: the copy sits in other clusters and entries,
    so every hit ties exactly on t with its copy; rays straight down onto
    grid vertices and edge midpoints also tie across shared edges. The
    second half of the rays is oblique. Returns (cs, o, d, n // 2)."""
    g = 32
    tris = []
    for i in range(g):
        for j in range(g):
            a, b, e, f = (i, 0, j), (i + 1, 0, j), (i, 0, j + 1), (i + 1, 0, j + 1)
            tris += [(a, b, e), (b, f, e)]
    v = np.asarray(tris + tris, np.float32)
    cs = build_clusters(v[:, 0], v[:, 1], v[:, 2], len(v), device, cluster_size=c)
    rng = np.random.default_rng(6)
    pts = rng.integers(0, 2 * g + 1, (n, 2)) / 2.0
    o = np.stack([pts[:, 0], np.full(n, 5.0), pts[:, 1]], 1).astype(np.float32)
    d = np.tile(np.float32([0, -1, 0]), (n, 1))
    tilt = n // 2
    d[tilt:] += rng.normal(0, 0.3, (n - tilt, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return cs, _v3(o, device), _v3(d, device), tilt


def test_sweeps_keep_the_tie_breaks_on_exact_t_ties(cuda):
    c = 64
    cs, o, d, tilt = _tie_grid(cuda, c)
    cr = tc.block_cull(cs, o, d, 1e-3, 1e16)
    tri, _ = _sweeps_equal_plain(cs, cr, c)
    assert int((tri[:tilt] >= 0).sum()) == tilt  # every straight ray lands on the grid


def test_sweeps_skip_members_no_ray_can_run(cuda):
    # three walls of 512 triangles (one entry each at c = 64) at z = 0, 10,
    # 20; every ray meets the first, whose hit closes the key gate of the
    # other two though their cull bits are set
    c = 64
    tris = []
    for z in (0.0, 10.0, 20.0):
        for i in range(16):
            for j in range(16):
                a, b, e, f = (i - 8, j - 8, z), (i - 7, j - 8, z), (i - 8, j - 7, z), (i - 7, j - 7, z)
                tris += [(a, b, e), (b, f, e)]
    v = np.asarray(tris, np.float32)
    cs = build_clusters(v[:, 0], v[:, 1], v[:, 2], len(v), cuda, cluster_size=c)
    rng = np.random.default_rng(7)
    n = 4096
    o = np.concatenate([rng.uniform(-2, 2, (n, 2)), np.full((n, 1), -5.0)], 1).astype(np.float32)
    d = (np.float32([0, 0, 1]) + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cr = tc.block_cull(cs, _v3(o, cuda), _v3(d, cuda), 1e-3, 1e16)
    tri, vis = _sweeps_equal_plain(cs, cr, c)
    assert bool((tri >= 0)[:n].all())
    live = torch.arange(cr.ids.shape[1], device=cuda)[None] < cr.count
    words = torch.stack([cr.bits_lo, cr.bits_hi]).to(torch.int64) & 0xFFFFFFFF
    scheduled = int(sum(((words >> b) & 1)[:, live].sum() for b in range(32)))
    work = tc.sweep_work(cs.rows, cs.xf_inv, cr, c)
    assert int(vis.sum()) == work.visits < scheduled


def test_sweeps_refuse_a_cluster_size_not_a_multiple_of_4(cuda):
    cs, o, d, t_max = _scene_and_rays(cuda, 62, n=256)
    cr = tc.block_cull(cs, o, d, 1e-3, t_max)
    with pytest.raises(ValueError, match="multiple of 4"):
        tc.closest_sweep(cs.rows, cs.xf_inv, cr, 62)
    with pytest.raises(ValueError, match="multiple of 4"):
        tc.any_sweep(cs.rows, cs.xf_inv, cr, 62)


def test_closest_hit_matches_oracle(cuda):
    cs, o, d, t_max = _scene_and_rays(cuda, 128, seed=1)
    got = tc.closest_hit_cluster(cs, o, d, 1e-3, t_max)
    want = tc.reference_closest(cs, o, d, 1e-3, t_max)
    assert torch.equal(got.tri, want.tri)
    occ, _ = tc.any_hit_cluster(cs, o, d, 1e-3, t_max)
    assert torch.equal(occ, want.tri >= 0)


def test_wrappers_check_their_inputs(cuda):
    cs, o, d, t_max = _scene_and_rays(cuda, 64, n=256)
    rays8 = tc._pack_rays8(cs, o, d, 1e-3, t_max)
    with pytest.raises(TypeError):
        tc.cull_blocks(rays8.double(), *cs.cull_tables)
    with pytest.raises(ValueError):
        tc.cull_blocks(rays8.t().contiguous().t(), *cs.cull_tables)
    with pytest.raises(ValueError):  # not a whole number of 128-ray blocks
        tc.cull_blocks(rays8[:100], *cs.cull_tables)
    with pytest.raises(ValueError):  # group boxes of another table
        tc.cull_blocks(rays8, cs.cull_tables[0], cs.cull_tables[1][:, :-1].contiguous())
    with pytest.raises(ValueError):  # a ray must start on a 16-byte boundary
        tc.cull_blocks(torch.cat([rays8.reshape(-1)[:1], rays8.reshape(-1)])[1:].reshape(-1, 8),
                       *cs.cull_tables)


def _cull_table(device, groups, seed):
    """A member-major (8, groups*8) box table from a seed, the last group
    padded with the node tables' far-sentinel boxes, and its group boxes."""
    rng = np.random.default_rng(seed)
    m = groups * 8
    t = np.zeros((8, m), np.float32)
    t[0:3] = rng.uniform(-4, 4, (3, m))
    t[4:7] = rng.uniform(0.0, 0.8, (3, m)) * (rng.random((3, m)) > 0.1)  # some flat boxes
    t[3] = np.linalg.norm(t[4:7], axis=0)
    for k in range(5, 8):  # members 5-7 of the last group
        t[:, k * groups + groups - 1] = 0.0
        t[0, k * groups + groups - 1] = 1.5e37
    sph_t = torch.as_tensor(t, device=device)
    return sph_t, tc.group_boxes(sph_t)


def _assert_cull_equal(rays8, sph_t, grp_t):
    got = tc.cull_blocks(rays8, sph_t, grp_t)
    want = tc._cull_torch(rays8, sph_t)
    for name, k, p in zip(("key", "lo", "hi", "count"), got, want):
        if name == "key":  # a NaN key (NaN origins) equals a NaN key
            assert torch.equal(torch.isnan(k), torch.isnan(p))
            k, p = torch.nan_to_num(k, nan=0.0), torch.nan_to_num(p, nan=0.0)
        assert torch.equal(k, p), name
    return want


# 9, 33: one group beyond a row of 8 / 32 lanes; 74, 530: the city's supers, the big scene's nodes
@pytest.mark.parametrize("nr", [8, 24])
@pytest.mark.parametrize("groups", [1, 9, 32, 33, 74, 530])
def test_cull_bit_equal_on_hostile_rays(cuda, groups, nr):
    sph_t, grp_t = _cull_table(cuda, groups, seed=groups)
    rays8 = torch.as_tensor(hostile_rays8(100 + groups, nr, sph_t.cpu().numpy()), device=cuda)
    key, lo, hi, count = _assert_cull_equal(rays8, sph_t, grp_t)
    assert int(count.sum()) > 0 and int(count[4]) == 0  # block 4: every ray dead
    assert bool(torch.isnan(key).any()) and bool((lo != 0).any()) and bool((hi != 0).any())


def test_cull_more_groups_than_one_chunk(cuda):
    # 1100 groups: the kernel's shared lists hold 1024, so it takes two passes
    sph_t, grp_t = _cull_table(cuda, 1100, seed=5)
    rays8 = torch.as_tensor(hostile_rays8(6, 8, sph_t.cpu().numpy()), device=cuda)
    _assert_cull_equal(rays8, sph_t, grp_t)


@pytest.mark.parametrize("case", ["every ray dead", "one live ray per sub-block"])
def test_cull_sparse_blocks(cuda, case):
    sph_t, grp_t = _cull_table(cuda, 74, seed=7)
    rays8 = torch.as_tensor(hostile_rays8(8, 8, sph_t.cpu().numpy()), device=cuda)
    lane = torch.arange(rays8.shape[0], device=cuda) % 16
    if case == "every ray dead":
        rays8[:, 7] = 0.0
    else:
        rays8[:, 0:3] = rays8[:, 0:3].nan_to_num(0.0, 1.0, -1.0)
        rays8[:, 7] = torch.where(lane == 5, 9.0, 0.0)
    key, lo, hi, count = _assert_cull_equal(rays8, sph_t, grp_t)
    if case == "every ray dead":
        assert int(count.sum()) == 0 and bool((key == 3.0e37).all()) and not bool((lo | hi).any())
    else:
        assert int(count.sum()) > 0


def _hier_sweeps_equal_plain(cs, cr, c):
    """K4a and K4b bit-equal to their plain versions on a NodeCullResult, and
    K4a's vis equal to the counted visits. Returns (tri, occ, SweepWork of K4a)."""
    nt = cs.node_tables
    t_k, tri_k, vis = tc.closest_hier_sweep(cs.rows, cs.xf_inv, nt, cr, c)
    t_p, tri_p = tc._closest_hier_torch(cs.rows, cs.xf_inv, nt, cr, c)
    assert torch.equal(t_k, t_p) and torch.equal(tri_k, tri_p)
    work = tc.sweep_work_hier(cs.rows, cs.xf_inv, nt, cr, c)
    assert int(vis.sum()) == work.visits
    occ_k = tc.any_hier_sweep(cs.rows, cs.xf_inv, nt, cr, c)
    assert torch.equal(occ_k, tc._any_hier_torch(cs.rows, cs.xf_inv, nt, cr, c))
    return tri_k, occ_k, work


# 1024: the largest cluster size (36 KiB of staged rows); 60: C % 4 == 0 but not a power of two
@pytest.mark.parametrize("cluster_size,n_tris", [(8, 3000), (32, 3000), (256, 20000), (60, 6000),
                                                 (64, 6000), (1024, 80000)])
def test_hier_kernels_bit_equal_to_plain(cuda, cluster_size, n_tris):
    # several nodes, the last one padded with sentinel entries; 20 % dead rays
    cs, o, d, t_max = _scene_and_rays(cuda, cluster_size, seed=2, t=n_tris)
    assert cs.num_entries > tc.NODE and cs.num_entries % tc.NODE != 0
    before = dict(tc.launch_counts)
    cr = tc.block_cull_nodes(cs, o, d, 1e-3, t_max)
    tri_k, occ_k, work = _hier_sweeps_equal_plain(cs, cr, cluster_size)
    assert work.visits > 0 and int((tri_k >= 0).sum()) > 0
    assert int(occ_k.sum()) > 0
    after = dict(tc.launch_counts)
    for name in ("cull", "closest_hier", "any_hier"):
        assert after[name] - before.get(name, 0) == 1


def test_hier_sweeps_keep_the_tie_breaks_on_exact_t_ties(cuda):
    c = 16  # 256 clusters, 32 entries, 4 nodes: the copy lies in other nodes
    cs, o, d, tilt = _tie_grid(cuda, c)
    assert cs.num_entries == 4 * tc.NODE
    cr = tc.block_cull_nodes(cs, o, d, 1e-3, 1e16)
    tri, occ, _ = _hier_sweeps_equal_plain(cs, cr, c)
    assert int((tri[:tilt] >= 0).sum()) == tilt  # every straight ray lands on the grid
    assert torch.equal(occ[:tilt], torch.ones_like(occ[:tilt]))


def test_hier_sweeps_skip_members_no_ray_can_run(cuda):
    # three walls of 1024 triangles (one node each at c = 16) at z = 0, 10, 20;
    # the first spans x < 0 only. A ray at x < 0 meets it, and its hit closes
    # the ray's interval before the second wall's node, whose cull bits are
    # set for it; the rays at x > 0 keep every block walking to that node.
    # Shadow rays stop in whichever member they first hit, so later members
    # are named only by rays occluded earlier in the same node.
    c = 16
    tris = []
    for z, x0, dx in ((0.0, -8.0, 0.25), (10.0, -8.0, 0.5), (20.0, -8.0, 0.5)):
        for i in range(32):
            for j in range(16):
                xa, xb, ya, yb = x0 + i * dx, x0 + (i + 1) * dx, j - 8.0, j - 7.0
                tris += [((xa, ya, z), (xb, ya, z), (xa, yb, z)), ((xb, ya, z), (xb, yb, z), (xa, yb, z))]
    v = np.asarray(tris, np.float32)
    cs = build_clusters(v[:, 0], v[:, 1], v[:, 2], len(v), cuda, cluster_size=c)
    assert cs.num_entries == 3 * tc.NODE
    rng = np.random.default_rng(7)
    n = 4096
    o = np.concatenate([rng.uniform(-2, 2, (n, 2)), np.full((n, 1), -5.0)], 1).astype(np.float32)
    d = (np.float32([0, 0, 1]) + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cr = tc.block_cull_nodes(cs, _v3(o, cuda), _v3(d, cuda), 1e-3, 1e16)
    tri, occ, work = _hier_sweeps_equal_plain(cs, cr, c)
    assert bool((tri >= 0)[:n].all()) and bool((occ[:n] == 1).all())
    live_blocks = int((cr.count > 0).sum())
    assert work.nodes >= 2 * live_blocks  # every block walks on to the second wall's node
    # K4a runs a member for the rays its re-cull names, not for every ray of
    # every block: fewer visits than (sub-block, member) pairs of visited nodes
    assert 0 < work.visits < work.nodes * 8 * tc.NODE * tc.SUPER
    shadow = tc.sweep_work_hier(cs.rows, cs.xf_inv, cs.node_tables, cr, c, any_hit=True)
    assert 0 < shadow.staged < work.staged  # members no unoccluded ray names are not needed


def test_hier_kernels_take_a_block_of_dead_rays(cuda):
    cs, o, d, t_max = _scene_and_rays(cuda, 32, seed=5)
    t_max = t_max.clone()
    dead = slice(3 * tc.BLOCK, 5 * tc.BLOCK)  # blocks 3 and 4: t_max <= t_min for every ray
    t_max[dead] = 0.0
    cr = tc.block_cull_nodes(cs, o, d, 1e-3, t_max)
    assert int(cr.count[3, 0]) == 0 and int(cr.count[4, 0]) == 0
    tri, occ, work = _hier_sweeps_equal_plain(cs, cr, 32)
    assert bool((tri[dead] == -1).all()) and bool((occ[dead] == 0).all())
    assert work.visits > 0


def test_hier_kernels_walk_a_last_node_of_one_entry(cuda):
    # 9 entries: the second node holds one entry and 7 far-sentinel entries
    cs, o, d, t_max = _scene_and_rays(cuda, 32, seed=8, t=2100)
    assert cs.num_entries == tc.NODE + 1
    cr = tc.block_cull_nodes(cs, o, d, 1e-3, t_max)
    tri, _, _ = _hier_sweeps_equal_plain(cs, cr, 32)
    last = tri // (tc.SUPER * 32) == tc.NODE  # winners in the last node's one entry
    assert int(last.sum()) > 0 and int(tri.max()) < cs.num_entries * tc.SUPER * 32


def test_hier_sweeps_refuse_a_cluster_size_not_a_multiple_of_4(cuda):
    cs, o, d, t_max = _scene_and_rays(cuda, 62, n=256)
    cr = tc.block_cull_nodes(cs, o, d, 1e-3, t_max)
    with pytest.raises(ValueError, match="multiple of 4"):
        tc.closest_hier_sweep(cs.rows, cs.xf_inv, cs.node_tables, cr, 62)
    with pytest.raises(ValueError, match="multiple of 4"):
        tc.any_hier_sweep(cs.rows, cs.xf_inv, cs.node_tables, cr, 62)


def test_hier_none_takes_the_node_kernels(cuda, monkeypatch):
    cs, o, d, t_max = _scene_and_rays(cuda, 32, seed=3)
    monkeypatch.setattr(tc, "HIER_MIN_ENTRIES", cs.num_entries)
    before = dict(tc.launch_counts)
    got = tc.closest_hit_cluster(cs, o, d, 1e-3, t_max)
    occ, _ = tc.any_hit_cluster(cs, o, d, 1e-3, t_max)
    want = tc.reference_closest(cs, o, d, 1e-3, t_max)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(occ, want.tri >= 0)
    after = dict(tc.launch_counts)
    assert after["closest_hier"] - before.get("closest_hier", 0) == 1
    assert after["any_hier"] - before.get("any_hier", 0) == 1
    assert after.get("closest", 0) == before.get("closest", 0)


# (n, capacity, probability of a set flag). n: flags (K5a; K5b takes n // 8
# rows), or "wave-1" / "wave+1": one element either side of the kernel's
# one-wave size (blocks per SM x SMs x 1024 threads x 16 flags or 4 words),
# decided on the card. capacity: a fraction of the count, or ("n", k): k x n.
# One block, several blocks with a ragged edge, 2M flags, no input, capacity
# 0, capacity 5 n, and a wave's edge. K5b stages a vector's set bits in
# shared memory up to 8192 of its 131,072 bits and writes denser vectors in
# place: p = 0.01 stages every vector, p = 0.0625 about half, p >= 0.1 none.
WORKLIST_CASES = [(1000, 2.0, 0.3), (5000, 0.5, 0.5), (70001, 1.0, 0.0), (70001, 0.25, 1.0),
                  (2_000_000, 1.5, 0.1), (2_000_000, 0.5, 0.6), (0, 1.0, 0.5), (3000, 0.0, 0.5),
                  (3000, ("n", 5), 0.3), ("wave-1", 1.0, 0.4), ("wave+1", 0.7, 0.4),
                  (2_000_000, 0.8, 0.01), ("wave+1", 0.9, 0.01), (400_000, 1.0, 0.0625)]
_PER_VEC = {"compact": sw.FLAGS_PER_VEC, "pair_worklist": sw.WORDS_PER_VEC}


def _worklist_size(kind, n, device):
    """Flags (compact) or rows (pair_worklist) of a WORKLIST_CASES entry."""
    if isinstance(n, str):
        dev_idx = device.index if device.index is not None else torch.cuda.current_device()
        wave = sw.max_blocks(dev_idx, kind) * sw.THREADS * _PER_VEC[kind]
        return wave - 1 if n == "wave-1" else wave + 1
    return n if kind == "compact" else n // 8


def _capacity(cap, count, n):
    return cap[1] * n if isinstance(cap, tuple) else int(cap * max(1, count))


def _flags(n, p, seed, device):
    return torch.as_tensor(np.random.default_rng(seed).random(n) < p, device=device)


def _words(r, p, seed, device):
    b = np.random.default_rng(seed).random((r, 32)) < p
    bits = (b.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    return torch.as_tensor(bits.view(np.int32), device=device)


def _assert_worklist_equal(kind, x, cap):
    fn, plain = ((sw.compact_indices, sw.compact_indices_torch) if kind == "compact"
                 else (sw.pair_worklist, sw.pair_worklist_torch))
    got, want = fn(x, cap), plain(x, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    return got


@pytest.mark.parametrize("n, cap, p", WORKLIST_CASES)
def test_compact_kernel_bit_equal_to_plain(cuda, n, cap, p):
    n = _worklist_size("compact", n, cuda)
    flags = _flags(n, p, n, cuda)
    cap = _capacity(cap, int(flags.sum()), n)
    before = sw.launch_counts["compact"]
    _, cnt = _assert_worklist_equal("compact", flags, cap)
    assert int(cnt) == int(flags.sum())  # even above the capacity
    assert sw.launch_counts["compact"] == before + 1


@pytest.mark.parametrize("n, cap, p", WORKLIST_CASES)
def test_pair_worklist_kernel_bit_equal_to_plain(cuda, n, cap, p):
    r = _worklist_size("pair_worklist", n, cuda)
    words = _words(r, p, r, cuda)
    count = int(sum(int(((words >> b) & 1).sum()) for b in range(32)))
    cap = _capacity(cap, count, r)
    before = sw.launch_counts["pair_worklist"]
    got = _assert_worklist_equal("pair_worklist", words, cap)
    assert int(got[2]) == count
    assert sw.launch_counts["pair_worklist"] == before + 1


def test_worklist_kernels_refuse_an_input_off_16_bytes(cuda):
    flags = _flags(1000, 0.5, 1, cuda)
    words = _words(1000, 0.5, 1, cuda)
    with pytest.raises(ValueError, match="16-byte"):
        sw.compact_indices(flags[3:], 100)
    with pytest.raises(ValueError, match="16-byte"):
        sw.pair_worklist(words[1:], 100)
    _assert_worklist_equal("compact", flags[16:], 700)  # a slice on a boundary is taken
    _assert_worklist_equal("pair_worklist", words[4:], 9000)


@pytest.mark.parametrize("kind", ["compact", "pair_worklist"])
def test_worklist_kernels_back_to_back_and_on_two_streams(cuda, kind):
    make = _flags if kind == "compact" else _words
    xs = [make(300_000, p, seed, cuda) for seed, p in ((1, 0.3), (2, 0.7))]
    for x in xs:  # back to back on one stream, each with its own buffer
        _assert_worklist_equal(kind, x, 250_000)
    fn = sw.compact_indices if kind == "compact" else sw.pair_worklist
    plain = sw.compact_indices_torch if kind == "compact" else sw.pair_worklist_torch
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    torch.cuda.synchronize()
    outs = []
    for x, st in zip(xs, streams):
        with torch.cuda.stream(st):
            outs.append(fn(x, 250_000))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        for g, w in zip(got, plain(x, 250_000)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["compact", "pair_worklist"])
def test_worklist_call_is_one_device_kernel(cuda, kind):
    from torch.profiler import ProfilerActivity, profile

    x = (_flags if kind == "compact" else _words)(1_000_000, 0.4, 3, cuda)
    fn = sw.compact_indices if kind == "compact" else sw.pair_worklist
    fn(x, 500_000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x, 500_000)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and ("compact_kernel" if kind == "compact" else "pair_kernel") in on_card[0]


@pytest.mark.parametrize("rows, width, n", [(1 << 20, 128, 1 << 16), (5000, 7, 4099), (64, 4, 0)])
def test_gather_kernel_bit_equal_to_plain(cuda, rows, width, n):
    rng = np.random.default_rng(rows)
    table = torch.as_tensor(rng.standard_normal((rows, width)).astype(np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(0, rows, n).astype(np.int32), device=cuda)
    before = gather.launch_counts["gather"]
    got = gather.gather_rows(table, idx)
    assert torch.equal(got, gather.gather_rows_torch(table, idx))
    assert gather.launch_counts["gather"] == before + (n > 0)  # no launch for no rows


# ---- the quality pipeline's plain tensor code: the card against the CPU ----

def _u32_words(n, seed):
    w = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    w[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    return torch.as_tensor(w)


def _same_bits(got, want):
    got = got.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_sobol_bits_card_equal_cpu(cuda):
    from optixpathtracer_tpu_torch.core import sobol

    args = [_u32_words(1 << 18, s) for s in range(4)]
    for fn in (sobol.sobol02_bits, sobol.sobol02_point):
        for g, w in zip(fn(*(a.to(cuda) for a in args)), fn(*args)):
            _same_bits(g, w)
    for fn in (sobol.reverse_bits32, sobol._sobol_dim2, sobol._u32_to_unit):
        _same_bits(fn(args[0].to(cuda)), fn(args[0]))


@pytest.mark.parametrize("sampling, m", [("stratified", 9), ("stratified", 16), ("blue", 16), ("blue", 36)])
def test_ld_bases_and_sobol_pair_card_equal_cpu(cuda, sampling, m):
    from optixpathtracer_tpu_torch.engine import wavefront as wf

    pix, ctr = _u32_words(1 << 16, 5) % (1200 * 800), _u32_words(1 << 16, 6)
    cfg = wf.RenderConfig(sampling=sampling, sampling_strata=m)
    for salt in (wf._LD_SALT_AA, wf._LD_SALT_NEE, wf._LD_SALT_BSDF):
        got = wf._ld_bases(cfg, pix.to(cuda), ctr.to(cuda), salt)
        want = wf._ld_bases(cfg, pix, ctr, salt)
        _same_bits(got[0], want[0])
        _same_bits(got[1], want[1])
        assert got[2] == want[2]
        for depth in (0, 4):
            for g, w in zip(wf._sobol_pair(pix.to(cuda), ctr.to(cuda), depth, salt),
                            wf._sobol_pair(pix, ctr, depth, salt)):
                _same_bits(g, w)


@pytest.mark.parametrize("kw", [{}, dict(iterations=1, demodulate=True),
                                dict(variance=True, sigma_color=4.0, var_boost=256.0, demodulate=True),
                                dict(depth=True, sigma_color=4.0, sigma_albedo=1.0, demodulate=True)])
def test_atrous_denoise_card_matches_cpu(cuda, kw):
    """rtol 1e-4 / atol 1e-6: the card's exp and its scalar divisions (taken
    as a product with the reciprocal) round a few ulps from the CPU's."""
    from optixpathtracer_tpu_torch.ops.denoise import atrous_denoise

    rng = np.random.default_rng(7)
    h, w = 96, 128
    color, normal, albedo = (torch.as_tensor(rng.random((h, w, 3)).astype(np.float32)) for _ in range(3))
    kw = dict(kw)
    if kw.pop("variance", False):
        kw["variance"] = torch.as_tensor((rng.random((h, w)) * 0.02).astype(np.float32))
    if kw.pop("depth", False):
        kw["depth"] = torch.as_tensor(rng.uniform(0, 20, (h, w)).astype(np.float32))
    want = atrous_denoise(color, normal, albedo, **kw)
    got = atrous_denoise(color.to(cuda), normal.to(cuda), albedo.to(cuda),
                         **{k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


def _loft(device, c):
    """scenes/loft.obj compiled with cluster size c, its bounding box and
    its (3, N, 3) triangle corners."""
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.io.obj import load_obj

    hs = load_obj(scenes.LOFT_OBJ)
    corners = np.stack(hs.flatten()["v"])
    lo, hi = corners.reshape(-1, 3).min(0), corners.reshape(-1, 3).max(0)
    return compile_scene(hs, device, leaf_size=8, cluster_size=c).clusters, lo, hi, corners


def _room_rays(lo, hi, n, seed):
    """n rays from inside the room (its box shrunk to 85 %) in every direction."""
    rng = np.random.default_rng(seed)
    c, half = (lo + hi) / 2, (hi - lo) / 2
    o = (c + rng.uniform(-0.85, 0.85, (n, 3)) * half).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _cull_and_sweeps_equal_plain(cs, o, d, t_min, t_max, c):
    rays8 = tc._pack_rays8(cs, o, d, t_min, t_max)
    for k, p in zip(tc.cull_blocks(rays8, *cs.cull_tables), tc._cull_torch(rays8, cs.cull_tables[0])):
        assert torch.equal(k, p)
    cr = tc.block_cull(cs, o, d, t_min, t_max)
    tri_k, _ = _sweeps_equal_plain(cs, cr, c)
    return tri_k[: o.x.shape[0]], tc.any_sweep(cs.rows, cs.xf_inv, cr, c)[: o.x.shape[0]]


@pytest.mark.parametrize("c", [64, 256])
def test_loft_closed_room_rays_bit_equal_to_plain(cuda, c):
    """K1 (cluster boxes), K2 and K3 on rays from inside the closed loft:
    every ray hits a wall or the furniture."""
    cs, lo, hi, _ = _loft(cuda, c)
    o, d = _room_rays(lo, hi, 8192, seed=1)
    tri, occ = _cull_and_sweeps_equal_plain(cs, _v3(o, cuda), _v3(d, cuda), 1e-3, 1e16, c)
    assert bool((tri >= 0).all()) and bool((occ > 0).all())


@pytest.mark.parametrize("c", [64, 256])
def test_loft_shadow_rays_ending_at_a_wall(cuda, c):
    """Shadow rays (t_min = shadow_t_min = 0.01) that end within
    shadow_t_min of the wall they point at (t_max = t_hit + k * 0.004, k in
    -3..3: short of it, on it, past it), and rays leaving a wall from its
    hit point, where the wall lies inside t_min."""
    cs, lo, hi, _ = _loft(cuda, c)
    o, d = _room_rays(lo, hi, 4096, seed=2)
    ov, dv = _v3(o, cuda), _v3(d, cuda)
    rec = tc.closest_hit_cluster(cs, ov, dv, 1e-3, 1e16, hier=False)
    t_hit = rec.t.cpu().numpy()
    k = np.random.default_rng(3).integers(-3, 4, len(t_hit))
    t_max = torch.as_tensor((t_hit + k * 0.004).astype(np.float32), device=cuda)
    _, occ = _cull_and_sweeps_equal_plain(cs, ov, dv, 0.01, t_max, c)
    occ = occ.cpu().numpy() > 0
    far = t_hit > 0.02  # a wall closer than t_min is skipped
    assert occ[far & (k > 0)].all() and not occ[far & (k < 0)].any()  # only a ray past the wall is occluded
    p = (o + d * t_hit[:, None]).astype(np.float32)
    d2 = -d + np.random.default_rng(4).normal(0, 0.5, d.shape).astype(np.float32)
    _cull_and_sweeps_equal_plain(cs, _v3(p, cuda), _v3(d2 / np.linalg.norm(d2, axis=1, keepdims=True), cuda),
                                 0.01, 1e16, c)


@pytest.mark.parametrize("c", [64, 256])
def test_loft_coplanar_walls_exact_t_ties(cuda, c):
    """Rays aimed at the loft's triangle vertices and edge midpoints: the
    triangles of a wall that share the point tie exactly on t, and K2 must
    break the tie as its plain version does (lowest column, then the first
    cluster visited)."""
    cs, lo, hi, corners = _loft(cuda, c)
    targets = np.concatenate([corners.reshape(-1, 3), ((corners + np.roll(corners, 1, axis=0)) / 2).reshape(-1, 3)])
    rng = np.random.default_rng(5)
    targets = targets[rng.choice(len(targets), 8192)]
    o, _ = _room_rays(lo, hi, len(targets), seed=6)
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri, _ = _cull_and_sweeps_equal_plain(cs, _v3(o, cuda), _v3(d.astype(np.float32), cuda), 1e-3, 1e16, c)
    assert bool((tri >= 0).all())
