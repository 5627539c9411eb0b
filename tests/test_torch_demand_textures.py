"""Port parity, io/demand: the demand-loaded sparse texture pool.

The same sources and request sequences drive the JAX pager and the port's:
afterwards their page tables, slot -> page maps, load / eviction counts and
pool rows are equal bit for bit. `sample_demand` on the same lanes (the
nearest level, a given LOD, trilinear, partial residency, wrap seams,
tex_id < 0) gives colours within atol 1e-6 (rtol 0) and equal resident
masks and usage bitmaps; the JAX pager's own state also goes through the
port's sampler by `interop`. Then the reference's twelve cases of
tests/test_demand_textures.py, on the port (CPU tensors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.io import demand as jd
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.io import demand as td
from optixpathtracer_tpu_torch.io.demand import (
    STORE,
    TILE,
    ArraySource,
    CheckerBoardSource,
    DemandTextureManager,
    MandelbrotSource,
    sample_demand,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rgb(c):
    return np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)


def _sources(mod):
    """Three textures of `mod`'s source classes: an image that is no
    multiple of TILE, a checkerboard and a small Mandelbrot."""
    img = np.random.default_rng(7).uniform(0, 1, (150, 200, 3)).astype(np.float32)
    return [mod.ArraySource(img), mod.CheckerBoardSource(width=4 * TILE, height=3 * TILE, squares_per_side=6),
            mod.MandelbrotSource(width=128, height=96, max_iter=12)]


def _lanes(seed, n=2048):
    """tex ids in -1..2; u, v uniform in [-2, 3] with integers and values
    next to the wrap seams mixed in; a lod in [-0.5, 4]."""
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-2, 3, (2, n)).astype(np.float32)
    eps = np.float32(1e-4)
    edge = rng.choice(np.array([0.0, 1.0, -1.0, 2.0, eps, 1 - eps, -eps, 1 + eps], np.float32), (2, n))
    pick = rng.random((2, n)) < 0.2
    uv[pick] = edge[pick]
    lod = rng.uniform(-0.5, 4.0, n).astype(np.float32)
    return tid, uv[0], uv[1], lod


MODES = {"base": (False, False), "nearest_lod": (True, False), "trilinear": (True, True)}


def _sample_both(jmgr, tmgr, lanes, mode, pool=None):
    use_lod, tri = MODES[mode]
    tid, u, v, lod = lanes
    jl = jnp.asarray(lod) if use_lod else None
    tl = torch.as_tensor(lod) if use_lod else None
    jc, jr, ju = jd.sample_demand(jmgr.pool, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v), jl, tri)
    tc, tr, tu = sample_demand(pool if pool is not None else tmgr.pool, torch.as_tensor(tid),
                               torch.as_tensor(u), torch.as_tensor(v), tl, tri)
    return (_rgb(jc), np.asarray(jr), np.asarray(ju)), (_rgb(tc), tr.numpy(), tu.numpy())


def _assert_same_state(jmgr, tmgr):
    np.testing.assert_array_equal(tmgr._page_table, jmgr._page_table)
    np.testing.assert_array_equal(tmgr._slot_page, jmgr._slot_page)
    np.testing.assert_array_equal(tmgr._slot_used, jmgr._slot_used)
    assert (tmgr.pages_loaded, tmgr.pages_evicted) == (jmgr.pages_loaded, jmgr.pages_evicted)
    for k in jd.DemandTexturePool._fields:
        np.testing.assert_array_equal(getattr(tmgr.pool, k).numpy(), np.asarray(getattr(jmgr.pool, k)),
                                      err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_pager_and_sampler_match_jax(mode):
    """Five launches' usage serviced by both pagers (capacity 20 of 43
    pages over 3 levels: evictions happen), sampled before and after."""
    jmgr = jd.DemandTextureManager(_sources(jd), capacity=20, levels=3)
    tmgr = DemandTextureManager(_sources(td), capacity=20, levels=3, device=CPU)
    assert tmgr.num_pages == jmgr.num_pages
    _assert_same_state(jmgr, tmgr)
    for step in range(5):
        want, got = _sample_both(jmgr, tmgr, _lanes(100 + step), mode)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert jmgr.process_requests(want[2]) == tmgr.process_requests(torch.as_tensor(got[2]))
        _assert_same_state(jmgr, tmgr)
    assert tmgr.pages_evicted > 0 and got[1].any() and not got[1].all()


def test_jax_pager_state_through_the_ports_sampler():
    """The JAX pager's pool after two serviced launches, carried across by
    `interop`, sampled by the port: the JAX sampler's colours (atol 1e-6),
    resident masks and usage on trilinear lanes."""
    jmgr = jd.DemandTextureManager(_sources(jd), capacity=48, levels=3)
    for step in range(2):
        tid, u, v, lod = _lanes(200 + step)
        _, _, usage = jd.sample_demand(jmgr.pool, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(lod), True)
        jmgr.process_requests(usage)
    pool = interop.demand_pool_from_arrays(interop.demand_pool_arrays(jmgr.pool), CPU)
    want, got = _sample_both(jmgr, None, _lanes(300), "trilinear", pool=pool)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].any() and not got[1].all()


# ---- the reference's cases (tests/test_demand_textures.py), on the port ----

def ref_bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Full-image wrap bilinear, float32 math (mirrors TexturePool)."""
    h, w = img.shape[:2]
    uu = (u.astype(np.float32) % np.float32(1.0)) * np.float32(w) - np.float32(0.5)
    vv = (v.astype(np.float32) % np.float32(1.0)) * np.float32(h) - np.float32(0.5)
    x0 = np.floor(uu)
    y0 = np.floor(vv)
    fx = (uu - x0)[:, None]
    fy = (vv - y0)[:, None]

    def at(x, y):
        return img[np.mod(y.astype(np.int64), h), np.mod(x.astype(np.int64), w)]

    top = at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx
    bot = at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _sample(mgr, tid, u, v, lod=None, trilinear=False):
    c, r, q = sample_demand(mgr.pool, *_t(tid, u, v), None if lod is None else torch.as_tensor(lod),
                            trilinear)
    return _rgb(c), r.numpy(), q.numpy()


@pytest.fixture(scope="module")
def mgr_and_img():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (130, 200, 3)).astype(np.float32)  # no multiple of TILE
    return DemandTextureManager([ArraySource(img)], capacity=64, device=CPU), img


def _uvs(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, n).astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def test_miss_then_resident_exact(mgr_and_img):
    mgr, img = mgr_and_img
    u, v = _uvs()
    tid = np.zeros(u.shape, np.int32)
    color, resident, req = _sample(mgr, tid, u, v)
    assert not resident.any()
    np.testing.assert_allclose(color[:, 0], mgr.pool.fallback[0, 0].item(), rtol=1e-6)
    n_req = int(req.sum())
    assert n_req > 0
    assert mgr.process_requests(req) == n_req
    color2, resident2, req2 = _sample(mgr, tid, u, v)
    assert resident2.all()
    assert int(req2.sum()) == n_req  # resident pages are still reported
    assert mgr.process_requests(req2) == 0
    np.testing.assert_allclose(color2, ref_bilinear(img, u, v), atol=1e-5)


def test_wrap_seams_exact(mgr_and_img):
    mgr, img = mgr_and_img
    eps = np.float32(1e-4)
    u = np.array([0.0 + eps, 1.0 - eps, 0.5, TILE / 200 + eps, TILE / 200 - eps], np.float32)
    v = np.array([1.0 - eps, 0.0 + eps, TILE / 130, 0.7, 0.3], np.float32)
    tid = np.zeros(u.shape, np.int32)
    mgr.process_requests(_sample(mgr, tid, u, v)[2])
    color, resident, _ = _sample(mgr, tid, u, v)
    assert resident.all()
    np.testing.assert_allclose(color, ref_bilinear(img, u, v), atol=1e-5)


def test_negative_texid_white_no_request(mgr_and_img):
    mgr, _ = mgr_and_img
    u, v = _uvs(64)
    color, resident, req = _sample(mgr, np.full(u.shape, -1, np.int32), u, v)
    assert not resident.any() and int(req.sum()) == 0
    np.testing.assert_allclose(color[:, 0], 1.0)


def test_lru_eviction_keeps_serving():
    img = np.random.default_rng(0).uniform(0, 1, (4 * TILE, 4 * TILE, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=4, device=CPU)
    u, v = _uvs(512, seed=1)
    tid = np.zeros(u.shape, np.int32)
    assert mgr.num_pages == 16
    for _ in range(8):
        if not mgr.process_requests(_sample(mgr, tid, u, v)[2]):
            break
    assert mgr.pages_evicted > 0
    assert (mgr.pool.page_table.numpy() >= 0).sum() <= 4
    color, res, _ = _sample(mgr, tid, u, v)
    assert res.any()
    np.testing.assert_allclose(color[res], ref_bilinear(img, u, v)[res], atol=1e-5)


def test_multi_texture_page_spaces():
    rng = np.random.default_rng(5)
    img_a = rng.uniform(0, 1, (TILE, TILE, 3)).astype(np.float32)
    img_b = rng.uniform(0, 1, (2 * TILE, TILE, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img_a), ArraySource(img_b)], capacity=8, device=CPU)
    assert mgr.num_pages == 3
    u, v = _uvs(256, seed=9)
    tid = (np.arange(256) % 2).astype(np.int32)
    mgr.process_requests(_sample(mgr, tid, u, v)[2])
    got, resident, _ = _sample(mgr, tid, u, v)
    assert resident.all()
    np.testing.assert_allclose(got[tid == 0], ref_bilinear(img_a, u[tid == 0], v[tid == 0]), atol=1e-5)
    np.testing.assert_allclose(got[tid == 1], ref_bilinear(img_b, u[tid == 1], v[tid == 1]), atol=1e-5)


def test_procedural_sources():
    cb = CheckerBoardSource(width=256, height=256, squares_per_side=8)
    blk = cb.read_texel_block(np.arange(-1, STORE - 1), np.arange(-1, STORE - 1))
    assert blk.shape == (STORE, STORE, 3)
    row = cb.read_texel_block(np.array([0, 31, 32]), np.array([0]))
    assert np.allclose(row[0, 0], row[0, 1]) and not np.allclose(row[0, 0], row[0, 2])
    mb = MandelbrotSource(width=128, height=128, max_iter=16)
    blk2 = mb.read_texel_block(np.arange(0, 64), np.arange(0, 64))
    assert blk2.shape == (64, 64, 3) and np.isfinite(blk2).all()
    x = int((-0.2 + 2.2) / 3.2 * 128)
    y = int((0.0 + 1.6) / 3.2 * 128)
    assert mb.read_texel_block(np.array([x]), np.array([y]))[0, 0, 0] == 1.0


def test_feedback_loop_converges_with_capacity():
    cb = CheckerBoardSource(width=8 * TILE, height=8 * TILE, squares_per_side=8)
    mgr = DemandTextureManager([cb], capacity=70, device=CPU)
    u, v = _uvs(8192, seed=11)
    tid = np.zeros(u.shape, np.int32)
    passes = 0
    while True:
        _, resident, req = _sample(mgr, tid, u, v)
        if resident.all():
            break
        assert mgr.process_requests(req) > 0
        passes += 1
        assert passes <= 3, "feedback loop failed to converge"
    assert passes == 1


def test_lru_hot_pages_survive_eviction():
    img = np.random.default_rng(7).uniform(0, 1, (2 * TILE, 2 * TILE, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=3, device=CPU)
    tid = np.zeros((8,), np.int32)

    def uv_for_page(px, py):
        u = (px * TILE + TILE / 2) / img.shape[1]
        v = (py * TILE + TILE / 2) / img.shape[0]
        return np.full((8,), u, np.float32), np.full((8,), v, np.float32)

    for px in (0, 1):
        mgr.process_requests(_sample(mgr, tid, *uv_for_page(px, 0))[2])
    assert mgr._page_table[0] >= 0 and mgr._page_table[1] >= 0
    for _ in range(3):
        _, resident, req = _sample(mgr, tid, *uv_for_page(0, 0))
        assert resident.all()
        mgr.process_requests(req)
    for px in (0, 1):
        mgr.process_requests(_sample(mgr, tid, *uv_for_page(px, 1))[2])
    assert mgr._page_table[0] >= 0, "hot page was evicted (not LRU)"
    assert mgr._page_table[1] < 0, "idle page should have been evicted"


def _box_mip(img, level):
    k = 1 << level
    h, w = img.shape[:2]
    return img.reshape(h // k, k, w // k, k, 3).mean((1, 3)).astype(np.float32)


def test_mip_levels_exact_and_clamped():
    img = np.random.default_rng(11).uniform(0, 1, (256, 256, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=64, levels=3, device=CPU)
    assert int(mgr.pool.levels[0]) == 3
    u, v = _uvs(2048, seed=13)
    tid = np.zeros(u.shape, np.int32)
    for level in (0, 1, 2):
        lod = np.full(u.shape, float(level), np.float32)
        mgr.process_requests(_sample(mgr, tid, u, v, lod)[2])
        color, resident, _ = _sample(mgr, tid, u, v, lod)
        assert resident.all(), f"level {level} not resident"
        np.testing.assert_allclose(color, ref_bilinear(_box_mip(img, level), u, v), atol=1e-5)
    c_hi, res_hi, _ = _sample(mgr, tid, u, v, np.full(u.shape, 9.0, np.float32))
    assert res_hi.all()
    np.testing.assert_allclose(c_hi, ref_bilinear(_box_mip(img, 2), u, v), atol=1e-5)


def test_mip_coarse_levels_fit_tiny_pools():
    cb = CheckerBoardSource(width=16 * TILE, height=16 * TILE, squares_per_side=16)
    mgr = DemandTextureManager([cb], capacity=6, levels=5, device=CPU)
    u, v = _uvs(4096, seed=17)
    tid = np.zeros(u.shape, np.int32)
    lod = np.full(u.shape, 4.0, np.float32)
    _, _, req = _sample(mgr, tid, u, v, lod)
    assert int(req.sum()) <= 6
    mgr.process_requests(req)
    color, resident, _ = _sample(mgr, tid, u, v, lod)
    assert resident.all()
    lvl_dim = (16 * TILE) >> 4
    base = cb.read_texel_block(np.arange(16 * TILE), np.arange(16 * TILE))
    ref_img = base.reshape(lvl_dim, 16, lvl_dim, 16, 3).mean((1, 3)).astype(np.float32)
    np.testing.assert_allclose(color, ref_bilinear(ref_img, u, v), atol=1e-5)


def test_trilinear_blends_bracketing_levels():
    img = np.random.default_rng(19).uniform(0, 1, (256, 256, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=96, levels=3, device=CPU)
    u, v = _uvs(1024, seed=21)
    tid = np.zeros(u.shape, np.int32)
    for level in (0.0, 1.0, 2.0):
        mgr.process_requests(_sample(mgr, tid, u, v, np.full(u.shape, level, np.float32))[2])
    for level in (0.0, 1.0, 2.0):  # an integer lod: trilinear == nearest
        lod = np.full(u.shape, level, np.float32)
        a, ra, _ = _sample(mgr, tid, u, v, lod, trilinear=True)
        b, rb, _ = _sample(mgr, tid, u, v, lod)
        assert ra.all() and rb.all()
        np.testing.assert_allclose(a, b, atol=1e-6)
    c, res, usage = _sample(mgr, tid, u, v, np.full(u.shape, 0.75, np.float32), trilinear=True)
    assert res.all()
    r0 = ref_bilinear(_box_mip(img, 0), u, v)
    r1 = ref_bilinear(_box_mip(img, 1), u, v)
    np.testing.assert_allclose(c, 0.25 * r0 + 0.75 * r1, atol=1e-5)
    assert set(mgr._page_lvl[np.nonzero(usage)[0]].tolist()) == {0, 1}


def test_trilinear_partial_residency_uses_resident_level():
    img = np.random.default_rng(29).uniform(0, 1, (256, 256, 3)).astype(np.float32)
    mgr = DemandTextureManager([ArraySource(img)], capacity=96, levels=3, device=CPU)
    u, v = _uvs(512, seed=31)
    tid = np.zeros(u.shape, np.int32)
    mgr.process_requests(_sample(mgr, tid, u, v, np.full(u.shape, 1.0, np.float32))[2])
    c, res, usage = _sample(mgr, tid, u, v, np.full(u.shape, 0.5, np.float32), trilinear=True)
    assert res.all()
    np.testing.assert_allclose(c, ref_bilinear(_box_mip(img, 1), u, v), atol=1e-5)
    assert 0 in set(mgr._page_lvl[np.nonzero(usage)[0]].tolist())
