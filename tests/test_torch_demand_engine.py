"""Port parity, demand-loaded textures in the engine: `Renderer(demand=)`,
the settle loop and the page-usage bitmap of `trace_wavefront`.

The port's renderer with a demand pool against the JAX renderer with one
(the JAX side through its exact lockstep backend, as
tests/test_torch_renderer.py) on the reference test's textured quad and box
at 40x32, 2 spp, depth 2 (no glass): the launch's `tex_usage` and the
pagers' page tables equal, and `accum_image` on frames 0 and 1 within
rtol / atol 1e-5 at every pixel whose first-hit albedo agrees to 1e-5, and
within sqrt-space RMSE 1e-5 over all pixels (tests/test_torch_textures.py's
bound for textured renders). The hit's u, v agree to a few ulps only
(ROADMAP's hazards), and this scene's random texture, 186 texels across the
quad, turns one ulp of u into up to 2e-5 of albedo: on frame 0 five of the
3840 values part by up to 1.8e-5, the same with the resident TexturePool
and with the JAX cluster walk, so the pool adds none of it (the port's
demand frame equals its resident frame bit for bit). Then the reference's
cases of tests/test_demand_engine.py on the port: the settle loop makes
frame 0 equal to the resident-TexturePool render (both are wrap bilinear;
only the storage differs, so within 1e-5), without it the fallback shows
and a fresh accumulation converges, a checkpoint resume settles before it
accumulates, chunked launches OR their bitmaps, an undersized pool ends
after a bounded number of launches, and the coherence sort moves no
bitmap. The mip-LOD case, which the JAX renderer also runs, is in
tests/test_torch_demand_mip.py. The reference's distributed case waits for
the port's parallel/ (ROADMAP A.13).
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.materials import make_material as jax_material
from optixpathtracer_tpu.core.scene import HostScene as JaxHostScene
from optixpathtracer_tpu.core.scene import Mesh as JaxMesh
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.io.demand import DemandTextureManager as JaxManager
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.io.demand import TILE, DemandTextureManager
from optixpathtracer_tpu_torch.lights.probe import build_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 40, 32
VIEW = dict(eye=(0, 4, 3), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=60, aspect_ratio=W / H)


def textured_scene(host_cls, mesh_cls, material, tex_size=3 * TILE):
    """tests/test_demand_engine.py's scene: a textured quad and a box."""
    tex = np.random.default_rng(23).uniform(0, 1, (tex_size, tex_size, 3)).astype(np.float32)
    hs = host_cls()
    tid = hs.add_texture(tex)
    hs.add_mesh(mesh_cls(
        vertices=np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        material=material(color=(1, 1, 1), texture_id=tid),
    ))
    hs.add_box(material(color=(0.8, 0.4, 0.2), roughness=0.4), pos=(0, 0.4, 0), extent=(0.4, 0.4, 0.4))
    return hs


def _cfg(**kw):
    return RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=2, traversal="cluster", **kw)


def _setup(hs, demand=None, cfg=None):
    cs = compile_scene(hs, CPU)
    probe = build_probe(np.full((8, 16, 3), 1.0, np.float32), CPU)
    return Renderer(cs, probe, cfg or _cfg(), Camera(**VIEW), demand=demand)


@pytest.fixture(scope="module")
def hs():
    return textured_scene(HostScene, Mesh, make_material)


def _mgr(hs, capacity=64, **kw):
    return DemandTextureManager.from_host_scene(hs, capacity=capacity, device=CPU, **kw)


def test_demand_render_matches_jax():
    """Frames 0 and 1 against the JAX renderer with its own pager on the
    same scene (compiled by JAX, carried across by `interop`)."""
    jhs = textured_scene(JaxHostScene, JaxMesh, jax_material)
    jcs = jax_compile(jhs, cluster_size=128, build_wide_bvh=False)
    jprobe = jax_build_probe(np.full((8, 16, 3), 1.0, np.float32))
    cfg = dict(width=W, height=H, samples_per_launch=2, max_depth=2)
    jmgr = JaxManager.from_host_scene(jhs, capacity=64)
    jr = JaxRenderer(jcs, jprobe, JaxConfig(traversal="lockstep", **cfg), JaxCamera(**VIEW), demand=jmgr)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pmgr = DemandTextureManager.from_host_scene(jhs, capacity=64, device=CPU)
    pr = Renderer(pcs, interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU),
                  RenderConfig(traversal="cluster", **cfg), Camera(**VIEW), demand=pmgr)
    resident = Renderer(pcs, pr.probe, pr.config, Camera(**VIEW))
    for frame in range(2):
        for r in (jr, pr, resident):
            r.render()
        np.testing.assert_array_equal(pr.last_output.tex_usage.numpy(), np.asarray(jr._last.tex_usage))
        np.testing.assert_array_equal(pmgr._page_table, jmgr._page_table)
        assert pmgr.pages_loaded == jmgr.pages_loaded > 0
        got, want = pr.accum_image(), jr.accum_image()
        np.testing.assert_array_equal(got, resident.accum_image())
        same_hit = (np.abs(pr.aovs()["albedo"] - jr.aovs()["albedo"]) <= 1e-5).all(-1)
        assert same_hit.mean() > 0.95
        np.testing.assert_allclose(got[same_hit], want[same_hit], rtol=1e-5, atol=1e-5)
        assert scenes.golden_rmse(got, want) <= 1e-5
    assert pr.last_output.tex_usage.any()


def test_demand_settle_makes_frame0_exact(hs):
    mgr = _mgr(hs)
    r_demand, r_resident = _setup(hs, demand=mgr), _setup(hs)
    r_demand.render()
    r_resident.render()
    assert mgr.pages_loaded > 0 and r_demand.last_launches == 2
    np.testing.assert_allclose(r_demand.accum_image(), r_resident.accum_image(), atol=1e-5)
    before = mgr.pages_loaded
    r_demand.render()
    r_resident.render()
    assert mgr.pages_loaded == before and r_demand.last_launches == 1
    np.testing.assert_allclose(r_demand.accum_image(), r_resident.accum_image(), atol=1e-5)


def test_demand_no_settle_shows_fallback_then_converges(hs):
    mgr = _mgr(hs)
    r = _setup(hs, demand=mgr)
    r.demand_settle = False
    r.render()
    ref = _setup(hs)
    ref.render()
    assert float(np.abs(r.accum_image() - ref.accum_image()).max()) > 1e-3
    r.accum = Vec3.zeros((W * H,), CPU)
    r.subframe_index = 0
    r.render()
    np.testing.assert_allclose(r.accum_image(), ref.accum_image(), atol=1e-5)


def test_demand_checkpoint_resume_unbiased(hs, tmp_path):
    r = _setup(hs, demand=_mgr(hs))
    r.render_n(2)
    ck = str(tmp_path / "demand_ck")
    r.save_checkpoint(ck)
    ref = _setup(hs)
    ref.render_n(3)
    r2 = _setup(hs, demand=_mgr(hs))  # an empty pool
    r2.load_checkpoint(ck)
    assert r2.subframe_index == 2
    r2.render()  # settles the pages before it accumulates subframe 2
    np.testing.assert_allclose(r2.accum_image(), ref.accum_image(), atol=1e-5)


def test_demand_multi_tile_dispatch_ors_usage(hs):
    """dispatch_tiles=3: the chunks' bitmaps OR together and the settled
    frame and its usage equal one launch's."""
    mgr = _mgr(hs)
    r = _setup(hs, demand=mgr, cfg=_cfg(dispatch_tiles=3))
    r.render()
    one_mgr = _mgr(hs)
    one = _setup(hs, demand=one_mgr)
    one.render()
    assert r.last_output.tex_usage.shape == (mgr.num_pages,)
    np.testing.assert_array_equal(r.last_output.tex_usage.numpy(), one.last_output.tex_usage.numpy())
    assert mgr.pages_loaded == one_mgr.pages_loaded > 0
    np.testing.assert_allclose(r.accum_image(), one.accum_image(), atol=1e-5)
    r_ref = _setup(hs)
    r_ref.render()
    np.testing.assert_allclose(r.accum_image(), r_ref.accum_image(), atol=1e-5)


def test_demand_settle_bounded_when_pool_too_small():
    big = textured_scene(HostScene, Mesh, make_material, tex_size=6 * TILE)
    mgr = _mgr(big, capacity=4)
    r = _setup(big, demand=mgr)
    r.render()  # ends (bounded); pages were still serviced
    assert mgr.pages_loaded > 0 and r.subframe_index == 1
    assert int(r.last_output.tex_usage.sum()) > mgr.capacity and r.last_launches == 1


def test_sort_rays_moves_no_bitmap(hs):
    """The coherence sort permutes every per-lane leaf but the bitmap:
    with sort_rays the frame and the usage equal the unsorted launch's."""
    out = {}
    for sort in (False, True):
        mgr = _mgr(hs)
        r = _setup(hs, demand=mgr, cfg=_cfg(sort_rays=True) if sort else _cfg())
        r.render()
        out[sort] = (r.accum_image(), r.last_output.tex_usage.numpy(), mgr._page_table.copy())
    np.testing.assert_allclose(out[True][0], out[False][0], atol=1e-6)
    np.testing.assert_array_equal(out[True][1], out[False][1])
    np.testing.assert_array_equal(out[True][2], out[False][2])
