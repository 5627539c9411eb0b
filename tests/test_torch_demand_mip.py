"""Port parity, the mip LOD of demand-loaded textures in the engine
(tests/test_demand_engine.py's mip case): with a pool of several levels
each hit samples trilinearly at a LOD from the path length's pixel
footprint and the triangle's texel density, so a ground plane receding to
the horizon touches coarse pages. The port's renderer and the JAX renderer
(lockstep) on the same plane, one launch, then:

- the launch's page-usage bitmaps and the pagers' page tables are equal,
  and so the sets of mip levels touched;
- `accum_image` is within sqrt-space RMSE 1e-5 (the bound of
  tests/test_torch_demand_engine.py; these planes read 3.4e-6 and 5.2e-6).
  A LOD off by a quarter level reads 1.7e-3 to 7.4e-3 here, a LOD off by
  one, a texel density without its square root, a pool row left unwritten
  or a texel off by one 2.3e-3 to 0.16;
- the port's settled frame keeps the resident render's mean within 10 %.

Two planes: the reference's (a 4x4-tile texture repeated 40 times, 64x40:
its hits take levels 1-2 of 4) and a denser one (8x8 tiles repeated 4
times, 96x60: 21 pages over all four levels, where a LOD a quarter level
off already moves pages).
"""
import numpy as np
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
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.io.demand import TILE, DemandTextureManager

torch.set_num_threads(1)
CPU = torch.device("cpu")
RMSE_TOL = 1e-5


def _plane(tiles, repeats):
    """A 240-unit plane under a dense tiles x tiles-tile texture repeated
    `repeats` times across it."""
    side = tiles * TILE
    tex = np.random.default_rng(37).uniform(0.2, 0.8, (side, side, 3)).astype(np.float32)
    hs = JaxHostScene()
    tid = hs.add_texture(tex)
    s = 120.0
    r = float(repeats)
    hs.add_mesh(JaxMesh(
        vertices=np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [r, 0], [r, r], [0, r]], np.float32),
        material=jax_material(color=(1, 1, 1), texture_id=tid),
    ))
    return hs


def _levels(mgr, usage):
    return set(mgr._page_lvl[np.nonzero(usage)[0]].tolist())


def _check_mip_against_jax(tiles, repeats, w, h):
    hs = _plane(tiles, repeats)
    view = dict(eye=(0, 1.5, 8), lookat=(0, 0.5, 0), up=(0, 1, 0), fov_y=50, aspect_ratio=w / h)
    cfg = dict(width=w, height=h, samples_per_launch=1, max_depth=1)
    jcs = jax_compile(hs, cluster_size=128, build_wide_bvh=False)
    jprobe = jax_build_probe(np.full((8, 16, 3), 1.0, np.float32))
    jmgr = JaxManager.from_host_scene(hs, capacity=256, levels=4)
    jr = JaxRenderer(jcs, jprobe, JaxConfig(traversal="lockstep", **cfg), JaxCamera(**view), demand=jmgr)
    jr.render()

    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    mgr = DemandTextureManager.from_host_scene(hs, capacity=256, levels=4, device=CPU)
    r = Renderer(pcs, probe, RenderConfig(traversal="cluster", **cfg), Camera(**view), demand=mgr)
    r.render()
    usage, jusage = r.last_output.tex_usage.numpy(), np.asarray(jr._last.tex_usage)
    np.testing.assert_array_equal(usage, jusage)
    np.testing.assert_array_equal(mgr._page_table, jmgr._page_table)
    lvls = _levels(mgr, usage)
    assert any(lv > 0 for lv in lvls), f"no coarse mip pages touched: {lvls}"
    assert lvls == _levels(jmgr, jusage)
    img = r.accum_image()
    assert np.isfinite(img).all()
    assert scenes.golden_rmse(img, jr.accum_image()) <= RMSE_TOL
    ref = Renderer(pcs, probe, RenderConfig(traversal="cluster", **cfg), Camera(**view))
    ref.render()
    a, b = img.mean(), ref.accum_image().mean()
    assert abs(a - b) / max(b, 1e-6) < 0.1, (a, b)
    return lvls


def test_demand_engine_mip_lod_uses_coarse_pages():
    """The reference test's plane, 64x40."""
    _check_mip_against_jax(tiles=4, repeats=40, w=64, h=40)


def test_demand_engine_mip_lod_dense_plane_every_level():
    """A denser plane at 96x60 whose hits touch all four levels."""
    assert _check_mip_against_jax(tiles=8, repeats=4, w=96, h=60) == {0, 1, 2, 3}
