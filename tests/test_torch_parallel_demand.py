"""Port parity, parallel/tiles with demand-loaded textures over gloo CPU ranks.

The reference's `test_demand_render_distributed_matches_single_device`
(tests/test_demand_engine.py:141-171) on the port: the textured quad and
box at 40x32, 2 spp, depth 2 over 2 and 4 spawned ranks, each with its own
pool of 64 tiles. The union of the ranks' usage bitmaps loads pages
(`pages_loaded` > 0), as many as the single-device demand renderer's, the
port's and the JAX package's (page tables equal), and the settled sharded
frame equals the resident-TexturePool render within 1e-5. Every rank's
pool pages alike: their page tables are equal.
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
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.parallel import dryrun, ranks
from test_torch_demand_engine import VIEW, H, W, textured_scene

torch.set_num_threads(1)
PROBE = np.full((8, 16, 3), 1.0, np.float32)
CFG = dict(width=W, height=H, samples_per_launch=2, max_depth=2)


@pytest.fixture(scope="module")
def single():
    """(JAX single-device demand pager, the port's resident render) of frame 0."""
    jhs = textured_scene(JaxHostScene, JaxMesh, jax_material)
    jmgr = JaxManager.from_host_scene(jhs, capacity=64)
    jr = JaxRenderer(jax_compile(jhs), jax_build_probe(PROBE), JaxConfig(traversal="lockstep", **CFG),
                     JaxCamera(**VIEW), demand=jmgr)
    jr.render()
    hs = textured_scene(HostScene, Mesh, make_material)
    resident = Renderer(compile_scene(hs, torch.device("cpu")), build_probe(PROBE, torch.device("cpu")),
                        RenderConfig(traversal="cluster", **CFG), Camera(**VIEW))
    resident.render()
    return jmgr, resident.accum_image()


@pytest.mark.parametrize("world", [2, 4])
def test_demand_render_distributed_matches_single_device(tmp_path, single, world):
    jmgr, resident = single
    hs = textured_scene(HostScene, Mesh, make_material)
    res = ranks.run_ranks(
        dryrun.strip_program, world, "gloo", "cpu", str(tmp_path / "rendezvous"),
        args=(hs, PROBE, RenderConfig(traversal="cluster", **CFG), Camera(**VIEW)),
        kwargs=dict(demand=dict(capacity=64), single=True), timeout_s=120)
    got = res[0]
    assert got["pages_loaded"] > 0
    # union working set == the single wavefront's (same pixels, same streams)
    assert got["pages_loaded"] == got["single_pages_loaded"] == jmgr.pages_loaded
    np.testing.assert_array_equal(got["page_table"], jmgr._page_table)
    assert got["launches"] == [2]  # one launch to find the pages, one settled
    np.testing.assert_allclose(got["image"], resident, atol=1e-5)
    for other in res[1:]:
        assert other["pages_loaded"] == got["pages_loaded"]
        np.testing.assert_array_equal(other["page_table"], got["page_table"])
        np.testing.assert_array_equal(other["image"], got["image"])
