"""Port parity, tests/test_renderer.py:176-190: the coherence sort
(`sort_rays`) changes no bit of a frame. It permutes the wavefront before
each bounce's sweep and restores the caller's order at the end, and every
per-ray operation is order-independent; the shadow sweep takes its own
sort on the cluster walk only, as the reference's. Held on the reference's
box scene on the cluster walk (the reference's case), and on the lockstep
and BFS walks, with and without fused shadows.
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.lights.probe import build_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def box_scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return compile_scene(hs, CPU), build_probe(np.full((16, 32, 3), 1.0, np.float32), CPU)


def _frame(cs, probe, **cfg):
    config = RenderConfig(width=48, height=32, **cfg)
    r = Renderer(cs, probe, config, Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                                            aspect_ratio=48 / 32))
    frame = r.render()
    return frame, r.accum_image(), int(r.last_output.rays_traced)


@pytest.mark.parametrize("traversal", ["cluster", "lockstep", "bfs"])
def test_sort_rays_bit_identical(box_scene, traversal):
    base = dict(samples_per_launch=2, max_depth=3, traversal=traversal, bfs_cap_factor=8)
    plain, sorted_ = _frame(*box_scene, **base), _frame(*box_scene, sort_rays=True, **base)
    for a, b in zip(plain, sorted_):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("traversal", ["cluster", "lockstep", "bfs"])
def test_sort_rays_bit_identical_fused(box_scene, traversal):
    base = dict(samples_per_launch=1, max_depth=2, traversal=traversal, fused_shadows=True,
                bfs_cap_factor=8)
    plain, sorted_ = _frame(*box_scene, **base), _frame(*box_scene, sort_rays=True, **base)
    for a, b in zip(plain, sorted_):
        np.testing.assert_array_equal(a, b)
