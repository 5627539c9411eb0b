"""Port parity, the main-path slice end to end: `make_disney_pt_renderer`
with the bench's flags against the JAX Renderer (on the flat cluster walk,
and again on the node walk), the port's golden render, and the port
running in a process that never imports jax.

Images compare in sqrt space with the goldens' RMSE 2e-3
(tests/test_goldens.py). The JAX side traces with its exact lockstep
backend (its cluster kernels in interpret mode take over 30 s here); the
port traces with its cluster backend.
"""
import collections
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from tests.golden_scenes import _cam_s, _open_scene, _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
RMSE_TOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FLAGS = dict(sort_rays=True, batch_spp=True, nee_final_bounce=False)


@pytest.fixture(scope="module")
def jax_bench_render():
    """The JAX Renderer with the bench flags on the open scene (48x32, 2 spp,
    depth 4, 2 frames): (compiled scene, camera, accum image, 8-bit frame)."""
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    cam = _cam_s((3.2, 2.2, 4.0), (0, 0.4, 0))
    jr = JaxRenderer(jcs, _sky_probe(), JaxConfig(
        width=48, height=32, samples_per_launch=2, max_depth=4, traversal="lockstep",
        **BENCH_FLAGS), cam)
    jr.render_n(2)
    return jcs, cam, jr.accum_image(), jr.download_pixels()


def _check_port_render(jax_bench_render):
    jcs, cam, want, want_frame = jax_bench_render
    h, w = want.shape[:2]
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    pr = make_disney_pt_renderer(pcs, probe, cam, width=w, height=h, spp=2, max_depth=4,
                                 traversal="cluster", **BENCH_FLAGS)
    assert pr.config.traversal == "cluster"
    frame = pr.render_n(2)
    assert frame.shape == (h, w, 4) and frame.dtype == np.uint8
    got = pr.accum_image()
    assert got.shape == want.shape and np.isfinite(got).all() and got.max() > 0
    assert scenes.golden_rmse(got, want) <= RMSE_TOL
    # the tone-mapped frames agree to the last 8-bit step
    assert np.abs(frame.astype(int) - want_frame.astype(int)).max() <= 1
    assert pr.subframe_index == 2


def test_disney_pt_bench_flags_vs_jax_renderer(jax_bench_render):
    _check_port_render(jax_bench_render)


def test_disney_pt_node_walk_vs_jax_renderer(jax_bench_render, monkeypatch):
    """The same slice with the routing threshold lowered, so every sweep of
    the frame takes the hierarchical (node) walk."""
    walks = collections.Counter()
    for name in ("_closest_hier_torch", "_any_hier_torch", "_closest_torch", "_any_torch"):
        real = getattr(tc, name)
        monkeypatch.setattr(tc, name, lambda *a, _n=name, _f=real: walks.update([_n]) or _f(*a))
    monkeypatch.setattr(tc, "HIER_MIN_ENTRIES", 0)
    _check_port_render(jax_bench_render)
    assert walks["_closest_hier_torch"] > 0 and walks["_any_hier_torch"] > 0
    assert walks["_closest_torch"] == 0 and walks["_any_torch"] == 0


def test_disney_open_s_golden():
    want = np.load(os.path.join(REPO, "tests", "goldens", "disney_open_s.npz"))["image"]
    got = scenes.render_open_golden("disney_open_s", CPU)
    assert got.shape == want.shape
    assert scenes.golden_rmse(got, want) <= RMSE_TOL


def test_dispatch_tiles_split_launch_matches_single_launch():
    cam = scenes.open_camera(32, 16)
    cs = compile_scene(scenes.open_scene(), CPU)
    imgs = []
    for tiles in (1, 3):
        r = make_disney_pt_renderer(cs, scenes.sky_probe(CPU), cam, width=32, height=16, spp=1,
                                    max_depth=2, dispatch_tiles=tiles)
        r.render()
        imgs.append((r.accum_image(), int(r.last_output.rays_traced)))
    np.testing.assert_array_equal(imgs[0][0], imgs[1][0])
    assert imgs[0][1] == imgs[1][1]


def test_port_runs_without_jax():
    code = textwrap.dedent("""
        import sys, numpy as np, torch
        torch.set_num_threads(1)
        from optixpathtracer_tpu_torch import scenes
        from optixpathtracer_tpu_torch.builder import compile_scene
        from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
        dev = torch.device("cpu")
        cs = compile_scene(scenes.open_scene(), dev)
        r = make_disney_pt_renderer(cs, scenes.sky_probe(dev), scenes.open_camera(16, 8),
                                    width=16, height=8, spp=1, max_depth=2,
                                    sort_rays=True, batch_spp=True, nee_final_bounce=False)
        img = r.render()
        assert img.shape == (8, 16, 4) and np.isfinite(r.accum_image()).all()
        print("jax" in sys.modules, "optixpathtracer_tpu" in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
