"""Port parity, the dense no-BVH scan (the cases of tests/test_dense.py):
`ops/dense.py` against the JAX package on the same numpy-seeded soup and
rays, and the engine's `traversal="dense"` render of the enclosed cornell
scene against the JAX renderer's. The JAX scan runs compiled inside
`lax.scan` (XLA fuses its Möller–Trumbore arithmetic), so `tri` is held bit
for bit and t/u/v to the reference tests' tolerances; the port's chunked
scan (rays in chunks of DENSE_CHUNK_ELEMS // BLOCK) is held bit for bit
against one chunk.
"""
import numpy as np
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.io.obj import load_obj as jax_load_obj
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu.ops.dense import closest_hit_dense as jax_dense
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.io.obj import load_obj
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.ops import dense
from optixpathtracer_tpu_torch.ops.traverse import BIG_T, brute_force_closest_hit
from tests.torch_backend_cases import CPU, assert_records_equal, compiled, rays, soup

torch.set_num_threads(1)


def test_dense_matches_reference_and_brute_force(rng, monkeypatch):
    pcs, jcs = compiled(soup(rng, 700, scale=4.0, edge=0.2), leaf_size=4)  # > BLOCK: the scan loops
    (o, d), (jo, jd) = rays(rng, 256, aim=4.0)
    got = dense.closest_hit_dense(pcs.wide, o, d, 1e-3, 1e16)
    assert_records_equal(got, jax_dense(jcs.wide, jo, jd, 1e-3, 1e16), exact_floats=False)
    want = brute_force_closest_hit(pcs.scene, o, d, 1e-3, 1e16)
    hits = got.hit.numpy()
    np.testing.assert_array_equal(hits, want.t.numpy() < BIG_T)
    np.testing.assert_array_equal(got.t.numpy()[hits], want.t.numpy()[hits])
    assert 0.2 < hits.mean() < 1.0
    monkeypatch.setattr(dense, "DENSE_CHUNK_ELEMS", 40 * dense.BLOCK)  # 7 chunks of 40 rays
    chunked = dense.closest_hit_dense(pcs.wide, o, d, 1e-3, 1e16)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(chunked, f).numpy(), getattr(got, f).numpy())


def test_dense_render_matches_reference_enclosed():
    """The enclosed cornell scene, where BFS worklists overflow: the dense
    backend's render against the JAX renderer's dense render (sqrt-space
    RMSE 2e-3, the goldens' metric; rays traced equal) and against the
    port's lockstep render."""
    from optixpathtracer_tpu_torch import scenes

    kw = dict(width=24, height=24, samples_per_launch=2, max_depth=2, emission_all_bounces=True)
    cam = dict(eye=(0, 1.0, 3.6), lookat=(0, 1.0, 0), up=(0, 1, 0), fov_y=40, aspect_ratio=1.0)
    sky = np.full((8, 16, 3), 0.2, np.float32)
    jr = JaxRenderer(jax_compile(jax_load_obj("scenes/cornell_box.obj")), jax_probe(sky),
                     JaxConfig(traversal="dense", **kw), JaxCamera(**cam))
    jr.render()
    cs = compile_scene(load_obj("scenes/cornell_box.obj"), CPU)
    imgs = {}
    for tr in ("dense", "lockstep"):
        r = Renderer(cs, build_probe(sky, CPU), RenderConfig(traversal=tr, **kw), Camera(**cam))
        r.render()
        imgs[tr] = r.accum_image()
        if tr == "dense":
            assert int(r.last_output.rays_traced) == int(jr._last.rays_traced)
    assert scenes.golden_rmse(imgs["dense"], jr.accum_image()) <= 2e-3
    np.testing.assert_allclose(imgs["dense"], imgs["lockstep"], rtol=2e-3, atol=2e-4)
