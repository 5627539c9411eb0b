"""Port parity, core/scene's TexturePool and the textured hit shading: the
port's `pack_textures`, `sample_bilinear` and `_hit_geometry` albedo
against the JAX package's, and a textured scene compiled by the JAX
package rendered by both.

The pool's layout and every bilinear fetch are bit-equal (the reference's
expression order, XLA's float remainder for `u % 1.0`, the floor modulo of
the texel wrap). The render is held to sqrt-space RMSE 1e-5: the same RNG
streams and textures, only the shading math's ulp-level differences left.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core import scene as jscene
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.io.obj import load_obj as jax_load_obj
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu.ops.traverse import HitRecord as JaxHit
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core import scene as tscene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.io.image import load_image
from optixpathtracer_tpu_torch.ops.traverse_cluster import HitRecord

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images():
    """The loft's three 256x256 textures and two odd sizes (wrap at widths
    that are not powers of two)."""
    rng = np.random.default_rng(0)
    loft = [load_image(os.path.join(REPO, "scenes", f"loft_tex{i}.png")) for i in range(3)]
    return loft + [rng.random((3, 5, 3)).astype(np.float32), rng.random((7, 1, 4)).astype(np.float32)]


def test_pack_textures_layout_equal():
    imgs = _images()
    want = jscene.pack_textures(imgs)
    got = tscene.pack_textures(imgs, CPU)
    for name in tscene.TexturePool._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.offset.tolist() == [0, 65536, 131072, 196608, 196623]
    empty, jempty = tscene.pack_textures([], CPU), jscene.TexturePool.empty()
    for a, b in zip(empty, jempty):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _lookups(n, seed, n_tex):
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, n_tex, n).astype(np.int32)
    uv = rng.uniform(-3, 3, (2, n)).astype(np.float32)
    ints = rng.random((2, n)) < 0.1
    uv[ints] = rng.integers(-3, 4, int(ints.sum()))
    uv[0, :64] = -0.0
    uv[1, 64:128] = -np.float32(1e-9)  # rounds to 1.0 after the remainder
    uv[0, 128:192] = np.nextafter(np.float32(1.0), np.float32(0.0))
    return tid, uv[0], uv[1]


def test_sample_bilinear_bit_equal_to_jax():
    imgs = _images()
    tid, u, v = _lookups(1 << 16, 1, len(imgs))
    want = jscene.pack_textures(imgs).sample_bilinear(jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v))
    got = tscene.pack_textures(imgs, CPU).sample_bilinear(*(torch.as_tensor(a) for a in (tid, u, v)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    white = tid < 0
    assert white.any() and all((c.numpy()[white] == 1.0).all() for c in got)


def test_wrap_is_xla_remainder():
    u = np.array([-2.5, -1.0, -0.0, 0.0, -1e-9, 1e-9, 0.999999, 3.0, -3.25, 7.75], np.float32)
    got = tscene._wrap01(torch.as_tensor(u)).numpy()
    want = np.asarray(jnp.asarray(u) % 1.0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))  # -0.0 stays -0.0


@pytest.fixture(scope="module")
def loft_scenes():
    """The loft compiled by the JAX package, and the same arrays in the port."""
    jcs = jax_compile(jax_load_obj(scenes.LOFT_OBJ, prefer_native=False), cluster_size=128,
                      build_wide_bvh=False)
    return jcs, interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)


def test_interop_carries_the_pool(loft_scenes):
    jcs, pcs = loft_scenes
    for name in tscene.TexturePool._fields:
        np.testing.assert_array_equal(getattr(pcs.scene.textures, name).numpy(),
                                      np.asarray(getattr(jcs.scene.textures, name)))
    assert pcs.scene.textured and not compile_scene(scenes.open_scene(), CPU).scene.textured


@pytest.mark.parametrize("use_shading", [False, True])
def test_hit_geometry_albedo_equal_to_jax(loft_scenes, use_shading):
    """The textured albedo at random hits of every triangle: bit-equal; the
    normal to 1e-6 (a normalise apart)."""
    jcs, pcs = loft_scenes
    rng = np.random.default_rng(2)
    n = 8192
    tri = rng.integers(-1, jcs.num_triangles, n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    v = (rng.random(n) * (1 - u)).astype(np.float32)
    t = rng.uniform(0.1, 5, n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    jn, jmat, jalb, _ = jwf._hit_geometry(jcs, JaxHit(*(jnp.asarray(a) for a in (t, tri, u, v))),
                                          JVec3(*(jnp.asarray(d[:, i]) for i in range(3))), use_shading)
    tn, tmat, talb, _ = twf._hit_geometry(pcs, HitRecord(*(torch.as_tensor(a) for a in (t, tri, u, v))),
                                          Vec3(*(torch.as_tensor(np.ascontiguousarray(d[:, i])) for i in range(3))),
                                          use_shading)
    textured = np.asarray(jmat.texture_id) >= 0
    assert textured.mean() > 0.2 and (~textured).any()
    for a, b in zip(talb, jalb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_textured_render_from_jax_arrays(loft_scenes):
    """The JAX-compiled loft (interop arrays) rendered by the port and by
    the JAX Renderer: the image and the albedo AOV, sqrt-space RMSE 1e-5."""
    jcs, pcs = loft_scenes
    w, h = 32, 16
    view = dict(eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0), fov_y=45,
                aspect_ratio=w / h)
    flags = dict(width=w, height=h, samples_per_launch=2, max_depth=2, emission_all_bounces=True,
                 use_shading_normals=True, sort_rays=True)
    jr = JaxRenderer(jcs, jax_build_probe(np.full((8, 16, 3), 1e-6, np.float32)),
                     jwf.RenderConfig(traversal="lockstep", **flags), JaxCamera(**view))
    pr = Renderer(pcs, scenes.dark_probe(CPU), twf.RenderConfig(traversal="cluster", **flags),
                  Camera(**view))
    for r in (jr, pr):
        r.render_n(2)
    assert scenes.golden_rmse(pr.accum_image(), jr.accum_image()) <= 1e-5
    got, want = pr.aovs()["albedo"], jr.aovs()["albedo"]
    assert scenes.golden_rmse(got, want) <= 1e-5
    assert np.unique(got.reshape(-1, 3), axis=0).shape[0] > 50  # textured, not flat colours
