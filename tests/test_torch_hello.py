"""Port parity, models/hello_raytracing: `render_hello` against the JAX
package's (its CPU path: the exact lockstep backend) on the open golden
scene and on the textured loft, the scenes carried across with `interop`;
the `hello` golden; the preset's renderer.

Tolerances: colors rtol 1e-5 / atol 1e-6 on 98.5 % of lanes. The others:
where the two exact backends split a ray through a shared edge (either
triangle may win: at most 0.5 % of lanes), and on the loft, lanes whose
barycentrics round apart (the JAX package's u / v differ from the cluster
walk's by a few ulps on a third of the hits, its lockstep walk's and its
cluster walk's alike, and a bilinear texture fetch turns that into up to
1e-3 of a color), held within rtol 1e-3 / atol 1e-5. The golden within
sqrt-space RMSE 2e-3 (tests/test_goldens.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.engine.wavefront import CameraParams as JCam
from optixpathtracer_tpu.io.obj import load_obj as jax_load_obj
from optixpathtracer_tpu.models import hello_raytracing as jhello
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.engine.wavefront import CameraParams
from optixpathtracer_tpu_torch.models import PRESETS, hello_raytracing, make_hello_renderer
from tests.golden_scenes import _open_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 64, 48


def _scene_pair(name):
    hs = _open_scene() if name == "open" else jax_load_obj(scenes.LOFT_OBJ)
    jcs = jax_compile(hs, cluster_size=128)  # with its BVH: the lockstep backend
    return jcs, interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)


def _camera(name):
    return scenes.open_camera(W, H) if name == "open" else scenes.loft_camera(W, H)


@pytest.mark.parametrize("name", ["open", "loft"])
def test_render_hello_equal_to_jax(name):
    from optixpathtracer_tpu.ops import dispatch as jdispatch
    from optixpathtracer_tpu_torch.ops import dispatch

    jcs, pcs = _scene_pair(name)
    cam = _camera(name)
    ys, xs = np.divmod(np.arange(W * H, dtype=np.int32), W)
    jcfg = jhello.HelloConfig(width=W, height=H)
    want = jhello.render_hello(jcs, jcfg, JCam.from_camera(cam), jnp.asarray(xs), jnp.asarray(ys))
    got = hello_raytracing.render_hello(pcs, hello_raytracing.HelloConfig(width=W, height=H),
                                        CameraParams.from_camera(cam, CPU), torch.as_tensor(xs),
                                        torch.as_tensor(ys))
    g = np.stack([c.numpy() for c in got], -1)
    w = np.stack([np.asarray(c) for c in want], -1)
    ok = np.isclose(g, w, rtol=1e-5, atol=1e-6).all(-1)
    assert ok.mean() >= 0.985, f"{int((~ok).sum())} lanes differ"
    # the primary hits of both: where they agree, the color is within the
    # barycentric rounding; where they do not, the ray crossed a shared edge
    jrec = jdispatch.trace_closest(jcs, *want_rays(cam, xs, ys), 0.0, 1e20)
    prec = dispatch.trace_closest(pcs, *port_rays(cam, xs, ys), 0.0, 1e20)
    same = np.asarray(jrec.tri) == prec.tri.numpy()
    assert (~same).mean() <= 0.005
    assert np.isclose(g, w, rtol=1e-3, atol=1e-5).all(-1)[same].all()
    assert (w.max(-1) > 0).mean() > 0.5 and g.std() > 0.02  # lit, with contrast
    if name == "loft":  # the textured materials shade through the texture pool
        assert pcs.scene.textured and int((pcs.scene.materials.texture_id >= 0).sum()) > 0


def want_rays(cam, xs, ys):
    """The camera rays `render_hello` traces, built by the JAX package."""
    from optixpathtracer_tpu.core.math import Vec3, normalize

    c = JCam.from_camera(cam)
    sx = (jnp.asarray(xs).astype(jnp.float32) + 0.5) / W
    sy = (jnp.asarray(ys).astype(jnp.float32) + 0.5) / H
    d = normalize(c.u * (sx - 0.5) * 2.0 + c.v * (sy - 0.5) * 2.0 + c.w * 1.0)
    z = d.x * 0.0
    return Vec3(c.eye.x + z, c.eye.y + z, c.eye.z + z), d


def port_rays(cam, xs, ys):
    """The same rays from the port's own raygen expressions."""
    from optixpathtracer_tpu_torch.core.math import Vec3, normalize

    c = CameraParams.from_camera(cam, CPU)
    sx = (torch.as_tensor(xs).to(torch.float32) + 0.5) / torch.tensor(float(W))
    sy = (torch.as_tensor(ys).to(torch.float32) + 0.5) / torch.tensor(float(H))
    d = normalize(c.u * ((sx - 0.5) * 2.0) + c.v * ((sy - 0.5) * 2.0) + c.w * 1.0)
    z = d.x * 0.0
    return Vec3(c.eye.x + z, c.eye.y + z, c.eye.z + z), d


def test_hello_golden():
    got = scenes.render_preset_golden("hello", CPU)
    want = np.load("tests/goldens/hello.npz")["image"]
    assert got.shape == want.shape
    assert scenes.golden_rmse(got, want) <= 2e-3


def test_hello_preset_renderer():
    assert PRESETS["hello_raytracing"] is make_hello_renderer
    cs = compile_scene(scenes.open_scene(), CPU)
    r = make_hello_renderer(cs, scenes.open_camera(W, H), W, H)
    assert (r.cfg.width, r.cfg.height, r.cfg.light_pos) == (W, H, (-907.108, 2205.875, -400.0267))
    img = r.render()
    assert img.shape == (H, W, 3) and img.min() >= 0 and img.max() <= 1 and img.max() > 0.05
    rgba = r.render_rgba8()
    assert rgba.dtype == np.uint8 and rgba.shape == (H, W, 4) and (rgba[..., 3] == 255).all()
    np.testing.assert_array_equal(rgba[..., :3], (img * 255.99).astype(np.uint8))
    assert r.render(download=False) is None and r.frame.shape == (H, W, 3)
