"""Port parity of the scripts beside the package (ROADMAP A.15), the
examples `optixpathtracer_tpu_torch.examples.render_foveated` and
`.demand_textures_demo` run small on the CPU against the same calls into
the JAX package at the same size, with tests/test_torch_scripts_examples.py's
tolerances: the foveated accumulation within rtol / atol 1e-5, its PNG
within 1 per channel of the JAX frame, rays per frame equal; the demand
demo's pass-by-pass page counts and resident pages equal to the JAX
pager's under the same requests, its image within sqrt-space RMSE 1e-5 (a
textured image: ulp-level hit uv part a few texels). In a file of their
own for time: the JAX foveated renderer compiles one program a zone."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.math import Vec3 as JaxVec3
from optixpathtracer_tpu.core.math import normalize as jax_normalize
from optixpathtracer_tpu.engine.foveated import FoveatedRenderer as JaxFoveated
from optixpathtracer_tpu.engine.foveated import FoveationConfig as JaxFoveation
from optixpathtracer_tpu.engine.wavefront import CameraParams as JaxCameraParams
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.engine.wavefront import _closest_hit
from optixpathtracer_tpu.io import demand as jdemand
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu.utils.platform import auto_tune as jax_auto_tune
from optixpathtracer_tpu_torch.examples import demand_textures_demo, render_foveated
from optixpathtracer_tpu_torch import scenes
from optixpathtracer_tpu_torch.io.image import read_rgb8

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _png_close(path, frame_u8):
    got = read_rgb8(str(path)).astype(np.int16)
    assert got.shape == frame_u8[..., :3].shape
    assert np.abs(got - frame_u8[..., :3].astype(np.int16)).max() <= 1


def _jax_cfg(**kw):
    return jax_auto_tune(JaxConfig(**kw))


def test_render_foveated_against_jax(tmp_path):
    w, h, frames = 48, 36, 2
    out = tmp_path / "fov.png"
    rays = []
    fr = render_foveated.render_foveated(CPU, str(out), w, h, frames=frames, inner=5, outer=12,
                                         log=lambda s: rays.append(s))
    from optixpathtracer_tpu.core.materials import make_material
    from optixpathtracer_tpu.core.scene import HostScene

    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
    for p, c in [((-1, 0.5, 0), (0.85, 0.2, 0.2)), ((0.9, 0.7, 0.4), (0.2, 0.7, 0.3)),
                 ((0, 0.3, 1.5), (0.3, 0.4, 0.9))]:
        hs.add_box(make_material(color=c, roughness=0.5), pos=p, extent=(0.4, 0.5, 0.4))
    sky = np.full((32, 64, 3), 0.35, np.float32)
    sky[4:7, 14:18] = (30.0, 28.0, 24.0)
    jfr = JaxFoveated(jax_compile(hs), jax_probe(sky), _jax_cfg(width=w, height=h, max_depth=3),
                      JaxCamera(eye=(4, 2.5, 5), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=40, aspect_ratio=w / h),
                      JaxFoveation(inner_radius=5, outer_radius=12))
    jfr.set_gaze(w // 2, h // 2)
    want = []
    for _ in range(frames):
        frame = jfr.render()
        want.append(f"rays={jfr.last_rays:.0f}")
    assert [s.split()[-1] for s in rays[:frames]] == want
    np.testing.assert_allclose(fr.accum_image(), jfr.accum_image(), **TOL)
    _png_close(out, frame)


def test_demand_textures_demo_against_jax(tmp_path):
    """The demo's first hits, its pages pass by pass and its image against
    the original's jitted `first_hit` and the JAX pager, at 64x40."""
    w, h = 64, 40
    res = demand_textures_demo.demand_demo(CPU, str(tmp_path / "d.png"), w, h, log=lambda s: None)

    cs = jax_compile(_jax_demand_scene())
    cam = JaxCamera(eye=(9, 5, 9), lookat=(0, 0.8, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=w / h)
    cfg = _jax_cfg(width=w, height=h)
    cp = JaxCameraParams.from_camera(cam)
    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)

    @jax.jit
    def first_hit(px, py):  # examples/demand_textures_demo.py:69-95
        dx = 2.0 * (px.astype(jnp.float32) + 0.5) / w - 1.0
        dy = 2.0 * (py.astype(jnp.float32) + 0.5) / h - 1.0
        d = jax_normalize(cp.u * dx + cp.v * dy + cp.w * 1.0)
        o = JaxVec3(cp.eye.x + 0 * dx, cp.eye.y + 0 * dx, cp.eye.z + 0 * dx)
        rec = _closest_hit(cs, cfg, o, d, 1e-3, 1e16)
        tri = jnp.maximum(rec.tri, 0)
        sc = cs.scene
        w0 = 1.0 - rec.u - rec.v
        tu = sc.uv0u[tri] * w0 + sc.uv1u[tri] * rec.u + sc.uv2u[tri] * rec.v
        tv = sc.uv0v[tri] * w0 + sc.uv1v[tri] * rec.u + sc.uv2v[tri] * rec.v
        tex = jnp.where(rec.hit & (sc.material_id[tri] == 0), 0, -1)
        pixel_ang = 2.0 * math.tan(math.radians(45.0 / 2)) / h
        foot = rec.t * pixel_ang / jnp.maximum(jnp.abs(d.y), 1e-3) / (2 * 60.0 / 8192.0)
        lod = jnp.clip(jnp.log2(jnp.maximum(foot, 1.0)), 0.0, 5.0)
        return tex, tu, tv, rec.hit, jnp.abs(d.y), lod

    tex, tu, tv, hit, shade, lod = first_hit(jnp.asarray(xs), jnp.asarray(ys))
    src = jdemand.CheckerBoardSource(width=8192, height=8192, squares_per_side=128,
                                     color_a=(0.9, 0.9, 0.85), color_b=(0.15, 0.2, 0.5))
    mgr = jdemand.DemandTextureManager([src], capacity=4096, levels=6)
    passes = []
    for _ in range(11):
        color, _, usage = jdemand.sample_demand(mgr.pool, tex, tu, tv, lod, trilinear=True)
        loaded = mgr.process_requests(usage)
        passes.append((int(np.asarray(usage).sum()), loaded))
        if loaded == 0:
            break
    assert res["passes"] == passes and res["pages_loaded"] == mgr.pages_loaded
    assert res["resident"] == int((np.asarray(mgr.pool.page_table) >= 0).sum()) < res["num_pages"]
    img = np.zeros((w * h, 3), np.float32)
    hitm = np.asarray(hit)
    rgb = np.stack([np.asarray(c) for c in color], -1)
    img[hitm] = rgb[hitm] * np.asarray(shade)[hitm, None]
    img[~hitm] = (0.4, 0.55, 0.8)
    assert scenes.golden_rmse(res["image"], img.reshape(h, w, 3)[::-1]) <= 1e-5


def _jax_demand_scene():
    from optixpathtracer_tpu.core.materials import make_material
    from optixpathtracer_tpu.core.scene import HostScene, Mesh

    hs = HostScene()
    s = 60.0
    hs.add_mesh(Mesh(vertices=np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32),
                     indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                     texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                     material=make_material(color=(1, 1, 1))))
    hs.add_box(make_material(color=(0.8, 0.3, 0.2)), pos=(0, 1.5, 0), extent=(1.5, 1.5, 1.5))
    return hs


