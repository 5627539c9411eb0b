"""Port parity, ops/curve_intersect: `closest_hit_curves` and
`any_hit_curves` against the JAX package on seeded segments of every degree
and rays aimed at them; tests/test_curve_intersect.py's closed forms held
by the port (a capsule, its round end cap, the nearer of two tubes,
occlusion within t_max); and the whitted engine with curves= against the
JAX engine (tests/test_curve_intersect.py's arch over the floor).

Tolerances: segment ids and hit flags bit-exact; t rtol 1e-5 / atol 1e-6;
u, the normals and the projected points rtol 1e-4 / atol 1e-5 (a
projection and two normalisations, rsqrt a ulp apart); the whitted frame
rtol 1e-5 / atol 1e-6 on 97 % of lanes and rtol 1e-3 / atol 1e-4 on every
lane, as tests/test_torch_whitted.py holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.scene import HostScene as JHost
from optixpathtracer_tpu.engine import whitted as jwhitted
from optixpathtracer_tpu.engine.wavefront import CameraParams as JCam
from optixpathtracer_tpu.lights import lights as jlights
from optixpathtracer_tpu.ops import curve_intersect as J
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.engine import whitted as twhitted
from optixpathtracer_tpu_torch.engine.wavefront import CameraParams
from optixpathtracer_tpu_torch.lights import lights as tlights
from optixpathtracer_tpu_torch.ops import curve_intersect as C

torch.set_num_threads(1)
CPU = torch.device("cpu")
ARCH = [[[-2.5, 0.0, 0.0, 0.45], [-1.0, 2.8, 0.0, 0.40], [1.0, 2.8, 0.0, 0.35], [2.5, 0.0, 0.0, 0.30]]]


def _pair(cp, ids=None):
    return (J.build_curves(cp, [jmake(color=(0.8, 0.4, 0.2))] * 2, material_ids=ids),
            C.build_curves(cp, [make_material(color=(0.8, 0.4, 0.2))] * 2, CPU, material_ids=ids))


def _rays(o, d, normalize=True):
    o, d = np.asarray(o, np.float32), np.asarray(d, np.float32)
    if normalize:
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return ((JVec3(*(jnp.asarray(o[:, i]) for i in range(3))), JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))),
            (Vec3(*(torch.as_tensor(o[:, i].copy()) for i in range(3))),
             Vec3(*(torch.as_tensor(d[:, i].copy()) for i in range(3)))))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_closest_and_any_hit_equal_to_jax(k):
    rng = np.random.default_rng(k)
    q = rng.normal(0, 1.5, (5, k + 1, 4)).astype(np.float32)
    q[:, :, 3] = 0.1 + np.abs(q[:, :, 3]) * 0.2
    jsc, tsc = _pair(q, ids=rng.integers(0, 2, 5))
    n = 512
    target = q[rng.integers(0, 5, n), rng.integers(0, k + 1, n), :3] + rng.normal(0, 0.4, (n, 3))
    o = rng.normal(0, 6, (n, 3))
    (jo, jd), (to, td) = _rays(o, target - o)
    want = J.closest_hit_curves(jsc, jo, jd)
    got = C.closest_hit_curves(tsc, to, td)
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert 0.2 < got.hit.numpy().mean() < 0.95
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=1e-6)
    for a, b in zip((got.u, *got.normal, *got.point), (want.u, *want.normal, *want.point)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    t_max = np.where(np.arange(n) % 2 == 0, 1e16, 4.0).astype(np.float32)
    np.testing.assert_array_equal(C.any_hit_curves(tsc, to, td, 1e-3, torch.as_tensor(t_max)).numpy(),
                                  np.asarray(J.any_hit_curves(jsc, jo, jd, 1e-3, jnp.asarray(t_max))))


def test_capsule_endcap_and_nearest_tube():
    _, tsc = _pair([[[0, 0, 0, 0.5], [2, 0, 0, 0.5]]])
    _, (to, td) = _rays([[1, 5, 0], [1, 5, 0], [-2, 5, 0], [-4, 0, 0]],
                        [[0, -1, 0], [0, 1, 0], [0, -1, 0], [1, 0, 0]])
    rec = C.closest_hit_curves(tsc, to, td)
    assert abs(float(rec.t[0]) - 4.5) < 1e-4 and abs(float(rec.normal.y[0]) - 1.0) < 1e-5
    assert rec.hit.tolist()[1:3] == [False, False]  # away from it, beside it
    assert abs(float(rec.t[3]) - 3.5) < 1e-3  # the round end cap at x = -0.5
    occ = C.any_hit_curves(tsc, to, td)
    assert bool(occ[0]) and not bool(occ[2])
    assert not bool(C.any_hit_curves(tsc, to, td, t_max=4.0)[0])
    _, two = _pair([[[0, 0, 0, 0.3], [2, 0, 0, 0.3]], [[0, 2, 0, 0.3], [2, 2, 0, 0.3]]], ids=[0, 0])
    rec = C.closest_hit_curves(two, *_rays([[1, 5, 0]], [[0, -1, 0]])[1])
    assert int(rec.seg[0]) == 1 and abs(float(rec.t[0]) - 2.7) < 1e-4


def test_whitted_engine_with_curves_equal_to_jax():
    w, h = 32, 24
    hs = JHost()
    hs.add_box(jmake(color=(0.75, 0.75, 0.75), roughness=0.9), pos=(0, -0.15, 0), extent=(8, 0.15, 8))
    jcs = jax_compile(hs, cluster_size=128)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    jcv = J.build_curves(ARCH, [jmake(color=(0.9, 0.25, 0.2), roughness=0.5)])
    tcv = C.build_curves(ARCH, [make_material(color=(0.9, 0.25, 0.2), roughness=0.5)], CPU)
    spec = [((0.0, 9.0, 1.0), (1.0, 1.0, 1.0), 140.0)]
    jl = jlights.build_lights([jlights.make_point_light(*spec[0]), jlights.make_ambient_light((1, 1, 1), 0.10)])
    tl = tlights.build_lights([tlights.make_point_light(*spec[0]), tlights.make_ambient_light((1, 1, 1), 0.10)], CPU)
    cam = Camera(eye=(0.0, 2.2, 8.0), lookat=(0.0, 1.0, 0.0), up=(0, 1, 0), fov_y=40, aspect_ratio=w / h)
    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)
    want = jwhitted.render_whitted(None, jcs, jl, jwhitted.WhittedConfig(width=w, height=h, max_depth=1),
                                   JCam.from_camera(cam), jnp.asarray(xs), jnp.asarray(ys), jnp.uint32(0),
                                   curves=jcv)
    got = twhitted.render_whitted(None, pcs, tl, twhitted.WhittedConfig(width=w, height=h, max_depth=1),
                                  CameraParams.from_camera(cam, CPU), torch.as_tensor(xs), torch.as_tensor(ys),
                                  0, curves=tcv)
    g = np.stack([c.numpy() for c in got], -1)
    wa = np.stack([np.asarray(c) for c in want], -1)
    assert np.isclose(g, wa, rtol=1e-5, atol=1e-6).all(-1).mean() >= 0.97
    np.testing.assert_allclose(g, wa, rtol=1e-3, atol=1e-4)
    red = (g[..., 0] > 1.5 * g[..., 1]) & (g[..., 0] > 0.05)
    assert red.mean() > 0.02  # the tube shows
