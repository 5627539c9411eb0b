"""Port parity, the engine's last options against the JAX cluster walk:
one case per option (`fused_shadows`, `env_via_bsdf`, `nee_rr`) on the open
golden scene, the port's cluster walk against the JAX engine's
(`traversal="cluster"`, its Pallas kernels in interpret mode), the walk
the port runs on the card. tests/test_torch_engine_options.py holds the
same options against the JAX lockstep walk on a glass-free scene; here the
open scene's glass box stays in, as both sides walk the clusters alike.
The JAX scene carries across (`interop`), so both walk one cluster order.
Each case is one launch (`trace_wavefront`, the JAX one jitted as its
renderer jits it) accumulated as the renderers' first frame: the
accumulation within rtol / atol 1e-5 (1.5e-6 read), and the rays traced
equal on every lane but one, which is pinned (ROADMAP C.10).

The parting lane, traced down (the bounce-by-bounce hit records of both
packages side by side): `PARTING[option]` names the lane (tile order),
the rays it traces in the JAX engine and in the port (the JAX engine
eager or jitted alike), and nothing else parts. Its mechanism:
- the lane's camera direction parts by 1-2 ulps: the JAX package
  normalises it with XLA's approximate `rsqrt`, the port with ATen's
  `1 / sqrt` (tests/test_torch_helpers.py, `normalize`);
- a later bounce of that path reaches the plane y = 0, where the glass
  box's bottom face (material 3) lies on the floor's top face (material 0):
  two coplanar triangles hit at the same t to a few ulps. The JAX engine
  keeps the floor's triangle, the port the glass box's, and from there the
  path traces different rays (`fused_shadows` / `env_via_bsdf`: the
  path's second sample continues in the JAX engine and ends in the port;
  `nee_rr`: one shadow ray more in the JAX engine);
- `test_parting_lane_is_a_coplanar_tie` shows both steps in the port.
`nee_rr` is in tests/test_torch_engine_options_cluster_rr.py (each JAX
interpret-mode compile takes 15-20 s on one CPU thread).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core import math as jm
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core import math as tm
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.rng import RngState, randf, tea
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from tests.golden_scenes import _open_scene, _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 24, 16
CAM = dict(eye=(3.2, 2.2, 4.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)
# option -> (lane, its rays in the JAX engine, its rays in the port)
PARTING = {"fused_shadows": (87, 12, 10), "env_via_bsdf": (87, 12, 10), "nee_rr": (92, 8, 7)}
GLASS_BOTTOM, FLOOR_TOP = 29, 31  # the two coplanar triangles at y = 0, in the carried cluster order


def _setup(opts):
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    base = dict(width=W, height=H, samples_per_launch=2, max_depth=2, traversal="cluster", **opts)
    jcfg = jwf.RenderConfig(**base)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pprobe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    return jcs, jcfg, pcs, pprobe, RenderConfig(**base)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_launch(cs, probe, cfg, cam, px, py, mask):
    out = jwf.trace_wavefront(cs, probe, cfg, cam, px, py, jnp.uint32(0), active_mask=mask)
    zero = jm.Vec3(*(jnp.zeros_like(out.color.x),) * 3)
    return jwf.accumulate(zero, out.color, jnp.uint32(0), cfg.samples_per_launch,
                          cfg.clamp_radiance), out.rays_traced


@pytest.mark.parametrize("opts", [dict(fused_shadows=True), dict(env_via_bsdf=True)],
                         ids=["fused", "env"])
def test_option_equal_to_jax_cluster_walk(opts):
    jcs, jcfg, pcs, pprobe, pcfg = _setup(opts)
    jr = JaxRenderer(jcs, _sky_probe(), jcfg, JaxCamera(**CAM))
    pr = Renderer(pcs, pprobe, pcfg, Camera(**CAM))
    jcam = jwf.CameraParams.from_camera(JaxCamera(**CAM))
    pcam = twf.CameraParams.from_camera(Camera(**CAM), CPU)
    n = pr.pixels[0].shape[0]
    np.testing.assert_array_equal(np.asarray(jr._px), pr.pixels[0].numpy())
    lane, want_lane, got_lane = PARTING[next(iter(opts))]

    def launch(mask):
        ja, jrays = _jax_launch(jcs, _sky_probe(), jcfg, jcam, jr._px, jr._py, jnp.asarray(mask))
        out = twf.trace_wavefront(pcs, pprobe, pcfg, pcam, *pr.pixels, 0,
                                  active_mask=torch.as_tensor(mask))
        pa = twf.accumulate(tm.Vec3.zeros((n,), CPU), out.color, 0, pcfg.samples_per_launch,
                            pcfg.clamp_radiance)
        return (np.stack([np.asarray(c) for c in ja], -1), int(jrays),
                np.stack([c.numpy() for c in pa], -1), int(out.rays_traced))

    every = np.ones(n, bool)
    ja, want, pa, got = launch(every)
    np.testing.assert_allclose(pa, ja, rtol=1e-5, atol=1e-5)
    assert want - got == want_lane - got_lane, (got, want)
    rest = every.copy()
    rest[lane] = False
    _, want_rest, _, got_rest = launch(rest)
    assert got_rest == want_rest  # every other lane traces the same rays
    # lanes trace apart from each other (a culled lane traces nothing): the
    # lane's own rays are the difference
    assert (want - want_rest, got - got_rest) == (want_lane, got_lane)


def _hits(cs, cfg, cam, px, py, mask, monkeypatch):
    """The port's closest-hit records of one launch: [(o, d, t, tri)] per call."""
    calls = []
    inner = twf.closest_hit_cluster

    def record(cl, o, d, t_min, t_max, *a, **k):
        rec = inner(cl, o, d, t_min, t_max, *a, **k)
        calls.append((torch.stack(list(o)), torch.stack(list(d)), rec.t.clone(), rec.tri.clone()))
        return rec

    monkeypatch.setattr(twf, "closest_hit_cluster", record)
    twf.trace_wavefront(cs, _probe(), cfg, cam, px, py, 0, active_mask=mask)
    return calls


def _probe():
    return interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)


def _mt_t(scene, tri, o, d):
    """Möller-Trumbore t of one ray against one triangle, in float64."""
    v0, v1, v2 = (np.array([float(c[tri]) for c in v], np.float64) for v in (scene.v0, scene.v1, scene.v2))
    o, d = o.double().numpy(), d.double().numpy()
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2)
    inv = 1.0 / np.dot(e1, p)
    s = o - v0
    q = np.cross(s, e1)
    u, v = np.dot(s, p) * inv, np.dot(d, q) * inv
    return np.dot(e2, q) * inv, u, v


@pytest.mark.parametrize("option", sorted(PARTING))
def test_parting_lane_is_a_coplanar_tie(option, monkeypatch):
    """The mechanism of `PARTING[option]`'s lane, in the port: (1) its
    camera direction through the JAX `normalize` and the port's parts (the
    same unnormalised vector, XLA's `rsqrt` against ATen's); (2) one of its
    hits lands on the glass box's bottom face at y = 0 where the floor's
    top face, another material, meets the same ray at the same t within
    2e-6 relative: a tie the packages' ulp-level ray differences break
    apart."""
    opts = {option: 0.5 if option == "nee_rr" else True}
    _, _, pcs, _, pcfg = _setup(opts)
    pr = Renderer(pcs, _probe(), pcfg, Camera(**CAM))
    pcam = twf.CameraParams.from_camera(Camera(**CAM), CPU)
    px, py = pr.pixels
    lane = PARTING[option][0]
    n = px.shape[0]

    # (1) the camera direction of sample 0, as `_raygen` forms it
    pix = (py.long() * W + px.long()) & 0xFFFFFFFF
    ctr = torch.zeros(n, dtype=torch.int64)
    state = RngState.seed(tea(pix, ctr))
    state, ax = randf(state)
    state, ay = randf(state)
    dx = 2.0 * (px.float() + ax) / torch.tensor(float(W)) - 1.0
    dy = 2.0 * (py.float() + ay) / torch.tensor(float(H)) - 1.0
    raw = pcam.u * dx + pcam.v * dy + pcam.w * 1.0
    d0 = twf._raygen(pcfg, pcam, px, py, pix, ctr)[2]
    assert torch.equal(torch.stack(list(d0)), torch.stack(list(tm.normalize(raw))))
    mine = torch.stack(list(tm.normalize(raw)))[:, lane].numpy()
    theirs = np.array([np.asarray(c)[lane] for c in jm.normalize(jm.Vec3(*(jnp.asarray(c.numpy()) for c in raw)))])
    assert not np.array_equal(mine, theirs)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=2.4e-7)

    # (2) the coplanar tie on one of the lane's hits
    mask = torch.zeros(n, dtype=torch.bool)
    mask[lane] = True
    ties = []
    for o, d, t, tri in _hits(pcs, pcfg, pcam, px, py, mask, monkeypatch):
        for k in range(lane, t.shape[0], n):
            if int(tri[k]) == GLASS_BOTTOM:
                t_floor, u, v = _mt_t(pcs.scene, FLOOR_TOP, o[:, k], d[:, k])
                y = float(o[1, k] + t[k] * d[1, k])
                ties.append((abs(t_floor - float(t[k])) / float(t[k]), u, v, y))
    assert ties, "the lane never hits the glass box's bottom face"
    rel, u, v, y = ties[0]
    assert rel <= 2e-6 and u >= 0 and v >= 0 and u + v <= 1 and abs(y) <= 1e-6, ties
    scene = pcs.scene
    assert int(scene.material_id[GLASS_BOTTOM]) == 3 and int(scene.material_id[FLOOR_TOP]) == 0
