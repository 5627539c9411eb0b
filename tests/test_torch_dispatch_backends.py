"""Port parity, backend dispatch (the cases of tests/test_dispatch.py):
every backend agrees on the same scene, closest hit and occlusion, and
each matches the JAX package's on the same rays; the presets reach the
backends only through `ops.dispatch`; and the presets take their traversal
from `utils/platform.auto_tune` (the cluster walk on a card, the lockstep
walk on a CPU), explicit overrides winning.

Tolerances: `tri` and occlusion bit for bit across backends and against
JAX; t within rtol / atol 1e-5 across backends (tests/test_dispatch.py's).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.scene import HostScene as JHost
from optixpathtracer_tpu.ops import dispatch as jdispatch
from optixpathtracer_tpu_torch import models
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.ops import dispatch
from optixpathtracer_tpu_torch.utils import platform

torch.set_num_threads(1)
CPU = torch.device("cpu")
PKG = pathlib.Path(__file__).resolve().parents[1] / "optixpathtracer_tpu_torch"
BACKENDS = ("lockstep", "bfs", "dense", "cluster", "oracle")


@pytest.fixture(scope="module")
def scenes_():
    def fill(hs, mk):
        hs.add_box(mk(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(5, 0.1, 5))
        hs.add_box(mk(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
        return hs

    return (compile_scene(fill(HostScene(), make_material), CPU, cluster_size=64),
            jax_compile(fill(JHost(), jmake), cluster_size=64))


def _rays(n=300, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 3, n)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ((Vec3(*(torch.as_tensor(o[:, i].copy()) for i in range(3))),
             Vec3(*(torch.as_tensor(d[:, i].copy()) for i in range(3)))),
            (JVec3(*(jnp.asarray(o[:, i]) for i in range(3))), JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))))


def test_all_backends_agree(scenes_):
    cs, jcs = scenes_
    (o, d), (jo, jd) = _rays()
    recs = {tr: dispatch.trace_closest(cs, o, d, 1e-3, 1e16, traversal=tr) for tr in BACKENDS}
    base = recs["lockstep"]
    hits = base.hit.numpy()
    assert 0.3 < hits.mean() < 1.0
    for name, rec in recs.items():
        np.testing.assert_array_equal(rec.tri.numpy(), base.tri.numpy(), err_msg=name)
        np.testing.assert_allclose(rec.t.numpy()[hits], base.t.numpy()[hits], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for tr in ("lockstep", "bfs", "dense"):  # the JAX package has no oracle entry in dispatch
        np.testing.assert_array_equal(recs[tr].tri.numpy(),
                                      np.asarray(jdispatch.trace_closest(jcs, jo, jd, 1e-3, 1e16,
                                                                         traversal=tr).tri), err_msg=tr)


def test_occlusion_backends_agree(scenes_):
    cs, jcs = scenes_
    (o, d), (jo, jd) = _rays(seed=7)
    base = dispatch.trace_occluded(cs, o, d, 1e-2, 8.0, traversal="lockstep").numpy()
    assert 0 < base.mean() < 1
    for tr in BACKENDS:
        np.testing.assert_array_equal(dispatch.trace_occluded(cs, o, d, 1e-2, 8.0, traversal=tr).numpy(),
                                      base, err_msg=tr)
    np.testing.assert_array_equal(
        np.asarray(jdispatch.trace_occluded(jcs, jo, jd, 1e-2, 8.0, traversal="lockstep")), base)


def test_presets_do_not_hardwire_backends():
    """No preset or engine imports a traversal backend directly: they go
    through ops.dispatch (engine/wavefront's config-driven selector being
    the one sanctioned exception)."""
    banned = ("ops.traverse import", "ops.traverse_bfs import", "ops.traverse_cluster import",
              "ops.dense import", ".traverse import", ".traverse_bfs import", ".dense import")
    for rel in ("models/hello_raytracing.py", "models/whitted.py", "engine/whitted.py",
                "engine/foveated.py", "engine/spectral.py"):
        src = (PKG / rel).read_text()
        for b in banned:
            assert b not in src, f"{rel} hardwires a traversal backend ({b})"


def test_wavefront_presets_auto_tune(scenes_, monkeypatch):
    """The disney / spectral / foveated / adaptive presets route their
    RenderConfig through auto_tune: the cluster walk on an accelerator, the
    lockstep walk and one dispatch tile on a CPU; explicit overrides win."""
    cs, _ = scenes_
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32), CPU)
    cam = Camera()
    kw = dict(width=64, height=48)
    cpu = models.make_disney_pt_renderer(cs, probe, cam, spp=1, dispatch_tiles=3, **kw)
    assert cpu.config.traversal == "lockstep" and cpu.config.dispatch_tiles == 3  # an override wins
    assert models.make_spectral_renderer(cs, probe, cam, spp=1, **kw).config.traversal == "lockstep"
    base = RenderConfig(dispatch_tiles=5, sort_rays=False)
    assert platform.auto_tune(base, CPU) == dataclasses.replace(base, traversal="lockstep", dispatch_tiles=1)
    assert platform.auto_tune(base, "cuda") == dataclasses.replace(base, traversal="cluster")

    monkeypatch.setattr(platform, "on_accelerator", lambda device: True)
    r = models.make_disney_pt_renderer(cs, probe, cam, spp=1, **kw)
    assert r.config.traversal == "cluster" and not r.config.sort_rays
    assert models.make_spectral_renderer(cs, probe, cam, spp=1, **kw).config.traversal == "cluster"
    assert models.make_foveated_renderer(cs, probe, cam, **kw).config.traversal == "cluster"
    assert models.make_adaptive_renderer(cs, probe, cam, spp=1, **kw).config.traversal == "cluster"
    r2 = models.make_disney_pt_renderer(cs, probe, cam, spp=1, traversal="lockstep", **kw)
    assert r2.config.traversal == "lockstep"
