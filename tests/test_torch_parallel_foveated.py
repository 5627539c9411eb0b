"""Port parity, parallel/foveated: the fused zone wavefront sharded by lanes
over gloo CPU ranks.

`rr` pads with its fill value and interleaves lanes round-robin (the d-th
slice holds lanes l % n == d), and `unrr` undoes it, as the reference's
closures (optixpathtracer_tpu/parallel/foveated.py:95-104) do. The port's
`DistributedFoveatedRenderer` on 2 and 3 spawned ranks against the JAX
`DistributedFoveatedRenderer` on a mesh of as many CPU devices, on the
reference's fast-tier scene (tests/test_parallel_foveated.py: a floor box,
48x32, depth 1, no antialiasing, radii 8/16), over a gaze move: the
accumulation within the reference's 1e-6 after each frame, the ray counts
equal, per rank as well, and equal to the port's single-device fused
renderer's frame.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.materials import make_material as jax_material
from optixpathtracer_tpu.core.scene import HostScene as JaxHostScene
from optixpathtracer_tpu.engine.foveated import FoveationConfig as JaxFoveation
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu.parallel.foveated import DistributedFoveatedRenderer as JaxDistributed
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine.foveated import FoveatedRenderer, FoveationConfig
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.parallel import dryrun, ranks
from optixpathtracer_tpu_torch.parallel.foveated import rr, unrr

torch.set_num_threads(1)
W, H = 48, 32
CFG = dict(width=W, height=H, max_depth=1, antialias=False)
FOV = dict(inner_radius=8, outer_radius=16)
VIEW = dict(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)
PROBE = np.full((8, 16, 3), 0.5, np.float32)
GAZES = [(24, 16), (10, 20)]
TOL = dict(rtol=1e-6, atol=1e-6)  # tests/test_parallel_foveated.py:51-52


def scene(host_cls, material):
    hs = host_cls()
    hs.add_box(material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    return hs


@pytest.mark.parametrize("n_dev,n", [(2, 7), (3, 7), (4, 8), (8, 3)])
def test_rr_unrr(n_dev, n):
    lanes = torch.arange(n, dtype=torch.int64) + 10
    out = rr(lanes, -1, n_dev)
    n_pad = -(-n // n_dev) * n_dev
    assert out.shape == (n_pad,)
    m = n_pad // n_dev
    for d in range(n_dev):  # slice d holds lanes l with l % n_dev == d, then the fill
        want = [10 + l if l < n else -1 for l in range(d, n_pad, n_dev)]
        assert out[d * m:(d + 1) * m].tolist() == want
    torch.testing.assert_close(unrr(out, n_dev, n), lanes, rtol=0, atol=0)
    act = rr(torch.ones(n, dtype=torch.bool), False, n_dev)
    assert int(act.sum()) == n and act.dtype == torch.bool


def _jax_frames(world):
    cs = jax_compile(scene(JaxHostScene, jax_material))
    r = JaxDistributed(cs, jax_build_probe(PROBE), JaxConfig(**CFG), JaxCamera(**VIEW),
                       JaxFoveation(**FOV), mesh=JaxMesh(np.asarray(jax.devices()[:world]), ("lanes",)))
    images, rays, rays_dev = [], [], []
    for g in GAZES:
        r.set_gaze(*g)
        r.render()
        images.append(r.accum_image())
        rays.append(r.last_rays)
        rays_dev.append(np.asarray(r.last_rays_per_device))
    return images, rays, rays_dev


@pytest.mark.parametrize("world", [2, 3])
def test_distributed_foveated_vs_jax(tmp_path, world):
    cfg = RenderConfig(traversal="cluster", **CFG)
    hs = scene(HostScene, make_material)
    res = ranks.run_ranks(dryrun.foveated_program, world, "gloo", "cpu", str(tmp_path / "rendezvous"),
                          args=(hs, PROBE, cfg, Camera(**VIEW), FoveationConfig(**FOV), GAZES),
                          timeout_s=120)
    got = res[0]
    assert got["imported"] == []
    want_images, want_rays, want_dev = _jax_frames(world)
    cpu = torch.device("cpu")
    single = FoveatedRenderer(compile_scene(hs, cpu), build_probe(PROBE, cpu), cfg, Camera(**VIEW),
                              FoveationConfig(**FOV), fused=True)
    for k, g in enumerate(GAZES):
        single.set_gaze(*g)
        single.render(download=False)
        np.testing.assert_allclose(got["images"][k], want_images[k], **TOL)
        np.testing.assert_allclose(got["images"][k], single.accum_image(), **TOL)
        assert got["rays"][k] == want_rays[k] == single.last_rays
        np.testing.assert_array_equal(got["rays_per_device"][k], want_dev[k])
        for other in res[1:]:
            np.testing.assert_array_equal(other["images"][k], got["images"][k])
