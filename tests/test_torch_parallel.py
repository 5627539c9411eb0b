"""Port parity, parallel/tiles: strip data parallelism over gloo CPU ranks.

`TileLayout` bit-equal to the JAX one; the port's `DistributedRenderer` on
2 spawned gloo ranks (4 in tests/test_torch_parallel_four.py) (parallel/ranks.py, a `file://` rendezvous under
tmp_path, one thread a rank) against the JAX `DistributedRenderer` on
`make_mesh(jax.devices()[:R])` with the cluster traversal (Pallas interpret
mode, as `__graft_entry__.py:182` runs it) on the dry run's tiny scene: the
per-rank ray counts equal JAX's `last_rays_per_device` exactly, the
gathered frame holds within the reference's rtol 2e-4 / atol 2e-5 against
the JAX frame and against the port's single-device `Renderer`, and every
rank gathers the same frame. The children import the port only: no jax,
no JAX package, no PIL. The dry run itself runs at 2 ranks. The sharded
demand case is tests/test_torch_parallel_demand.py.
"""
import dataclasses

import jax
import numpy as np
import pytest

from __graft_entry__ import _tiny_setup
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.parallel.tiles import DistributedRenderer as JaxDistributed
from optixpathtracer_tpu.parallel.tiles import TileLayout as JaxLayout
from optixpathtracer_tpu.parallel.tiles import make_mesh
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.parallel import dryrun, ranks
from optixpathtracer_tpu_torch.parallel.tiles import TileLayout

W, H = 32, 24
TOL = dict(rtol=2e-4, atol=2e-5)  # __graft_entry__.py:191
CFG = dict(width=W, height=H, samples_per_launch=2, max_depth=2)


@pytest.mark.parametrize("w,h,n,strip_rows", [
    (8, 16, 4, 1), (64, 48, 8, 1), (33, 7, 3, 1), (40, 30, 2, 4), (17, 64, 4, 3), (5, 5, 8, 2),
])
def test_tile_layout_bit_equal(w, h, n, strip_rows):
    got = TileLayout.build(w, h, n, strip_rows)
    want = JaxLayout.build(w, h, n, strip_rows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_distributed(world):
    cs, probe, _, _ = _tiny_setup()  # the scene and probe of dryrun.tiny_scene / TINY_PROBE
    cfg = JaxConfig(traversal="cluster", **CFG)
    cam = JaxCamera(**dataclasses.asdict(dryrun.tiny_camera(W, H)))
    r = JaxDistributed(cs, probe, cfg, cam, mesh=make_mesh(jax.devices()[:world]))
    r.render()
    return r


def check_vs_jax(tmp_path, world):
    res = ranks.run_ranks(
        dryrun.strip_program, world, "gloo", "cpu", str(tmp_path / "rendezvous"),
        args=(dryrun.tiny_scene, dryrun.TINY_PROBE, RenderConfig(traversal="cluster", **CFG),
              dryrun.tiny_camera(W, H)),
        kwargs=dict(single=True), timeout_s=120)
    want = _jax_distributed(world)
    got = res[0]
    assert got["imported"] == []
    np.testing.assert_array_equal(np.asarray(got["rays_per_device"]),
                                  np.asarray(want.last_rays_per_device))
    assert got["rays"] == want.last_rays == float(np.sum(got["rays_per_device"]))
    np.testing.assert_allclose(got["image"], want.accum_image(), **TOL)
    np.testing.assert_allclose(got["image"], got["single_image"], **TOL)
    assert got["single_rays"] == got["rays"]
    for other in res[1:]:
        np.testing.assert_array_equal(other["image"], got["image"])
        np.testing.assert_array_equal(other["rays_per_device"], got["rays_per_device"])


def test_distributed_renderer_vs_jax(tmp_path):
    check_vs_jax(tmp_path, 2)  # 4 ranks: tests/test_torch_parallel_four.py


def test_dryrun_two_ranks(capsys):
    assert dryrun.main(["--ranks", "2", "--cpu"]) == 0
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("dryrun_multichip(2): ok, rays=") and "(gate 10%)" in line


def test_failed_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="ranks failed"):
        ranks.run_ranks(dryrun.strip_program, 2, "gloo", "cpu", str(tmp_path / "rendezvous"),
                        args=(dryrun.tiny_scene, dryrun.TINY_PROBE,
                              RenderConfig(traversal="cluster", width=W + 1, height=H + 1),
                              dryrun.tiny_camera(W, H)),
                        timeout_s=60)


def test_backend_and_device_are_named():
    with pytest.raises(ValueError, match="backend"):
        ranks.run_ranks(dryrun.dryrun_program, 2, "mpi", "cpu", "unused")
    with pytest.raises(ValueError, match="NCCL"):
        ranks.run_ranks(dryrun.dryrun_program, 1, "nccl", "cpu", "unused")
