"""Port parity, the bench: `optixpathtracer_tpu_torch/bench.py` and
`scenes.build_hostile_scene` against the repository's bench.py.

- The hostile scene is bit-equal to bench.py's (vertices, indices,
  materials, the material table) at three sizes.
- `measure_utilization`'s rays: the port's camera rays in tile order and
  its coherence-sorted bounce rays equal, bit for bit, the rays bench.py
  hands the JAX package's `block_cull` / `closest_hit_cluster` /
  `closest_hit_cluster_exec_stats` (recorded by stand-ins).
- End to end on the CPU: `python -m optixpathtracer_tpu_torch bench --small
  --cpu` and `bench.py --small --cpu` in child processes print the same
  headline `metric` first and the same `triangles`. Their `rays_total`
  part by 16 rays: the jitted JAX lockstep walk departs from its own eager
  run on a few lanes (XLA fuses its arithmetic), and the port follows the
  eager run (pinned in tests/test_torch_bench_rays.py).
- A missing committed reference gives the error row, and `main` then
  exits non-zero.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref_bench
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JCamera
from optixpathtracer_tpu.core.materials import build_table as jax_build_table
from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch import bench, interop, scenes
from optixpathtracer_tpu_torch.core.materials import build_table

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 600  # a child takes 25-80 s alone, more beside other workers


@pytest.mark.parametrize("kw", [dict(n_boxes=60, terrain_grid=(32, 16)), dict(n_boxes=980), {}],
                         ids=["tiny", "small", "default"])
def test_build_hostile_scene_matches_bench(kw):
    mine, ref = scenes.build_hostile_scene(**kw), ref_bench.build_hostile_scene(**kw)
    assert len(mine.meshes) == len(ref.meshes) == 9
    for a, b in zip(mine.meshes, ref.meshes):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.vertices.dtype == b.vertices.dtype and a.indices.dtype == b.indices.dtype
        assert a.material == b.material
    np.testing.assert_array_equal(
        build_table([m.material for m in mine.meshes], CPU).rows.numpy(),
        np.asarray(jax_build_table([m.material for m in ref.meshes]).rows))
    if not kw:
        assert sum(len(m.indices) for m in mine.meshes) == 2 * 255 * 63 + 12 * 9800


class _Recorder:
    """Stand-ins for the JAX package's sweeps inside bench.py's
    measure_utilization: each records the rays it is handed, as (n, 3)
    numpy arrays, and returns zeros of the right shape."""

    def __init__(self):
        self.calls = []

    def _rec(self, name, o, d):
        self.calls.append((name, np.stack([np.asarray(c) for c in o], -1),
                           np.stack([np.asarray(c) for c in d], -1)))
        return o.x.shape[0]

    def block_cull(self, cs, o, d, t_min, t_max, block=128, **kw):
        n = self._rec("cull", o, d)
        bits = jnp.zeros((n // block, 1), jnp.int32)
        return SimpleNamespace(bits_lo=bits, bits_hi=bits)

    def closest_hit_cluster(self, cs, o, d, t_min=1e-3, t_max=1e16, **kw):
        return SimpleNamespace(t=jnp.zeros((self._rec("sweep", o, d),), jnp.float32))

    def closest_hit_cluster_exec_stats(self, cs, o, d, t_min=1e-3, t_max=1e16, **kw):
        n = self._rec("exec", o, d)
        return jnp.zeros((n,), jnp.float32), jnp.float32(0.0)


def test_utilization_rays_match_bench(monkeypatch):
    jcs = jax_compile(ref_bench.build_city_scene(n_boxes=400), leaf_size=8, wide_width=8,
                      build_wide_bvh=False, cluster_size=256)
    pcl = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU).clusters
    rec = _Recorder()
    for name in ("block_cull", "closest_hit_cluster", "closest_hit_cluster_exec_stats"):
        monkeypatch.setattr(jtc, name, getattr(rec, name))
    jcam = JCamera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0), fov_y=45,
                   aspect_ratio=1.5)
    with jax.disable_jit():  # the stand-ins see arrays, not tracers
        ref_bench.measure_utilization(jcs, jcam)

    ocam, dcam, ob, db = bench.utilization_rays(pcl, scenes.city_camera(1200, 800))
    for a in (ocam, dcam, ob, db):
        assert a.shape == (bench.UTIL_RAYS, 3) and a.dtype == np.float32
    names = [c[0] for c in rec.calls]
    assert names == ["cull", "sweep", "sweep", "exec", "cull", "sweep", "sweep", "exec",
                     "sweep", "sweep"]
    for i, (o, d) in zip((0, 4), ((ocam, dcam), (ob, db))):
        for j in range(i, i + 4):
            np.testing.assert_array_equal(rec.calls[j][1], o)
            np.testing.assert_array_equal(rec.calls[j][2], d)
    for j in (8, 9):  # the 8x tiled bounce rays of scale8
        np.testing.assert_array_equal(rec.calls[j][1], np.tile(ob, (8, 1)))
        np.testing.assert_array_equal(rec.calls[j][2], np.tile(db, (8, 1)))


def test_member_evals_per_block_counts_bench_bits():
    """bench.py's selectivity count on the same cull bits."""
    rng = np.random.default_rng(5)
    lo = rng.integers(-2**31, 2**31, (64, 12), dtype=np.int64).astype(np.int32)
    hi = np.where(rng.random((64, 12)) < 0.5, 0, lo[::-1]).astype(np.int32)
    lo[3] = 0
    u = (lo | (lo >> 8) | (lo >> 16) | (lo >> 24) | hi | (hi >> 8) | (hi >> 16) | (hi >> 24)) & 0xFF
    want = float(sum(((u >> k) & 1).astype(np.int64).sum(axis=1) for k in range(8)).mean())
    assert bench.member_evals_per_block(lo, hi) == want


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


HEADLINE = "Mrays/s incoherent (Disney PT, depth 4, 150k-tri city, 1200x800)"
# rays_total of the two timed frames: the port traces 16 rays the jitted JAX
# lockstep walk does not, where that walk departs from its own eager run
SMALL_CPU_RAYS = {"port": 381368.0, "reference": 381352.0}


@pytest.mark.parametrize("which", sorted(SMALL_CPU_RAYS))
def test_bench_small_cpu_matches_reference(which, tmp_path):
    """Both benches as a user runs them: the port from any directory (the
    package on PYTHONPATH), bench.py from the repository root (it reads its
    modules relative to it) on one XLA device, as its --cpu asks. Each is
    held to the same headline metric, triangles and gates."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    if which == "port":
        argv, cwd = ["-m", "optixpathtracer_tpu_torch", "bench"], str(tmp_path)
        # four torch threads: ~35 s alone, and no oversubscription beside
        # the suite's other workers (all of a machine's threads can thrash)
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="4")
    else:
        argv, cwd = ["bench.py"], REPO
    proc = subprocess.run([sys.executable, *argv, "--small", "--cpu"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = _lines(proc.stdout)
    assert len(rows) == 1  # --small: the headline alone, first
    assert proc.stdout.splitlines()[0].startswith("{")
    assert set(rows[0]) == {"metric", "value", "unit", "vs_baseline"}
    assert rows[0]["metric"] == HEADLINE and rows[0]["value"] > 0
    det = _lines(proc.stderr)[-1]["detail"]
    assert det["triangles"] == 4812 and det["traversal"] == "lockstep"
    assert det["overflow"] == 0.0 and det["gate_mismatch_rays"] == 0
    assert not det["quality_gated_out"] and det["utilization"] is None
    assert det["rays_total"] == SMALL_CPU_RAYS[which]
    if which == "port":
        assert (det["width"], det["height"], det["spp"], det["scene"]) == (320, 240, 1, "city")
        assert det["devices"] == ["cpu"] and det["failed"] == []


def test_missing_reference_artifact_gives_error_row_and_nonzero_exit(tmp_path, monkeypatch,
                                                                      capsys):
    """bench.py's tracks with the committed references missing (REPO
    pointed at an empty directory): the quality track and the 4K row print
    their error rows, the demand row (no loft.obj) its exception as a row,
    and main exits 1 where bench.py exits 0. The headline runs first on a
    small scene; the other rows are stand-ins."""
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    monkeypatch.setattr(bench, "runs_tracks", lambda args, on_cpu: True)
    monkeypatch.setattr(bench, "_scene",
                        lambda name, small: (scenes.build_city_scene(n_boxes=4), "150k-tri city"))
    ok = {"unit": "fps", "vs_baseline": 0.0, "value": 1.0}
    monkeypatch.setattr(bench, "per_config_lines", lambda *a: [dict(ok, metric="preset")])
    monkeypatch.setattr(bench, "interactive_line", lambda *a: dict(ok, metric="interactive"))
    assert bench.main(["--small", "--cpu", "--no-big"]) == 1
    out, err = capsys.readouterr()
    rows = _lines(out)
    assert rows[0]["metric"] == HEADLINE
    assert rows[0]["value"] > 0
    errors = {r["metric"]: r["error"] for r in rows if "error" in r}
    assert set(errors) == {bench.QUALITY_METRIC, bench.DEMAND_METRIC, bench.FOVEA4K_METRIC}
    assert [r["metric"] for r in rows].count(bench.QUALITY_METRIC) == 2  # 600x400 and 1200x800
    assert "ref_city_1200x800.npz" in [r["error"] for r in rows
                                       if r["metric"] == bench.QUALITY_METRIC][1]
    assert "missing committed 4K reference artifact" in errors[bench.FOVEA4K_METRIC]
    assert all(r["value"] == 0.0 for r in rows if "error" in r)
    detail = _lines(err)[-1]["detail"]
    assert len(detail["failed"]) == 4 and "BENCH FAILED" in err


def test_gated_out_headline_exits_nonzero(monkeypatch, capsys):
    """An overflow (or a gate mismatch) zeroes the headline, as bench.py
    does, and main exits 1."""
    from optixpathtracer_tpu_torch.engine import renderer

    render = renderer.Renderer.render

    def overflowing(self, *a, **kw):
        out = render(self, *a, **kw)
        self._last = self._last._replace(bfs_overflow=torch.tensor(3.0))
        return out

    monkeypatch.setattr(renderer.Renderer, "render", overflowing)
    monkeypatch.setattr(bench, "_scene",
                        lambda name, small: (scenes.build_city_scene(n_boxes=4), "150k-tri city"))
    assert bench.main(["--small", "--cpu"]) == 1
    out, err = capsys.readouterr()
    assert _lines(out)[0]["value"] == 0.0 and _lines(out)[0]["vs_baseline"] == 0.0
    detail = _lines(err)[-1]["detail"]
    assert detail["quality_gated_out"] and detail["overflow"] == 6.0



def test_multi_device_frames_two_gloo_ranks_trace_one_devices_rays():
    """The headline's branch for more than one card, on two gloo ranks on
    the CPU: strips over `DistributedRenderer` after one warm-up frame trace
    the rays one device's second frame traces."""
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.engine.renderer import Renderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.lights.probe import build_probe

    hs = scenes.build_city_scene(n_boxes=40)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    cfg = RenderConfig(width=32, height=24, samples_per_launch=1, max_depth=4,
                       traversal="lockstep", dispatch_tiles=1, sort_rays=False,
                       nee_final_bounce=False, batch_spp=False)
    cam = scenes.city_camera(32, 24)
    rays, seconds = bench.multi_device_frames(hs, sky, cfg, cam, world=2, frames=1,
                                              backend="gloo", device="cpu")
    r = Renderer(compile_scene(hs, CPU, **bench.BUILD), build_probe(sky, CPU), cfg, cam)
    r.render()
    r.render()
    assert rays == float(r.last_output.rays_traced) > 0 and seconds > 0
