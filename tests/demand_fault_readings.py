"""Readings of the demand-texture comparisons under planted faults.

Each comparison that holds the port's demand path (io/demand and the
engine's paging) against a reference is run sound and with one fault
planted in this process at a time, so that each limit can be shown to sit
between the sound reading and the fault readings. The faults, planted by
wrapping the port's functions (no file changes):

- `lod+1`, `lod+0.25`, `lod-0.25`: the engine's mip LOD shifted by that
  many levels (`wavefront.sample_demand` given lod + delta);
- `row`: a pool row left unwritten (the first tile a pager reads comes
  back as the pool's initial zeros);
- `texel`: every fetch one texel to the left (`io.demand._sample_level`
  given u - 1 / width).

Comparisons (every one on the CPU):

- `engine`: tests/test_torch_demand_engine.py's
  `test_demand_render_matches_jax` (frame 0, one-level pool): the share of
  pixels whose first-hit albedo agrees to 1e-5, the count of those pixels
  outside rtol / atol 1e-5, and the sqrt-space RMSE against the JAX
  renderer's frame;
- `mip`: tests/test_torch_demand_mip.py's two planes against the JAX
  renderer: usage bits that differ, page tables equal, sqrt-space RMSE;
- `window`: chip_smoke.py's demand_big (b) card-against-CPU renders
  (4096x4096 seeded texture, levels 4, 160x100: the whole view, and the
  window at the 1200x800 frame's pixel footprint), sound against faulty,
  both on the CPU: page tables equal, sqrt-space RMSE. Its pool takes
  about 0.3 GB.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/demand_fault_readings.py [engine|mip|window ...]

Prints one line per comparison and fault.
"""
import contextlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from optixpathtracer_tpu_torch import scenes  # noqa: E402
from optixpathtracer_tpu_torch.engine import wavefront  # noqa: E402
from optixpathtracer_tpu_torch.io import demand  # noqa: E402

FAULTS = ("none", "lod+1", "lod+0.25", "lod-0.25", "row", "texel")
CPU = torch.device("cpu")


@contextlib.contextmanager
def planted(fault):
    """The port with `fault` planted for the duration of the block."""
    real_sample, real_level, real_read = (wavefront.sample_demand, demand._sample_level,
                                          demand.DemandTextureManager._read_tile)
    if fault.startswith("lod"):
        delta = float(fault[3:])

        def sample(pool, tid, u, v, lod=None, trilinear=False):
            return real_sample(pool, tid, u, v, lod=None if lod is None else lod + delta, trilinear=trilinear)

        wavefront.sample_demand = sample
    elif fault == "row":
        first = []

        def read(self, page):
            tile = real_read(self, page)
            if not first:
                first.append(page)
                return np.zeros_like(tile)
            return tile

        demand.DemandTextureManager._read_tile = read
    elif fault == "texel":
        def level(pool, tid, u, v, lvl):
            return real_level(pool, tid, u - 1.0 / pool.width[tid, lvl].to(torch.float32), v, lvl)

        demand._sample_level = level
    try:
        yield
    finally:
        wavefront.sample_demand, demand._sample_level = real_sample, real_level
        demand.DemandTextureManager._read_tile = real_read


def engine_readings():
    import test_torch_demand_engine as te
    from optixpathtracer_tpu.builder import compile_scene as jax_compile
    from optixpathtracer_tpu.core.camera import Camera as JaxCamera
    from optixpathtracer_tpu.core.materials import make_material as jax_material
    from optixpathtracer_tpu.core.scene import HostScene as JaxHostScene
    from optixpathtracer_tpu.core.scene import Mesh as JaxMesh
    from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
    from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
    from optixpathtracer_tpu.io.demand import DemandTextureManager as JaxManager
    from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
    from optixpathtracer_tpu_torch import interop

    jhs = te.textured_scene(JaxHostScene, JaxMesh, jax_material)
    jcs = jax_compile(jhs, cluster_size=128, build_wide_bvh=False)
    jprobe = jax_build_probe(np.full((8, 16, 3), 1.0, np.float32))
    cfg = dict(width=te.W, height=te.H, samples_per_launch=2, max_depth=2)
    jr = JaxRenderer(jcs, jprobe, JaxConfig(traversal="lockstep", **cfg), JaxCamera(**te.VIEW),
                     demand=JaxManager.from_host_scene(jhs, capacity=64))
    jr.render()
    want, jalb = jr.accum_image(), jr.aovs()["albedo"]
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    for fault in FAULTS:
        with planted(fault):
            mgr = demand.DemandTextureManager.from_host_scene(jhs, capacity=64, device=CPU)
            r = te.Renderer(pcs, probe, te.RenderConfig(traversal="cluster", **cfg), te.Camera(**te.VIEW),
                            demand=mgr)
            r.render()
        got = r.accum_image()
        same = (np.abs(r.aovs()["albedo"] - jalb) <= 1e-5).all(-1)
        outside = int((np.abs(got - want)[same] > 1e-5 + 1e-5 * np.abs(want[same])).sum())
        print(f"engine fault={fault} same_albedo_share={same.mean():.4f} outside_1e-5={outside} "
              f"sqrt_rmse={scenes.golden_rmse(got, want):.3g}", flush=True)


def mip_readings():
    import test_torch_demand_mip as tm
    from optixpathtracer_tpu.builder import compile_scene as jax_compile
    from optixpathtracer_tpu.core.camera import Camera as JaxCamera
    from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
    from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
    from optixpathtracer_tpu.io.demand import DemandTextureManager as JaxManager
    from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
    from optixpathtracer_tpu_torch import interop

    for tiles, repeats, w, h in ((4, 40, 64, 40), (8, 4, 96, 60)):
        hs = tm._plane(tiles, repeats)
        view = dict(eye=(0, 1.5, 8), lookat=(0, 0.5, 0), up=(0, 1, 0), fov_y=50, aspect_ratio=w / h)
        cfg = dict(width=w, height=h, samples_per_launch=1, max_depth=1)
        jcs = jax_compile(hs, cluster_size=128, build_wide_bvh=False)
        jprobe = jax_build_probe(np.full((8, 16, 3), 1.0, np.float32))
        jmgr = JaxManager.from_host_scene(hs, capacity=256, levels=4)
        jr = JaxRenderer(jcs, jprobe, JaxConfig(traversal="lockstep", **cfg), JaxCamera(**view), demand=jmgr)
        jr.render()
        jusage, want = np.asarray(jr._last.tex_usage), jr.accum_image()
        pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
        probe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
        for fault in FAULTS:
            with planted(fault):
                mgr = demand.DemandTextureManager.from_host_scene(hs, capacity=256, levels=4, device=CPU)
                r = tm.Renderer(pcs, probe, tm.RenderConfig(traversal="cluster", **cfg), tm.Camera(**view),
                                demand=mgr)
                r.render()
            usage = r.last_output.tex_usage.numpy()
            print(f"mip plane={tiles}x{tiles}tiles/{repeats}x {w}x{h} fault={fault} "
                  f"usage_bits_differing={int((usage != jusage).sum())}/{int(jusage.sum())} "
                  f"page_tables_equal={np.array_equal(mgr._page_table, jmgr._page_table)} "
                  f"sqrt_rmse={scenes.golden_rmse(r.accum_image(), want):.3g}", flush=True)


def window_readings():
    import chip_smoke as smoke
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.camera import Camera
    from optixpathtracer_tpu_torch.engine.renderer import Renderer
    from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
    from optixpathtracer_tpu_torch.lights.probe import build_probe

    tex = np.random.default_rng(smoke.DEMAND_SEED).random((smoke.DEMAND_BIG,) * 2 + (3,), dtype=np.float32)
    hs = smoke._plane_scene(tex)
    w, h = smoke.DEMAND_WINDOW
    cs = compile_scene(hs, CPU, leaf_size=8, cluster_size=256)
    probe = build_probe(np.full((8, 16, 3), 1.0, np.float32), CPU)
    cfg = RenderConfig(width=w, height=h, samples_per_launch=smoke.SPP, max_depth=smoke.DEPTH,
                       traversal="cluster", **smoke.BENCH_FLAGS)
    for view, window in (("view", {}), ("window", smoke._demand_window())):
        cam = Camera(**{**smoke.DEMAND_VIEW, **window}, aspect_ratio=w / h)
        sound = None
        for fault in FAULTS:
            with planted(fault):
                mgr = demand.DemandTextureManager.from_host_scene(hs, capacity=6144, levels=4, device=CPU)
                r = Renderer(cs, probe, cfg, cam, demand=mgr)
                r.render(download=False)
            got = (r.accum_image(), mgr._page_table.copy(),
                   sorted(set(mgr._page_lvl[mgr._page_table >= 0].tolist())))
            sound = sound or got
            print(f"{view} {w}x{h} fault={fault} levels={got[2]} "
                  f"page_tables_equal={np.array_equal(got[1], sound[1])} "
                  f"sqrt_rmse={scenes.golden_rmse(got[0], sound[0]):.3g}", flush=True)
            del r, mgr

if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    runs = dict(engine=engine_readings, mip=mip_readings, window=window_readings)
    for name in sys.argv[1:] or runs:
        runs[name]()
