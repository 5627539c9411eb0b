"""The multi-device dry run (port of `__graft_entry__.dryrun_multichip`) and
the rank programs it and its callers run.

    python -m optixpathtracer_tpu_torch.parallel.dryrun --ranks N [--cpu]
        [--backend gloo|nccl] [--device cuda|cuda:K]

spawns N ranks (parallel/ranks.py) on the reference's tiny scene and runs,
one after another, the four sharding modes of the reference: strip data
parallelism (ray balance within 10 %), fused foveated lanes (ray balance
within 10 %), demand-loaded textures over the ranks (`pages_loaded` > 0),
and the sharded render against the single-device `Renderer` (rtol 2e-4,
atol 2e-5). Every mode renders with the cluster walk, so the first
mode's render is the one held against the single device. It prints the
reference's one-line summary, then one JSON line with the ranks' kernel
launches per mode, and exits non-zero if a gate or a rank fails.

Ranks render on `cuda:{rank}` unless `--cpu` or `--device cuda:K` (every
rank on card K: two gloo ranks can share one card; NCCL cannot) says
otherwise. The backend is gloo unless `--backend nccl` names NCCL; nothing
is switched silently.

`strip_program` and `foveated_program` are rank programs for
`ranks.run_ranks`: a scene (a `HostScene`, or a function of none that
builds one), a probe (an HDR image, or a function of the device), a
`RenderConfig` and a `Camera` in; per rank the gathered frame, the ray
counts, frame seconds and kernel launches out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..builder import compile_scene
from ..core.camera import Camera
from ..core.materials import make_material
from ..core.scene import HostScene, Mesh
from ..engine.foveated import FoveationConfig
from ..engine.renderer import Renderer
from ..engine.wavefront import RenderConfig
from ..io.demand import DemandTextureManager
from ..lights.probe import build_probe
from ..ops import traverse_cluster as tc
from . import ranks
from .foveated import DistributedFoveatedRenderer
from .tiles import DistributedRenderer

BALANCE_GATE = 0.10  # per-rank rays within 10 % of the mean
SINGLE_TOL = dict(rtol=2e-4, atol=2e-5)  # __graft_entry__.py:191


def tiny_scene() -> HostScene:
    """`__graft_entry__._tiny_setup`'s scene: a floor and two boxes."""
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2), roughness=0.4), pos=(0, 0.5, 0),
               extent=(0.5, 0.5, 0.5))
    hs.add_box(make_material(color=(0.9, 0.8, 0.2), metallic=1.0, roughness=0.2), pos=(1.2, 0.4, 0.5),
               extent=(0.4, 0.4, 0.4))
    return hs


TINY_PROBE = np.full((16, 32, 3), 0.5, np.float32)


def tiny_camera(width: int, height: int) -> Camera:
    return Camera(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45,
                  aspect_ratio=width / height)


def demand_scene() -> HostScene:
    """The dry run's demand scene: one 64x64 gradient texture on a plane."""
    hs = HostScene()
    tex = np.linspace(0, 1, 64 * 64 * 3, dtype=np.float32).reshape(64, 64, 3)
    tid = hs.add_texture(tex)
    hs.add_mesh(Mesh(
        vertices=np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, np.float32),
        texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        material=make_material(color=(1, 1, 1), texture_id=tid),
    ))
    return hs


def _setup(scene, probe, device, build: dict | None):
    hs = scene() if callable(scene) else scene
    cs = compile_scene(hs, device, **(build or {}))
    pr = probe(device) if callable(probe) else build_probe(probe, device)
    return hs, cs, pr


def imported_foreign() -> list[str]:
    """Modules of jax, the JAX package or PIL this process has imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "optixpathtracer_tpu", "PIL"))


def strip_program(rank, world, device, scene, probe, cfg: RenderConfig, camera: Camera,
                  frames: int = 1, demand: dict | None = None, build: dict | None = None,
                  single: bool = False) -> dict:
    """Strip data parallelism on this rank: `frames` frames of a
    `DistributedRenderer` (with `demand` = {capacity, levels}: from a
    demand pool of its own), then the gathered frame. With `single` rank 0
    also renders the frame on one device (`Renderer`, the same frames) and
    returns it. Launch counts cover the distributed frames only."""
    hs, cs, pr = _setup(scene, probe, device, build)
    mgr = (DemandTextureManager.from_host_scene(hs, device=device, **demand)
           if demand is not None else None)
    r = DistributedRenderer(cs, pr, cfg, camera, demand=mgr)
    tc.launch_counts.clear()
    launches = []
    for _ in range(frames):
        r.render()
        launches.append(r.last_launches)
    counts = dict(tc.launch_counts)
    out = dict(rank=rank, device=str(device), image=r.accum_image(), rays=r.last_rays,
               rays_per_device=r.last_rays_per_device, frame_s=list(r._frame_times),
               gather_ms=r.last_gather_ms, launch_counts=counts, launches=launches,
               pages_loaded=None if mgr is None else mgr.pages_loaded,
               page_table=None if mgr is None else mgr._page_table.copy(),
               imported=imported_foreign())
    if single and rank == 0:
        smgr = (DemandTextureManager.from_host_scene(hs, device=device, **demand)
                if demand is not None else None)
        s = Renderer(cs, pr, cfg, camera, demand=smgr)
        for _ in range(frames):
            s.render(download=False)
        out.update(single_image=s.accum_image(), single_rays=float(s.last_output.rays_traced),
                   single_frame_s=list(s._frame_times),
                   single_pages_loaded=None if smgr is None else smgr.pages_loaded)
    return out


def foveated_program(rank, world, device, scene, probe, cfg: RenderConfig, camera: Camera,
                     foveation: FoveationConfig, gazes, build: dict | None = None) -> dict:
    """Fused foveated lanes on this rank: one frame of a
    `DistributedFoveatedRenderer` per gaze of `gazes` (image coordinates),
    the accumulation after each, rays and launch counts."""
    _, cs, pr = _setup(scene, probe, device, build)
    r = DistributedFoveatedRenderer(cs, pr, cfg, camera, foveation)
    tc.launch_counts.clear()
    images, rays, rays_dev = [], [], []
    for gx, gy in gazes:
        r.set_gaze(gx, gy)
        r.render()
        images.append(r.accum_image())
        rays.append(r.last_rays)
        rays_dev.append(r.last_rays_per_device)
    return dict(rank=rank, device=str(device), images=images, rays=rays, rays_per_device=rays_dev,
                frame_s=list(r._frame_times), launch_counts=dict(tc.launch_counts),
                imported=imported_foreign())


def imbalance(rays_per_device) -> float:
    d = np.asarray(rays_per_device, np.float64)
    return float(np.abs(d / d.mean() - 1.0).max())


def dryrun_program(rank, world, device) -> dict:
    """The dry run's four modes on this rank (`__graft_entry__.py:61-200`)."""
    # height 8*world: the interleaved strips hand each rank several rows
    # spread over the frame's sky-to-geometry gradient
    width = height = 8 * world
    cfg = RenderConfig(width=width, height=height, samples_per_launch=1, max_depth=2,
                       traversal="cluster")
    cam = tiny_camera(width, height)
    strips = strip_program(rank, world, device, tiny_scene, TINY_PROBE, cfg, cam, single=True)
    fov = foveated_program(rank, world, device, tiny_scene, TINY_PROBE, cfg, cam,
                           FoveationConfig(inner_radius=4, outer_radius=10),
                           [(width // 2, height // 2)])
    demand = strip_program(rank, world, device, demand_scene, TINY_PROBE, cfg, cam,
                           demand=dict(capacity=8))
    return dict(strips=strips, foveated=fov, demand=demand)


def check_dryrun(results: list[dict]) -> str:
    """The reference's gates on the ranks' results; returns its summary line."""
    n = len(results)
    strips = results[0]["strips"]
    img = strips["image"]
    assert img.shape == (8 * n, 8 * n, 3) and np.all(np.isfinite(img))
    strip_imb = imbalance(strips["rays_per_device"])
    assert strip_imb <= BALANCE_GATE, (
        f"strip DP ray imbalance {strip_imb:.3f} > 10%: {strips['rays_per_device']}")
    fov = results[0]["foveated"]
    assert np.all(np.isfinite(fov["images"][-1]))
    fov_imb = imbalance(fov["rays_per_device"][-1])
    assert fov_imb <= BALANCE_GATE, (
        f"foveated lane-shard ray imbalance {fov_imb:.3f} > 10%: {fov['rays_per_device'][-1]}")
    demand = results[0]["demand"]
    assert np.all(np.isfinite(demand["image"])) and demand["pages_loaded"] > 0
    for res in results[1:]:  # every rank gathered the same frame and paged alike
        np.testing.assert_array_equal(res["strips"]["image"], img)
        assert res["demand"]["pages_loaded"] == demand["pages_loaded"]
    np.testing.assert_allclose(img, strips["single_image"], **SINGLE_TOL)
    for res in results:  # CPU ranks take the kernels' plain versions, which count nothing
        for mode in ("strips", "foveated", "demand"):
            if res[mode]["device"].startswith("cuda"):
                assert res[mode]["launch_counts"].get("cull", 0) > 0, (
                    f"rank {res[mode]['rank']} {mode}: no kernel launched")
    return (f"dryrun_multichip({n}): ok, rays={strips['rays']:.0f}, "
            f"foveated_rays={fov['rays'][-1]:.0f}, demand_pages={demand['pages_loaded']}, "
            f"cluster_rays={strips['rays']:.0f} (sharded cluster == single-device), "
            f"ray balance: strip +-{strip_imb * 100:.1f}%, "
            f"foveated lanes +-{fov_imb * 100:.1f}% (gate 10%)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m optixpathtracer_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True, help="ranks (processes) to spawn")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU (gloo only)")
    ap.add_argument("--backend", choices=ranks.BACKENDS, default="gloo")
    ap.add_argument("--device", default="cuda",
                    help="cuda: rank r on cuda:r; cuda:K: every rank on card K")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds the ranks may take")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --cpu to run the ranks on the CPU", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = ranks.run_ranks(dryrun_program, args.ranks, args.backend, device,
                                  os.path.join(tmp, "rendezvous"), timeout_s=args.timeout)
    print(check_dryrun(results))
    launches = [{mode: res[mode]["launch_counts"] for mode in ("strips", "foveated", "demand")}
                for res in results]
    print(json.dumps({"ranks": args.ranks, "backend": args.backend, "device": device,
                      "seconds": time.perf_counter() - t0, "launches_per_rank": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
