"""Command line: `python -m optixpathtracer_tpu_torch render | view ...`
(port of optixpathtracer_tpu/cli.py).

The flags are the reference's (`utils/config.py`) plus `--device`: the
render runs on the card unless `--device cpu` is given, and does not fall
back. `--traversal lockstep | bfs | cluster | dense` picks the backend;
without the flag it is the cluster walk on a CUDA device and the config's
default, the lockstep walk, on a CPU (the reference's platform rule); a
TLAS scene (`--instanced`) always takes the cluster walk. `render`
covers every model: `disney_pt` (progressive, `--checkpoint`, `--denoise`,
`--metrics`, `--demand-textures N`: textures from a demand-loaded pool of
N tiles with 4 mip levels), `foveated` (`--gaze`), `hello_raytracing`,
`whitted` (its own spheres scene; `--scene` is ignored, as in the
reference) and `spectral`, and `--adaptive`, on OBJ, glTF (`--instanced`:
the multi-prototype TLAS) and the procedural boxes. `view` serves the
progressive `disney_pt` (or `foveated`) renderer to a browser
(`--port 0` picks a free port, `--max-frames` bounds the loop). `bench
[--small] [--cpu]` runs the port's benchmark (`optixpathtracer_tpu_torch.bench`,
on the card unless `--cpu`) and returns its exit code.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .utils.config import RunConfig, add_config_args, config_from_args


def _load_scene(cfg: RunConfig):
    """(HostScene, lights, tlas): tlas is (groups, instances) for an
    `--instanced` glTF with mesh nodes, else None."""
    from .core.materials import make_material
    from .core.scene import HostScene
    from .io.gltf import load_gltf, load_gltf_tlas
    from .io.obj import load_obj

    lights = None
    tlas = None
    if cfg.scene.lower().endswith((".gltf", ".glb")):
        if cfg.instanced:
            hs, groups, instances, lights = load_gltf_tlas(cfg.scene)
            if instances:
                tlas = (groups, instances)
            else:
                print("warning: --instanced: scene has no mesh nodes; "
                      "falling back to baked load", file=sys.stderr)
                hs, lights = load_gltf(cfg.scene)
        else:
            hs, lights = load_gltf(cfg.scene)
    elif cfg.instanced and cfg.scene:
        print("warning: --instanced applies to glTF scenes only; ignored", file=sys.stderr)
        hs = load_obj(cfg.scene)
    elif cfg.scene:
        hs = load_obj(cfg.scene)
    else:
        # procedural default: boxes on a floor (HelloPathtracing_original/main.cpp:165-169)
        hs = HostScene()
        hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
        hs.add_box(make_material(color=(0.8, 0.3, 0.2), roughness=0.5), pos=(-0.9, 0.5, 0),
                   extent=(0.5, 0.5, 0.5))
        hs.add_box(make_material(color=(0.9, 0.8, 0.3), metallic=1.0, roughness=0.15),
                   pos=(0.8, 0.65, 0.4), extent=(0.45, 0.65, 0.45))
    return hs, lights, tlas


def _load_probe(cfg: RunConfig, device):
    from .lights.probe import build_probe

    if cfg.probe:
        from .io.image import load_hdr

        return build_probe(load_hdr(cfg.probe), device)
    return build_probe(np.full((32, 64, 3), cfg.probe_level, np.float32), device)


def pick_traversal(cfg: RunConfig, traversal_flag: str | None, device) -> None:
    """The reference CLI's rule (optixpathtracer_tpu/cli.py:80-85): without
    `--traversal`, the cluster walk on the accelerator (here a CUDA device);
    otherwise `cfg.traversal` (the flag, or the lockstep default)."""
    if traversal_flag is None and torch.device(device).type == "cuda":
        cfg.traversal = "cluster"


def compile_run_scene(cfg: RunConfig, device):
    """Load and compile the run's scene on `device` as the reference CLI
    does: (CompiledScene, HostScene, tlas or None). A TLAS is a cluster
    structure, so it sets `cfg.traversal` to "cluster"."""
    from .builder import compile_scene, compile_tlas

    hs, _lights, tlas = _load_scene(cfg)
    if tlas is not None:
        groups, instances = tlas
        cs = compile_tlas(hs, groups, instances, device)
        cfg.traversal = "cluster"
        print(f"TLAS: {len(groups)} prototype BLAS(es), {len(instances)} instances, "
              f"{cs.num_triangles} world triangles ({cs.clusters.rows.shape[0]} stored superclusters)")
    else:
        # the wide BVH only where its walks run (the reference CLI builds it
        # always; on the 8.7M-triangle scene it is seconds and ~0.3 GB)
        cs = compile_scene(hs, device, leaf_size=8,
                           build_wide_bvh=cfg.traversal in ("bfs", "dense"))
    return cs, hs, tlas


def make_camera(cfg: RunConfig):
    from .core.camera import Camera

    return Camera(eye=cfg.camera.eye, lookat=cfg.camera.lookat, up=cfg.camera.up,
                  fov_y=cfg.camera.fov_y, aspect_ratio=cfg.width / cfg.height)


def make_renderer(cfg: RunConfig, cs, probe, camera, demand=None):
    """The renderer `render` drives for cfg: foveated, adaptive or
    disney_pt, with the reference CLI's flags (disney_pt splits a launch
    on the bfs, cluster and dense backends into max(1, w*h // 131072)
    sequential pixel chunks, and shades from the `demand` texture pool
    where one is given)."""
    from . import models

    engine = dict(traversal=cfg.traversal, emission_all_bounces=cfg.emission_all_bounces,
                  nee_final_bounce=cfg.nee_final_bounce, nee_rr=cfg.nee_rr,
                  russian_roulette=cfg.russian_roulette, rr_start_depth=cfg.rr_start_depth,
                  sampling=cfg.sampling, sampling_strata=cfg.sampling_strata)
    if cfg.model == "foveated":
        r = models.make_foveated_renderer(cs, probe, camera, cfg.width, cfg.height, cfg.max_depth,
                                          foveation=cfg.foveation, fused=cfg.fused_foveation,
                                          **engine)
        gx, gy = cfg.gaze
        if gx >= 0:
            r.set_gaze(gx, gy)
        return r
    if cfg.adaptive:
        return models.make_adaptive_renderer(cs, probe, camera, cfg.width, cfg.height, cfg.spp,
                                             cfg.max_depth, refine_fraction=cfg.adaptive_fraction,
                                             **engine)
    tiles = (max(1, (cfg.width * cfg.height) // 131072)
             if cfg.traversal in ("bfs", "cluster", "dense") else 1)
    return models.make_disney_pt_renderer(cs, probe, camera, cfg.width, cfg.height, cfg.spp,
                                          cfg.max_depth, dispatch_tiles=tiles, demand=demand,
                                          **engine)


def make_demand(cfg: RunConfig, hs, device, levels: int):
    """The demand-loaded texture pool of `--demand-textures N` (N tiles on
    `device`), or None where the flag is off or the scene has no texture."""
    if cfg.demand_textures <= 0 or not hs.textures:
        return None
    from .io.demand import DemandTextureManager

    return DemandTextureManager.from_host_scene(hs, capacity=cfg.demand_textures, levels=levels,
                                                device=device)


def _save_tonemapped(cfg: RunConfig, img: np.ndarray | torch.Tensor) -> None:
    """Tone-map an (H, W, 3) linear image with cfg's mode and exposure and
    write it as PNG."""
    from .core.math import Vec3
    from .io.image import save_png
    from .ops import tonemap as tm

    t = torch.as_tensor(np.asarray(img, np.float32)) if not isinstance(img, torch.Tensor) else img
    disp = tm.finalize(Vec3(t[..., 0], t[..., 1], t[..., 2]), mode=cfg.tonemap,
                       exposure_stops=cfg.exposure)
    save_png(cfg.out, np.stack([c.cpu().numpy() for c in disp], -1))


def cmd_render(args: argparse.Namespace) -> int:
    from .utils.logging import FrameLog, Timer

    cfg = config_from_args(args)
    device = torch.device(args.device)
    torch.empty(0, device=device)  # the device error, before any work
    pick_traversal(cfg, getattr(args, "traversal", None), device)
    camera = make_camera(cfg)
    log = FrameLog(cfg.metrics or None)
    timer = Timer()

    cs, hs, _tlas = compile_run_scene(cfg, device)
    probe = _load_probe(cfg, device)
    state_update = timer.lap()
    print(f"scene: {cs.num_triangles} triangles (compiled in {state_update:.1f}s)")

    if cfg.demand_textures > 0 and cfg.model != "disney_pt":
        print(f"warning: --demand-textures applies to the disney_pt model only; "
              f"ignored for --model {cfg.model}", file=sys.stderr)
    elif cfg.demand_textures > 0 and not hs.textures:
        print("warning: scene has no textures; --demand-textures ignored", file=sys.stderr)

    if cfg.model in ("hello_raytracing", "whitted", "spectral"):
        return _render_preset(cfg, cs, probe, camera, device, log, timer, state_update)

    demand = None
    if cfg.model == "disney_pt" and not cfg.adaptive:  # the reference's adaptive ignores the pool
        # levels=4: a per-hit mip LOD from the path-length footprint and the
        # triangle's texel density, sampled trilinearly
        demand = make_demand(cfg, hs, device, levels=4)
        if demand is not None:
            print(f"demand textures: {demand.num_pages} pages, pool capacity {cfg.demand_textures}")
    r = make_renderer(cfg, cs, probe, camera, demand=demand)

    if cfg.model == "foveated":
        from .io.image import save_png

        for _ in range(cfg.frames):
            frame = r.render()
            log.log_frame(render_s=timer.lap(), cursor=r.gaze, rays=r.last_rays)
        save_png(cfg.out, frame)
        print(f"wrote {cfg.out} ({r.stats()})")
        return 0

    if cfg.adaptive:
        for _ in range(cfg.frames):
            r.render()
            st = r.stats()
            log.log_frame(render_s=timer.lap(), rays=st["rays_traced"], spp=st["spp_max"])
        st = r.stats()
        print(f"adaptive: {st['rounds']} rounds, {st['total_samples']} samples (per-pixel spp "
              f"{st['spp_min']}..{st['spp_max']}), {st['rays_traced']:.0f} rays")
        _save_tonemapped(cfg, r.accum_image())
        print(f"wrote {cfg.out}")
        log.close()
        return 0

    if cfg.checkpoint:
        ckpt = cfg.checkpoint if cfg.checkpoint.endswith(".npz") else cfg.checkpoint + ".npz"
        if os.path.exists(ckpt):
            r.load_checkpoint(cfg.checkpoint)
            print(f"resumed at subframe {r.subframe_index}")
    for _ in range(cfg.frames):
        frame = r.render()
        st = r.stats()
        log.log_frame(render_s=st["last_frame_s"], spp=st["total_spp"],
                      rays=float(r.last_output.rays_traced))
        print(f"\r{log.display_stats()} | {st['total_spp']} spp", end="", flush=True)
    print()
    if cfg.checkpoint:
        r.save_checkpoint(cfg.checkpoint)
        print(f"checkpoint saved to {cfg.checkpoint}")
    if cfg.denoise:
        from .ops.denoise import atrous_denoise

        aov = r.aovs()
        den = atrous_denoise(*(torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                               for a in (r.accum_image(), aov["normal"], aov["albedo"])))
        _save_tonemapped(cfg, den)
    else:
        from .io.image import save_png

        save_png(cfg.out, frame)
    print(f"wrote {cfg.out}")
    log.close()
    return 0


def _render_preset(cfg: RunConfig, cs, probe, camera, device, log, timer, state_update) -> int:
    """`render --model hello_raytracing | whitted | spectral`, as the
    reference CLI renders them (optixpathtracer_tpu/cli.py:119-154)."""
    from . import models
    from .io.image import save_png

    if cfg.model == "hello_raytracing":
        r = models.make_hello_renderer(cs, camera, cfg.width, cfg.height)
        img = r.render()
        save_png(cfg.out, img)
        log.log_frame(state_update_s=state_update, render_s=timer.lap())
        print(f"wrote {cfg.out}")
        return 0
    if cfg.model == "whitted":
        r = models.make_whitted_renderer(cfg.width, cfg.height, cfg.max_depth, device=device)
        for _ in range(cfg.frames):
            img = r.render()
            log.log_frame(render_s=timer.lap())
        save_png(cfg.out, img)
        print(f"wrote {cfg.out}")
        return 0
    r = models.make_spectral_renderer(cs, probe, camera, cfg.width, cfg.height, cfg.spp,
                                      cfg.max_depth, traversal=cfg.traversal,
                                      emission_all_bounces=cfg.emission_all_bounces,
                                      sampling=cfg.sampling, sampling_strata=cfg.sampling_strata)
    for _ in range(cfg.frames):
        r.render(download=False)
        log.log_frame(render_s=timer.lap())
    _save_tonemapped(cfg, r.image_tensor())
    print(f"wrote {cfg.out}")
    return 0


def cmd_view(args: argparse.Namespace) -> int:
    """Interactive viewer: the progressive render streamed to a browser
    (the reference's `view`): foveated with the config's flags, else
    disney_pt, shading from a one-level demand pool with
    `--demand-textures`. The traversal follows `render`'s rule (the
    reference's `view` keeps the config's lockstep default on every
    platform unless given the flag)."""
    from . import models
    from .viewer.server import run_interactive

    cfg = config_from_args(args)
    device = torch.device(args.device)
    torch.empty(0, device=device)  # the device error, before any work
    pick_traversal(cfg, getattr(args, "traversal", None), device)
    camera = make_camera(cfg)
    cs, hs, _tlas = compile_run_scene(cfg, device)
    probe = _load_probe(cfg, device)
    if cfg.model == "foveated":
        r = make_renderer(cfg, cs, probe, camera)
    else:
        r = models.make_disney_pt_renderer(cs, probe, camera, cfg.width, cfg.height, cfg.spp,
                                           cfg.max_depth, demand=make_demand(cfg, hs, device, 1),
                                           traversal=cfg.traversal, sampling=cfg.sampling,
                                           sampling_strata=cfg.sampling_strata)
    run_interactive(r, camera, port=args.port, max_frames=args.max_frames)
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from . import bench

    return bench.main(["--small"] * args.small + ["--cpu"] * args.cpu)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="optixpathtracer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="render a scene with a model preset")
    add_config_args(p_render)
    p_render.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace (Chrome trace JSON) of the whole render into DIR")
    p_render.set_defaults(fn=cmd_render)

    p_view = sub.add_parser("view", help="interactive browser viewer")
    add_config_args(p_view)
    p_view.add_argument("--port", type=int, default=8000)
    p_view.add_argument("--max-frames", type=int, default=None, dest="max_frames")
    p_view.set_defaults(fn=cmd_view)

    p_bench = sub.add_parser("bench", help="run the throughput benchmark")
    p_bench.add_argument("--small", action="store_true")
    p_bench.add_argument("--cpu", action="store_true", help="run on the CPU (no CUDA device)")
    p_bench.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    if getattr(args, "profile", None):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            rc = args.fn(args)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")
        return rc
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
