#!/usr/bin/env python3
"""Measure the port's two route rules on the card: which foveated frames
render faster in one fused launch than in three, and whether the node walk
beats the flat walk at every scene size.

    python3 route_thresholds.py [--only fused|route] [--out FILE]

Run from the root of the repository, beside `chip_smoke.py`, whose
first-bounce wavefront, route toggle and frame timers it reuses. It prints
one JSON line per measurement, the card's name and power limit on each, and
with --out writes them to FILE too.

- `fused`: the sv4 preset on the city at 640x480, 1280x720, 1920x1080 and
  3840x2160 (radii 157/515 scaled by height / 2160 and rounded down, the
  fovea at 4 spp at 640x480 as `chip_smoke.py` drives it), rendered fused,
  three launches, three launches, fused: 1 warm-up and 5 timed frames per
  turn, with the frame seconds and `torch.cuda.max_memory_allocated`.
- `route`: `disney_pt` at 1200x800, 2 spp, depth 4 on every scene of
  ROUTE_SCENES (the golden scenes' open scene, the city at 1250, 3125,
  6250 and its 12500 boxes, `build_big_scene` at four terrain grids),
  through the node walk, the flat walk, flat, node (`chip_smoke.route_turns`:
  1 warm-up and 3 timed frames per turn); then both walks' entry points on
  the slice's first bounce (CUDA events, mean of 3 after a warm-up).

It fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke

FOV_SIZES = ((640, 480), (1280, 720), (1920, 1080), (3840, 2160))
FUSED_TURNS = (True, False, False, True)
# name -> (scene builder, camera): from the golden scenes' open scene (one
# entry) to the 8.68M-triangle terrain apron (4239 entries)
ROUTE_SCENES = {
    "open": ("open_scene", {}, "open_camera"),
    **{f"city {n} boxes": ("build_city_scene", dict(n_boxes=n), "city_camera") for n in (1250, 3125, 6250)},
    "city": ("build_city_scene", {}, "city_camera"),
    **{f"big {gx}x{gz}": ("build_big_scene", dict(terrain_grid=(gx, gz)), "city_camera")
       for gx, gz in ((1024, 512), (1024, 1024), (2048, 1024), (2048, 2048))},
}


def foveation_at(width: int, height: int):
    """The sv4 radii scaled to the frame's height, as chip_smoke.py scales
    them at 640x480; the fovea at 4 spp there, the preset's 8 elsewhere."""
    from optixpathtracer_tpu_torch.engine.foveated import FoveationConfig

    if height == 2160:
        return FoveationConfig()
    return FoveationConfig(inner_radius=max(8, 157 * height // 2160),
                           outer_radius=max(24, 515 * height // 2160),
                           fovea_spp=4 if height == 480 else 8)


def main() -> int:
    if not torch.cuda.is_available():
        print("route_thresholds: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer, make_foveated_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("fused", "route"), help="measure one rule only")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []

    def emit(kind, **fields):
        lines.append(json.dumps({"kind": kind, **fields, "card": card}))
        print(lines[-1], flush=True)

    flags = chip_smoke.BENCH_FLAGS
    probe = scenes.city_sky(dev)

    # ---- (a) the fused rule ------------------------------------------------
    if args.only in (None, "fused"):
        city = compile_scene(scenes.build_city_scene(), dev, leaf_size=8, cluster_size=256)
        for w, h in FOV_SIZES:
            fov = foveation_at(w, h)
            turns = []
            for fused in FUSED_TURNS:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                r = make_foveated_renderer(city, probe, scenes.city_camera(w, h), width=w, height=h,
                                           foveation=fov, fused=fused, **flags)
                times = chip_smoke.time_frames(r, 5)
                turns.append(dict(fused=fused, frame_s=float(np.median(times)), frame_times_s=times,
                                  rays=int(r.last_rays),
                                  max_memory_allocated=torch.cuda.max_memory_allocated()))
                del r
            med = {k: float(np.median([t["frame_s"] for t in turns if t["fused"] == k])) for k in (True, False)}
            emit("fused", width=w, height=h, pixels=w * h, foveation=dataclasses.asdict(fov), turns=turns,
                 fused_s=med[True], three_s=med[False], fused_wins=med[True] < med[False])
        del city
        torch.cuda.empty_cache()

    # ---- (b) the node walk against the flat walk ----------------------------
    if args.only in (None, "route"):
        w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
        for name, (build, kw, camera) in ROUTE_SCENES.items():
            t0 = time.perf_counter()
            cs = compile_scene(getattr(scenes, build)(**kw), dev, leaf_size=8, cluster_size=256)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            cl = cs.clusters
            r = make_disney_pt_renderer(cs, probe, getattr(scenes, camera)(w, h), width=w, height=h,
                                        spp=chip_smoke.SPP, max_depth=chip_smoke.DEPTH, **flags)
            routes = chip_smoke.route_turns(r, tc.launch_counts)
            cfg = r.config
            (o1, d1), (p_hit, wi, t_sh), _ = chip_smoke.first_bounce_and_shadows(r, cl, probe, dev)
            entry = {}
            for route, hier in (("node", True), ("flat", False)):
                entry[f"closest_{route}_ms"] = chip_smoke.cuda_ms(
                    lambda: tc.closest_hit_cluster(cl, o1, d1, cfg.t_min, cfg.t_max, hier=hier), reps=3)
                entry[f"any_{route}_ms"] = chip_smoke.cuda_ms(
                    lambda: tc.any_hit_cluster(cl, p_hit, wi, cfg.shadow_t_min, t_sh, hier=hier), reps=3)
            emit("route", scene=name, triangles=cs.num_triangles, entries=cl.num_entries,
                 nodes=cl.node_tables.csph.shape[0], build_s=build_s, **routes,
                 first_bounce_entry_points=entry)
            del cs, cl, r, o1, d1, p_hit, wi, t_sh
            torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
