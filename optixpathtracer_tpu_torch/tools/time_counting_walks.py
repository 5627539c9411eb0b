"""Time the counting walks behind chip_smoke.py's `kernel_bound` lines on one
card: `traverse_cluster.sweep_work_hier` (K4a, K4b) and `sweep_work` (K2,
K3) on the city slice's first-bounce wavefront and its NEE shadow rays, as
chip_smoke.py builds them. Each call is timed on the host clock from a
synchronised start to its counts read back, `--reps` times.

Run from the repository root (it uses chip_smoke.py's city set-up):

    python3 -m optixpathtracer_tpu_torch.tools.time_counting_walks --reps 2

It prints one JSON line: the card, the package timed, each walk's seconds
and counts. To compare two trees of the package on one card, run this
file with each tree first on PYTHONPATH, in turns (A, B, B, A)."""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_counting_walks: no card (torch.cuda.is_available() is false)")
    import chip_smoke as smoke
    import optixpathtracer_tpu_torch
    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    dev = torch.device("cuda")
    cs = compile_scene(scenes.build_city_scene(), dev, **smoke.CITY_BUILD)
    probe = scenes.city_sky(dev)
    renderer = make_disney_pt_renderer(cs, probe, scenes.city_camera(smoke.WIDTH, smoke.HEIGHT), width=smoke.WIDTH,
                                       height=smoke.HEIGHT, spp=smoke.SPP, max_depth=smoke.DEPTH, **smoke.BENCH_FLAGS)
    cfg, cl = renderer.config, cs.clusters
    c = cl.cluster_size
    (o, d), (p, wi, t_sh), _ = smoke.first_bounce_and_shadows(renderer, cl, probe, dev)
    primary, shadow = (o, d, cfg.t_min, cfg.t_max), (p, wi, cfg.shadow_t_min, t_sh)
    node_c, node_s = tc.block_cull_nodes(cl, *primary), tc.block_cull_nodes(cl, *shadow)
    flat_c, flat_s = tc.block_cull(cl, *primary), tc.block_cull(cl, *shadow)
    walks = {
        "sweep_work_hier closest": lambda: tc.sweep_work_hier(cl.rows, cl.xf_inv, cl.node_tables, node_c, c),
        "sweep_work_hier any": lambda: tc.sweep_work_hier(cl.rows, cl.xf_inv, cl.node_tables, node_s, c,
                                                          any_hit=True),
        "sweep_work closest": lambda: tc.sweep_work(cl.rows, cl.xf_inv, flat_c, c),
        "sweep_work any": lambda: tc.sweep_work(cl.rows, cl.xf_inv, flat_s, c, any_hit=True),
    }
    out = {}
    for name, walk in walks.items():
        seconds = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = walk()
            seconds.append(time.perf_counter() - t0)
        out[name] = {"seconds": seconds, "work": work._asdict()}
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "package": os.path.dirname(os.path.abspath(optixpathtracer_tpu_torch.__file__)), "walks": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
