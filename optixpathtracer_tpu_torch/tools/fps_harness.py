"""Per-frame fps harness reproducing the reference's measurement files
(port of tools/fps_harness.py).

The reference commits its benchmark evidence as raw per-frame dumps:
  - per-frame timing rows `i, stateUpdate, render, display, cursorX, cursorY`
    (HelloPathtracing_sv3/main.cpp:348-383 -> data_save.dat / cc.dat);
  - foveated-vs-uniform fps columns (HelloPathtracing_sv4_vmv23/
    final_fps.dat, written via sutil displayStats sutil.cpp:758-773).

This tool renders the same A/B on the card: foveated 3-zone (sv4 radii,
zone spp 1/2/8) against uniform 8 spp at the same resolution and depth,
while the gaze follows a circular trajectory (the reference's gaze is the
live mouse cursor, main.cpp:310-314), and writes both artifacts:

  OUT/fps_frames.tsv : i  mode  state_s  render_s  display_s  cursorX  cursorY  rays
  OUT/fps_summary.tsv: city_fov  city_uni   (per-frame fps columns)

Every render_s ends in a device synchronise; `rays` is the frame's traced
rays as the wavefront counts them on the device.

Run:  python -m optixpathtracer_tpu_torch.tools.fps_harness [--small]
          [--frames N] [--uni-frames N] [--uni-spp N] [--out DIR] [--cpu]
(OUT defaults to fps_harness/ in the temp directory.)
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import numpy as np
import torch

from .. import models, scenes
from ..core.math import Vec3
from ..engine.foveated import FoveationConfig
from . import city, device, sync

FRAMES_HEADER = "i\tmode\tstate_s\trender_s\tdisplay_s\tcursorX\tcursorY\trays"
SUMMARY_HEADER = "city_fov\tcity_uni"


def gaze_path(width: int, height: int, frames: int) -> list[tuple[int, int]]:
    """The circular gaze trajectory around the frame centre, one point a frame."""
    out = []
    for i in range(frames):
        ang = 2 * math.pi * i / max(frames, 1)
        out.append((int(width / 2 + 0.25 * width * math.cos(ang)),
                    int(height / 2 + 0.25 * height * math.sin(ang))))
    return out


def scaled_foveation(height: int) -> FoveationConfig:
    """The sv4 radii (157 / 515 at 2160 rows) scaled to a smaller frame so
    the zone grids do not overflow it (the smoke size's radii)."""
    return FoveationConfig(inner_radius=max(8, 157 * height // 2160),
                           outer_radius=max(24, 515 * height // 2160))


def harness(cs, probe, width, height, frames=10, uni_frames=3, uni_spp=8, foveation=None,
            dispatch_tiles=8, log=print) -> dict:
    """The foveated frames, then the uniform ones, on `cs`'s device. Returns
    {"rows": per-frame rows of fps_frames.tsv, "fov_fps", "uni_fps",
    "fov": the foveated renderer, "uni": the uniform one}."""
    dev = cs.device
    cam = scenes.city_camera(width, height)
    rows, fov_fps, uni_fps = [], [], []

    # ---- foveated: the gaze orbits the frame centre like a moving cursor ----
    fr = models.make_foveated_renderer(cs, probe, cam, width, height, max_depth=4,
                                       foveation=foveation)
    t_c = time.perf_counter()
    fr.render()  # warm-up
    log(f"foveated warm-up frame: {time.perf_counter() - t_c:.1f}s")
    fr.accum = Vec3.zeros((width * height,), dev)
    fr.subframe_index = 0
    for i, (gx, gy) in enumerate(gaze_path(width, height, frames)):
        t0 = time.perf_counter()
        fr.set_gaze(gx, gy)
        t1 = time.perf_counter()
        fr.render()
        sync(dev)
        t2 = time.perf_counter()
        _ = fr.frame()  # display / tone-map path (the reference's display split)
        t3 = time.perf_counter()
        rows.append((i, "fov", t1 - t0, t2 - t1, t3 - t2, gx, gy, fr.last_rays))
        fov_fps.append(1.0 / (t2 - t1))
        log(f"fov frame {i}: {t2 - t1:.2f}s gaze=({gx},{gy})")

    # ---- uniform: full-res uni_spp, same depth (final_fps.dat's *_uni) ----
    ur = models.make_disney_pt_renderer(cs, probe, cam, width, height, spp=uni_spp, max_depth=4,
                                        dispatch_tiles=dispatch_tiles)
    t_c = time.perf_counter()
    ur.render()  # warm-up
    log(f"uniform warm-up frame: {time.perf_counter() - t_c:.1f}s")
    for i in range(uni_frames):
        t1 = time.perf_counter()
        ur.render()
        sync(dev)
        t2 = time.perf_counter()
        rows.append((i, "uni", 0.0, t2 - t1, 0.0, width // 2, height // 2,
                     float(ur.last_output.rays_traced)))
        uni_fps.append(1.0 / (t2 - t1))
        log(f"uni frame {i}: {t2 - t1:.2f}s")
    return {"rows": rows, "fov_fps": fov_fps, "uni_fps": uni_fps, "fov": fr, "uni": ur}


def write_tsvs(out: str, rows, fov_fps, uni_fps) -> None:
    """fps_frames.tsv and fps_summary.tsv in `out`, the reference's columns."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "fps_frames.tsv"), "w") as f:
        f.write(FRAMES_HEADER + "\n")
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")
    with open(os.path.join(out, "fps_summary.tsv"), "w") as f:
        f.write(SUMMARY_HEADER + "\n")
        for i in range(max(len(fov_fps), len(uni_fps))):
            a = fov_fps[i] if i < len(fov_fps) else ""
            b = uni_fps[i] if i < len(uni_fps) else ""
            f.write(f"{a}\t{b}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="optixpathtracer_tpu_torch.tools.fps_harness")
    ap.add_argument("--small", action="store_true", help="320x240 smoke size")
    ap.add_argument("--frames", type=int, default=10, help="foveated frames")
    ap.add_argument("--uni-frames", type=int, default=3)
    ap.add_argument("--uni-spp", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "fps_harness"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    dev = device(args.cpu)
    w, h = (320, 240) if args.small else (1200, 800)
    cs, probe = city(dev, n_boxes=400 if args.small else 12500)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}", flush=True)
    print(f"scene compiled: {cs.num_triangles} tris", flush=True)
    # at smoke size the sv4 radii are scaled to the frame (the 4K
    # measurement uses them as they are)
    res = harness(cs, probe, w, h, args.frames, args.uni_frames, args.uni_spp,
                  foveation=scaled_foveation(h) if args.small else None,
                  dispatch_tiles=1 if args.small else 8,
                  log=lambda s: print(s, flush=True))
    write_tsvs(args.out, res["rows"], res["fov_fps"], res["uni_fps"])
    mf, mu = float(np.mean(res["fov_fps"])), float(np.mean(res["uni_fps"]))
    print(f"{w}x{h} depth 4, {cs.num_triangles} tris: "
          f"foveated {mf:.3f} fps | uniform {mu:.3f} fps | "
          f"speed-up {mf / mu:.1f}x (reference band 11-21x at 4K)")
    print(f"wrote {args.out}/fps_frames.tsv, fps_summary.tsv")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
