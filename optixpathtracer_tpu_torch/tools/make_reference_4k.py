"""References for the 3840x2160 foveated quality track (port of
tools/make_reference_4k.py; the reference's own published configuration,
final_fps.dat / sv4 main.cpp:256).

Two artifacts, both of the bench city under the 16:9 camera, under the
reference's names and keys:

  ref_city_4k_fovea.npz
      the fovea disc (r <= disc_r around the frame centre, the sv4 inner
      radius 157 by default) rendered to convergence (default 2048 spp,
      Owen-scrambled Sobol: unbiased, the same estimator mean as every
      benched row). Stores (idx, image rows) in flat bottom-first pixel
      order, its pixels traced in 16x8 tile order.
  ref_city_4k_q.npz
      the full-frame companion at quarter resolution (960x540): the 4K
      frame's 4x4 box downsample, rendered at --q-spp (default 256)
      full-res spp, an effective 16 x 256 = 4096 samples per stored pixel.

It writes to --out-dir (default make_reference_4k/ in the temp directory),
never to scenes/: the committed scenes/ref_city_4k_*.npz stay the
references. On the card it renders through the cluster walk with the ray
sort, with --cpu through the lockstep walk, as the reference does on a CPU.

Run:  python -m optixpathtracer_tpu_torch.tools.make_reference_4k
          [--disc-spp N] [--disc-r R] [--q-spp N] [--spp-per-launch N]
          [--skip-fovea] [--skip-q] [--out-dir DIR] [--cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from .. import scenes
from ..core.math import Vec3
from ..engine.renderer import Renderer
from ..engine.wavefront import CameraParams, RenderConfig, trace_wavefront
from . import city, device, sync

W4K, H4K = 3840, 2160
Q = 4  # the companion's box downsample factor


def city_setup(dev, w: int = W4K, h: int = H4K, n_boxes: int = 12500):
    """(compiled city, sky probe, the camera at w / h)."""
    cs, probe = city(dev, n_boxes)
    return cs, probe, scenes.city_camera(w, h)


def disc_pixels(w: int, h: int, cx: int, cy: int, r: int):
    """Fovea-disc pixels in 16x8 tile order (camera-ray block coherence)."""
    ys, xs = np.mgrid[0:h, 0:w]
    keep = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
    px, py = xs[keep].astype(np.int32), ys[keep].astype(np.int32)
    order = np.lexsort([
        px % 16 + 16 * (py % 8),
        px // 16 + (py // 8) * ((w + 15) // 16),
    ])
    return px[order], py[order]


def box_downsample(full: np.ndarray, f: int = Q) -> np.ndarray:
    """(H, W, C) -> (H/f, W/f, C): the mean of each f x f box."""
    h, w, c = full.shape
    return full.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))


def reference_config(dev, w: int, h: int, spp_per_launch: int) -> RenderConfig:
    on_cpu = dev.type == "cpu"
    return RenderConfig(
        width=w, height=h, samples_per_launch=spp_per_launch,
        max_depth=4, traversal="lockstep" if on_cpu else "cluster",
        sort_rays=not on_cpu, nee_final_bounce=False, batch_spp=True,
        sampling="sobol",
    )


def fovea_disc(cs, probe, cam, cfg: RenderConfig, disc_spp: int, disc_r: int, log=print):
    """The disc around the frame centre at `disc_spp`: (px, py, image (n, 3))."""
    cx, cy = cfg.width // 2, cfg.height // 2  # buffer coords, bottom-first y
    px, py = disc_pixels(cfg.width, cfg.height, cx, cy, disc_r)
    n = len(px)
    log(f"fovea disc: {n} pixels, {disc_spp} spp")
    dev = cs.device
    pxt, pyt = torch.as_tensor(px, device=dev), torch.as_tensor(py, device=dev)
    camp = CameraParams.from_camera(cam, dev)
    acc = Vec3.zeros((n,), dev)
    spl = cfg.samples_per_launch
    t0 = time.perf_counter()
    for i in range(disc_spp // spl):
        out = trace_wavefront(cs, probe, cfg, camp, pxt, pyt, i)
        acc = acc + out.color
        if (i + 1) % 128 == 0:
            float(out.rays_traced)
            dt = time.perf_counter() - t0
            done = (i + 1) * spl
            log(f"  {done} spp, {dt:.0f}s (ETA {dt / done * (disc_spp - done):.0f}s)")
    img = np.stack([c.cpu().numpy() for c in acc], -1) / disc_spp
    return px, py, img


def save_fovea(path, px, py, img, w, h, disc_spp, disc_r) -> None:
    np.savez_compressed(
        path, idx=(py.astype(np.int64) * w + px).astype(np.int64),
        image=img.astype(np.float16), width=w, height=h,
        spp=disc_spp, gaze=(w // 2, h // 2), disc_r=disc_r,
        sampling="sobol", max_depth=4, scene="city_12500_seed0")


def companion(cs, probe, cam, cfg: RenderConfig, q_spp: int, log=print) -> np.ndarray:
    """The full frame at `q_spp`, box-downsampled by Q: (H/Q, W/Q, 3), rows
    bottom first."""
    qcfg = dataclasses.replace(cfg, dispatch_tiles=1 if cs.device.type == "cpu" else 16)
    r = Renderer(cs, probe, qcfg, cam)
    t0 = time.perf_counter()
    n_l = q_spp // qcfg.samples_per_launch
    for i in range(n_l):
        r.render(download=False)
        if (i + 1) % 16 == 0:
            float(r.last_output.rays_traced)
            dt = time.perf_counter() - t0
            done = (i + 1) * qcfg.samples_per_launch
            log(f"  {done} spp, {dt:.0f}s (ETA {dt / done * (q_spp - done):.0f}s)")
    accum = np.stack([c.cpu().numpy() for c in r.accum], -1)[r._inv_perm]
    return box_downsample(accum.reshape(cfg.height, cfg.width, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="optixpathtracer_tpu_torch.tools.make_reference_4k")
    ap.add_argument("--disc-spp", type=int, default=2048)
    ap.add_argument("--disc-r", type=int, default=157)
    ap.add_argument("--q-spp", type=int, default=256)
    ap.add_argument("--spp-per-launch", type=int, default=2)
    ap.add_argument("--skip-fovea", action="store_true")
    ap.add_argument("--skip-q", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "make_reference_4k"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    dev = device(args.cpu)
    cs, probe, cam = city_setup(dev)
    cfg = reference_config(dev, W4K, H4K, args.spp_per_launch)
    os.makedirs(args.out_dir, exist_ok=True)
    log = lambda s: print(s, flush=True)  # noqa: E731

    if not args.skip_fovea:
        t0 = time.perf_counter()
        px, py, img = fovea_disc(cs, probe, cam, cfg, args.disc_spp, args.disc_r, log)
        sync(dev)
        print(f"disc: {args.disc_spp} spp in {time.perf_counter() - t0:.3f}s")
        out = os.path.join(args.out_dir, "ref_city_4k_fovea.npz")
        save_fovea(out, px, py, img, W4K, H4K, args.disc_spp, args.disc_r)
        print(f"wrote {out} mean={img.mean():.4f}")

    if not args.skip_q:
        print(f"companion: {W4K}x{H4K} at {args.q_spp} spp -> {W4K // Q}x{H4K // Q}", flush=True)
        t0 = time.perf_counter()
        q = companion(cs, probe, cam, cfg, args.q_spp, log)
        print(f"companion: {args.q_spp} spp in {time.perf_counter() - t0:.3f}s")
        out = os.path.join(args.out_dir, "ref_city_4k_q.npz")
        np.savez_compressed(
            out, image=q.astype(np.float16), width=W4K // Q, height=H4K // Q,
            full_width=W4K, full_height=H4K, spp=args.q_spp,
            effective_spp=args.q_spp * 16, sampling="sobol", max_depth=4,
            scene="city_12500_seed0")
        print(f"wrote {out} mean={q.mean():.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
