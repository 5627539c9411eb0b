"""A converged reference of the bench city for the time-to-RMSE track
(port of tools/make_reference.py): the city rendered to convergence with
stratified sampling (unbiased: the same estimator mean as the benched rows,
its streams apart from both the random uniform row and the Sobol pipeline
row), max_depth 4.

The artifact (ref_city_{W}x{H}.npz) stores the converged accumulation as
float16 in the renderer's canonical flat order (row 0 = bottom, y-major),
exactly `Renderer.accum` unpermuted, under the reference's keys. It is
checkpointed at power-of-two spp milestones (512 spp onward, temp file +
rename), and at the end, so a long run is usable from its first milestone;
each npz records its own `spp`.

It writes to --out-dir (default make_reference/ in the temp directory),
never to scenes/: the committed scenes/ref_city_*.npz stay the references.
On the card it renders through the cluster walk with the ray sort, with
--cpu through the lockstep walk, as the reference does on a CPU.

Run:  python -m optixpathtracer_tpu_torch.tools.make_reference            # 600x400, 4096 spp
      python -m optixpathtracer_tpu_torch.tools.make_reference --width 1200 --height 800
          [--spp N] [--spp-per-launch N] [--out-dir DIR] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .. import scenes
from ..engine.renderer import Renderer
from ..engine.wavefront import RenderConfig
from . import city, device

MILESTONES = (512, 1024, 2048, 4096, 8192)


def save_reference(path: str, canonical: np.ndarray, w: int, h: int, spp: int, log=print) -> None:
    """One checkpoint under the reference's keys (temp file + rename)."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, image=canonical.astype(np.float16), width=w, height=h,
        spp=spp, max_depth=4, scene="city_12500_seed0",
        eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), fov_y=45.0,
    )
    os.replace(tmp, path)
    log(f"checkpoint {spp} spp -> {path} mean={canonical.mean():.4f}")


def reference_renderer(cs, probe, w: int, h: int, spp_per_launch: int) -> Renderer:
    """The reference generator's renderer: stratified, depth 4, one dispatch;
    the cluster walk with the ray sort on the card, lockstep on a CPU."""
    on_cpu = cs.device.type == "cpu"
    cfg = RenderConfig(
        width=w, height=h, samples_per_launch=spp_per_launch, max_depth=4,
        traversal="lockstep" if on_cpu else "cluster", dispatch_tiles=1,
        sort_rays=not on_cpu, nee_final_bounce=False, batch_spp=True,
        sampling="stratified",
    )
    return Renderer(cs, probe, cfg, scenes.city_camera(w, h))


def canonical(r: Renderer) -> np.ndarray:
    """The accumulation as flat (H*W, 3), row 0 = bottom."""
    accum = np.stack([c.cpu().numpy() for c in r.accum], -1)
    return accum[r._inv_perm]


def make_reference(cs, probe, w: int, h: int, spp: int, spp_per_launch: int, out: str,
                   milestones=MILESTONES, log=print) -> Renderer:
    """Render `spp` samples in launches of `spp_per_launch`, checkpointing
    to `out` at each milestone reached (a milestone fires on `spp_done >=
    m`, so launch sizes that do not divide it still checkpoint) and at the
    end. Returns the renderer."""
    if spp % spp_per_launch:
        raise ValueError(f"spp {spp} must be divisible by spp_per_launch {spp_per_launch}")
    r = reference_renderer(cs, probe, w, h, spp_per_launch)
    pending = sorted(m for m in milestones if m <= spp)
    n_launches = spp // spp_per_launch
    t0 = time.perf_counter()
    for i in range(n_launches):
        r.render(download=False)
        spp_done = (i + 1) * spp_per_launch
        hit = False
        while pending and spp_done >= pending[0]:
            pending.pop(0)
            hit = True
        if hit or i + 1 == n_launches:
            save_reference(out, canonical(r), w, h, spp_done, log)
        if (i + 1) % 64 == 0:
            float(r.last_output.rays_traced)  # a device sync for an honest ETA
            dt = time.perf_counter() - t0
            log(f"{spp_done} spp, {dt:.0f}s (ETA {dt / (i + 1) * (n_launches - i - 1):.0f}s)")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="optixpathtracer_tpu_torch.tools.make_reference")
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--height", type=int, default=400)
    ap.add_argument("--spp", type=int, default=4096)
    ap.add_argument("--spp-per-launch", type=int, default=8)
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "make_reference"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    w, h, spl = args.width, args.height, args.spp_per_launch
    if args.spp % spl:
        ap.error(f"--spp {args.spp} must be divisible by --spp-per-launch {spl}")

    dev = device(args.cpu)
    cs, probe = city(dev)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"ref_city_{w}x{h}.npz")
    t0 = time.perf_counter()
    make_reference(cs, probe, w, h, args.spp, spl, out, log=lambda s: print(s, flush=True))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"rendered {args.spp} spp in {time.perf_counter() - t0:.3f}s")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
