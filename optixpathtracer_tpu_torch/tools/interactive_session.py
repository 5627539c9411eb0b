"""Record a live interactive foveated session (port of
tools/interactive_session.py).

Drives the viewer's render loop headlessly at 640x480 with a scripted
circular gaze path and the composed pipeline (fused 3-zone foveation +
Sobol + Russian roulette + denoised fovea display) through the port's
`bench.interactive_line`, and writes the per-frame TSV in the reference's
own data_save.dat column format (sv3 main.cpp:348-383), the analog of the
reference's committed session traces (data.tsv, written by
sutil/sutil.cpp:758-773). The default output is
interactive_640x480.tsv in the temp directory: the committed
docs/sessions/interactive_640x480.tsv is the JAX package's record.

Run:  python -m optixpathtracer_tpu_torch.tools.interactive_session
          [--frames N] [--out FILE] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from .. import bench
from . import city, device


def session(cs, probe, frames: int, out: str, width: int = 640, height: int = 480) -> dict:
    """`bench.interactive_line` over `frames` frames, its rows written to `out`."""
    return bench.interactive_line(cs, probe, frames=frames, record_path=out, width=width,
                                  height=height)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="optixpathtracer_tpu_torch.tools.interactive_session")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    dev = device(args.cpu)
    cs, probe = city(dev)
    out = args.out or os.path.join(tempfile.gettempdir(), "interactive_640x480.tsv")
    rec = session(cs, probe, args.frames, out)
    print(json.dumps(rec))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
