"""The scripts of the repository's examples/ as modules of the port, each
run as `python -m optixpathtracer_tpu_torch.examples.<name> [out.png]
[--cpu]`: `render_loft`, `render_cornell`, `render_foveated`,
`demand_textures_demo`. Each renders on the card (cuda:0) unless `--cpu`
is given, writes its PNG through the port's own encoder (`io/image`, no
PIL), and keeps the original's sizes and defaults in `main`; its body is a
function of the sizes."""
from __future__ import annotations

import argparse
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(prog: str, default_out: str, argv=None) -> argparse.Namespace:
    """The originals' command line, `[out.png]`, plus `--cpu`."""
    ap = argparse.ArgumentParser(prog=f"optixpathtracer_tpu_torch.examples.{prog}")
    ap.add_argument("out", nargs="?", default=default_out)
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    return ap.parse_args(argv)


def frames_from_env(default: int = 8) -> int:
    """The originals' FRAMES environment variable."""
    return int(os.environ.get("FRAMES", str(default)))
