"""The scripts of the repository's tools/ as modules of the port, each run
as `python -m optixpathtracer_tpu_torch.tools.<name>`: `fps_harness`,
`interactive_session`, `make_reference`, `make_reference_4k`. Each runs on
the card (cuda:0) unless `--cpu` is given, and never falls back to the CPU.
The reference's persistent compile cache (`utils.cache`) has no
counterpart: the kernels' hash-keyed `_build/` already keeps them.

Shared here: the device choice and the bench city every script renders."""
from __future__ import annotations

import torch

from .. import scenes
from ..bench import BUILD as CITY_BUILD
from ..bench import _device as device
from ..bench import _sync as sync
from ..builder import CompiledScene, compile_scene
from ..lights.probe import Probe

CITY_BOXES = 12500  # bench.py build_city_scene's default: 150k triangles
__all__ = ["CITY_BOXES", "CITY_BUILD", "city", "device", "sync"]


def city(dev: torch.device, n_boxes: int = CITY_BOXES) -> tuple[CompiledScene, Probe]:
    """The bench city (seed 0) compiled as the scripts compile it, and the
    bench's sky probe with a sun."""
    cs = compile_scene(scenes.build_city_scene(n_boxes=n_boxes), dev, **CITY_BUILD)
    return cs, scenes.city_sky(dev)
