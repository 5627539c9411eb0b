"""Numeric validation checks (port of optixpathtracer_tpu/utils/validation.py;
the original's Validate()/isfinite machinery, maths.h:122-163).

`validate` raises on non-finite values when `OPTIXPT_VALIDATE=1` (read at
call time) or inside `debug_nans()`; `assert_image_ok` checks a host frame.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..core.math import Vec3

_forced = [False]  # set inside debug_nans()


def _enabled() -> bool:
    return _forced[0] or os.environ.get("OPTIXPT_VALIDATE", "0") == "1"


def validate(x, name: str = "value"):
    """Return x; when validation is on, raise FloatingPointError if any
    component holds a non-finite value (this synchronises with the device)."""
    if not _enabled():
        return x
    comps = zip("xyz", x) if isinstance(x, Vec3) else ((None, x),)
    for c, arr in comps:
        bad = int((~torch.isfinite(torch.as_tensor(arr))).sum())
        if bad:
            where = name if c is None else f"{name}.{c}"
            raise FloatingPointError(f"non-finite values in {where}: {bad}")
    return x


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped switch that turns `validate` on (the reference's 'sanitizer'
    switch). jax's debug_nans traps the first operation that makes a NaN;
    PyTorch has no such per-operation trap for forward tensor code, so here
    only the explicit `validate` checks fire."""
    prev = _forced[0]
    _forced[0] = enable
    try:
        yield
    finally:
        _forced[0] = prev


def assert_image_ok(img, what: str = "frame") -> None:
    """Host-side frame sanity: finite and non-negative (failure detection)."""
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    if not np.isfinite(arr).all():
        raise FloatingPointError(f"{what}: non-finite pixels ({(~np.isfinite(arr)).sum()})")
    if arr.dtype.kind == "f" and arr.min() < -1e-4:
        raise FloatingPointError(f"{what}: negative radiance (min {arr.min()})")
