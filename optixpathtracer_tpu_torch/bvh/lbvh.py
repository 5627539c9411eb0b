"""LBVH host order: Morton sort of triangle centroids (port of the numpy
path of optixpathtracer_tpu/bvh/lbvh.py `build_bvh`, as far as `order` and
`padded_count`). The cluster backend needs no binary tree on the device, so
the Karras emission and refit are not ported (the lockstep backend is
ROADMAP "not to port")."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .morton import np_morton_codes


class BuildResult(NamedTuple):
    order: np.ndarray  # sorted position -> original triangle
    padded_count: int  # triangles after padding to whole leaves


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 4) -> BuildResult:
    """Morton order of (T, 3) triangles, padded to whole `leaf_size` leaves
    by repeating the last sorted triangle (duplicate hits are harmless)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    pad_to = max(leaf_size, ((t + leaf_size - 1) // leaf_size) * leaf_size)
    c = (v0.astype(np.float64) + v1 + v2) / 3.0
    order = np.argsort(np_morton_codes(c), kind="stable")
    if pad_to > t:
        order = np.concatenate([order, np.repeat(order[-1:], pad_to - t)])
    return BuildResult(order=order, padded_count=pad_to)
