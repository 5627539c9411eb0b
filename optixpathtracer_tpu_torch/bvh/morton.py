"""30-bit Morton codes for the host-side scene build (port of the numpy
path of optixpathtracer_tpu/bvh/morton.py)."""
from __future__ import annotations

import numpy as np


def np_morton_codes(centroids: np.ndarray) -> np.ndarray:
    """(T, 3) float centroids -> (T,) uint32 30-bit Morton codes (numpy)."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    extent = np.maximum(c.max(axis=0) - lo, 1e-9)
    q = np.clip(((c - lo) / extent * 1024.0), 0.0, 1023.0).astype(np.uint32)

    def spread(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    return (
        (spread(q[:, 0]) << np.uint32(2))
        | (spread(q[:, 1]) << np.uint32(1))
        | spread(q[:, 2])
    )


def np_clz32(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint32 lanes (32 for 0), numpy."""
    x = x.astype(np.uint32)
    x = x | (x >> np.uint32(1))
    x = x | (x >> np.uint32(2))
    x = x | (x >> np.uint32(4))
    x = x | (x >> np.uint32(8))
    x = x | (x >> np.uint32(16))
    y = ~x
    y = y - ((y >> np.uint32(1)) & np.uint32(0x55555555))
    y = (y & np.uint32(0x33333333)) + ((y >> np.uint32(2)) & np.uint32(0x33333333))
    y = (y + (y >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((y * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)
