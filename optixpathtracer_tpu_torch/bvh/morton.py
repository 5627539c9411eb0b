"""30-bit Morton codes: the host-side numpy path the scene build uses, and
the device path over tensors (port of optixpathtracer_tpu/bvh/morton.py).
Device words are uint32 values in int64 tensors, masked back into range
after each operation, as in core/rng; counts come back as int32."""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


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


def expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each lane out to every third bit. Each
    product of a uint32 and a constant below 2**17 fits in int64; the mask
    keeps its low 32 bits."""
    v = v.to(torch.int64) & M32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code from coordinates already scaled to [0, 1024)."""
    xi, yi, zi = (torch.clamp(a, 0.0, 1023.0).to(torch.int64) for a in (x, y, z))
    return (expand_bits_10(xi) << 2) | (expand_bits_10(yi) << 1) | expand_bits_10(zi)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & M32) >> 24).to(torch.int32)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros (32 for x == 0)."""
    x = x.to(torch.int64) & M32
    for k in (1, 2, 4, 8, 16):
        x = x | (x >> k)
    return popcount32(x ^ M32)


def morton_codes(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """Morton codes (int64 holding uint32) for float32 centroid arrays,
    normalised by their joint AABB in float32, as the reference's jnp path;
    the extent is a device tensor, so the division is a true one on the card
    too."""
    mins = torch.stack([cx.min(), cy.min(), cz.min()])
    maxs = torch.stack([cx.max(), cy.max(), cz.max()])
    extent = torch.clamp(maxs - mins, min=1e-9)
    q = [(c - mins[k]) / extent[k] * 1024.0 for k, c in enumerate((cx, cy, cz))]
    return morton3d(*q)
