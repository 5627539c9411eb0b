"""Kodak PhotoCD, the 768x512 base image as PIL's PcdImagePlugin and
PcdDecode read it: from byte 96 * 2048, pairs of luma rows with their
half-width C1 and C2 rows, PhotoYCC converted as PIL's YCC;P unpacker
converts it (fixed tables, each (int)(k * v + 0.5) as C truncates it),
turned by the header's orientation (1: 90 degrees, 3: 270)."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError

_V = np.arange(256)


def _table(k: float, off: int) -> np.ndarray:
    return np.trunc(k * (_V - off) + 0.5).astype(np.int64)


_L = np.round(1.3584 * _V).astype(np.int64)
_CR, _CB = _table(1.8215, 137), _table(2.2179, 156)
_GR, _GB = _table(-0.509 * 1.8215, 137), _table(-0.194 * 2.2179, 156)


def rgb8(data: bytes) -> np.ndarray:
    orientation = data[2048 + 1538] & 3 if len(data) > 2048 + 1538 else 0
    body = data[96 * 2048:96 * 2048 + 256 * 2304]
    if len(body) < 256 * 2304:
        raise DecodeError("image file is truncated")
    chunks = np.frombuffer(body, np.uint8).reshape(256, 2304)
    y = chunks[:, :1536].reshape(512, 768).astype(np.int64)
    c1 = np.repeat(np.repeat(chunks[:, 1536:1920], 2, 0), 2, 1)
    c2 = np.repeat(np.repeat(chunks[:, 1920:], 2, 0), 2, 1)
    lum = _L[y]
    rgb = np.stack([lum + _CR[c2], lum + _GR[c2] + _GB[c1], lum + _CB[c1]], -1)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if orientation in (1, 3):
        rgb = np.ascontiguousarray(np.rot90(rgb, 1 if orientation == 1 else -1))
    return rgb
