"""QOI (the Quite OK Image format), as PIL's QoiDecoder reads it: the six
operations (RGB, RGBA, index, diff, luma, run) over a 64-entry hash of
the pixels seen, from opaque black; RGB or RGBA by the header's channel
count. A sequential host loop over the bytes."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, need, u32be


def rgb8(data: bytes) -> np.ndarray:
    need(data, 14, "QOI")
    width, height = u32be(data, 4), u32be(data, 8)
    n = width * height
    out = bytearray()
    seen = {}
    px = (0, 0, 0, 255)
    pos = 14
    end = len(data)
    while len(out) < 3 * n:
        if pos >= end:
            raise DecodeError("truncated QOI data")
        b = data[pos]
        pos += 1
        if b == 0xFE:
            px = (data[pos], data[pos + 1], data[pos + 2], px[3])
            pos += 3
        elif b == 0xFF:
            px = tuple(data[pos:pos + 4])
            pos += 4
        elif b >> 6 == 0:
            px = seen.get(b & 63, (0, 0, 0, 0))
        elif b >> 6 == 1:
            px = ((px[0] + ((b >> 4) & 3) - 2) & 255, (px[1] + ((b >> 2) & 3) - 2) & 255,
                  (px[2] + (b & 3) - 2) & 255, px[3])
        elif b >> 6 == 2:
            b2 = data[pos]
            pos += 1
            dg = (b & 63) - 32
            px = ((px[0] + dg + (b2 >> 4) - 8) & 255, (px[1] + dg) & 255, (px[2] + dg + (b2 & 15) - 8) & 255,
                  px[3])
        else:
            out += bytes(px[:3]) * ((b & 63) + 1)  # a run: the index is left as it is
            continue
        seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        out += bytes(px[:3])
    return np.frombuffer(bytes(out[:3 * n]), np.uint8).reshape(height, width, 3).copy()
