"""McIdas area files, as PIL's McIdasImagePlugin reads them: the 64-word
big-endian area descriptor; 1, 2 or 4 bytes a pixel (grey, and the 16- and
32-bit integers PIL clamps into 0-255), each row after a prefix, from the
offset the descriptor gives."""
from __future__ import annotations

import struct

import numpy as np

from ._common import NotThisFormat, grey_rgb, raw_rows


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 256:
        raise NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack("!64i", data[:256])
    size = w[11]
    if size not in (1, 2, 4):
        raise NotThisFormat("unsupported McIdas format")
    width, height = w[10], w[9]
    rows = raw_rows(data, w[34] + w[15], height, width * size, w[15] + w[10] * w[11] * w[14], "McIdas")
    if size == 1:
        return grey_rgb(rows)
    v = rows.copy().view(">u2" if size == 2 else ">i4").astype(np.int64)
    return grey_rgb(np.clip(v, 0, 255).astype(np.uint8))
