"""FTEX (Independence War 2 textures), as PIL's FtexImagePlugin reads it:
one format entry, the first mip level, DXT1 (Pillow's BC1 decoder, as in
dds.py) or uncompressed RGB."""
from __future__ import annotations

import struct

import numpy as np

from . import dds
from ._common import DecodeError, need, raw_rows


def rgb8(data: bytes) -> np.ndarray:
    need(data, 32, "FTEX")
    width, height, _, n_formats, fmt, where = struct.unpack("<2i2i2i", data[8:32])
    if n_formats != 1:
        raise DecodeError("FTEX with more than one format")
    need(data, where + 4, "FTEX")
    size = struct.unpack("<i", data[where:where + 4])[0]
    body = data[where + 4:where + 4 + max(size, 0)]
    if fmt == 0:
        px = dds._bc1_colour(dds._blocks(body, 0, width, height, 8), False)
        return np.ascontiguousarray(dds._tile(px, width, height).astype(np.uint8))
    if fmt == 1:
        return raw_rows(body, 0, height, 3 * width, what="FTEX").reshape(height, width, 3).copy()
    raise DecodeError(f"Invalid texture compression format: {fmt!r}")
