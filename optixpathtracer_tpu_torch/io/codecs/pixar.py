"""PIXAR raster images, as PIL's PixarImagePlugin reads them: the size at
bytes 416 / 418 of the 512-byte header, 8-bit RGB (mode 14, 2) raw from
byte 1024."""
from __future__ import annotations

import numpy as np

from ._common import NotThisFormat, need, raw_rows, u16le


def rgb8(data: bytes) -> np.ndarray:
    need(data, 512, "PIXAR")
    width, height = u16le(data, 418), u16le(data, 416)
    if (u16le(data, 424), u16le(data, 426)) != (14, 2):
        raise NotThisFormat("PIXAR image of no mode PIL reads")
    return raw_rows(data, 1024, height, 3 * width, what="PIXAR").reshape(height, width, 3).copy()
