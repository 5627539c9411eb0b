"""GIMP brushes (GBR), as PIL's GbrImagePlugin reads them: version 1 or 2
(with its "GIMP" magic), 8-bit grey or RGBA pixels after the header."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, u32be


def rgb8(data: bytes) -> np.ndarray:
    header, version, width, height, depth = (u32be(data, 4 * i) for i in range(5))
    if header < 20 or version not in (1, 2) or not width or not height or depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush")
    if version == 2 and data[20:24] != b"GIMP":
        raise NotThisFormat("not a GIMP brush, bad magic number")
    n = width * height * depth
    body = data[header:header + n]
    if len(body) < n:
        raise DecodeError("not enough image data")
    px = np.frombuffer(body, np.uint8).reshape(height, width, depth)
    return grey_rgb(px[..., 0]) if depth == 1 else np.ascontiguousarray(px[..., :3])
