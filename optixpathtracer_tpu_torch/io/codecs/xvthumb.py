"""XV thumbnails, as PIL's XVThumbImagePlugin reads them: "P7 332", comment
lines, the size, then one byte a pixel through the 3-3-2 palette
(r * 255 // 7, g * 255 // 7, b * 255 // 3)."""
from __future__ import annotations

import numpy as np

from ._common import NotThisFormat, raw_rows

_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3) for r in range(8) for g in range(8)
                     for b in range(4)], np.uint8)


def rgb8(data: bytes) -> np.ndarray:
    pos = data.find(b"\n", 6)
    pos = len(data) if pos < 0 else pos + 1
    while True:
        end = data.find(b"\n", pos)
        line, pos = (data[pos:], len(data)) if end < 0 else (data[pos:end + 1], end + 1)
        if not line:
            raise NotThisFormat("Unexpected EOF reading XV thumbnail file")
        if line[0] != 35:
            break
    try:
        width, height = (int(v) for v in line.strip().split(maxsplit=2)[:2])
    except ValueError as e:
        raise NotThisFormat("bad XV thumbnail size") from e
    return _PALETTE[raw_rows(data, pos, height, width, what="XV thumbnail")]
