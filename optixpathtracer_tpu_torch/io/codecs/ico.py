"""Windows ICO and CUR, as PIL's IcoImagePlugin and CurImagePlugin read
them: ICO's largest entry (the fewest colours among equals), a PNG or a
DIB of twice its height (the AND mask's half is alpha, which RGB drops);
CUR's first entry unless a later one is larger in both directions."""
from __future__ import annotations

import math

import numpy as np

from ._common import DecodeError, NotThisFormat, need, u16le, u32le
from .bmp import bitmap


def rgb8(data: bytes) -> np.ndarray:
    need(data, 6, "ICO")
    entries = []
    for i in range(u16le(data, 4)):
        e = data[6 + 16 * i:22 + 16 * i]
        need(e, 16, "ICO")
        w, h, colours, bpp = e[0] or 256, e[1] or 256, e[2], u16le(e, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((w * h, depth, u32le(e, 12)))
    if not entries:
        raise DecodeError("ICO without entries")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    offset = entries[0][2]
    if data[offset:offset + 8] == b"\x89PNG\r\n\x1a\n":
        from ..image import rgb8_from_png

        return rgb8_from_png(data[offset:])
    return bitmap(data, offset, 0, height_div=2)


def cur_rgb8(data: bytes) -> np.ndarray:
    need(data, 6, "CUR")
    best = None
    for i in range(u16le(data, 4)):
        e = data[6 + 16 * i:22 + 16 * i]
        need(e, 16, "CUR")
        if best is None or (e[0] > best[0] and e[1] > best[1]):
            best = e
    if best is None:
        raise NotThisFormat("No cursors were found")
    return bitmap(data, u32le(best, 12), 0, height_div=2)
