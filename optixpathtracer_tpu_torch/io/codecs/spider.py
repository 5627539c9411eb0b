"""SPIDER 2-D images, as PIL's SpiderImagePlugin reads them: the header of
floats in either byte order (big-endian tried first), a single image or
the first of a stack, 32-bit float pixels converted as PIL's F -> L
(clipped into 0-255, truncated)."""
from __future__ import annotations

import struct

import numpy as np

from ._common import DecodeError, NotThisFormat, float_l, grey_rgb, raw_rows


def _header(data: bytes, order: str):
    t = struct.unpack(order + "27f", data[:108])
    h = (99.0,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not np.isfinite(h[i]) or not float(h[i]).is_integer():
            return None, 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22) or int(h[22]) != int(h[13]) * int(h[23]):
        return None, 0
    return h, int(h[22])


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 108:
        raise NotThisFormat("not a valid Spider file")
    order = ">"
    h, hdrlen = _header(data, order)
    if not hdrlen:
        order = "<"
        h, hdrlen = _header(data, order)
    if not hdrlen or int(h[5]) != 1:
        raise NotThisFormat("not a Spider 2D image")
    width, height = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    else:
        raise DecodeError("SPIDER stack header PIL does not open here")
    rows = raw_rows(data, offset, height, 4 * width, what="SPIDER")
    f = rows.copy().view(np.dtype(order + "f4")).reshape(height, width)
    return grey_rgb(float_l(f))
