"""X11 bitmaps (XBM), as PIL's XbmImagePlugin and XbmDecode read them: the
size from the #define lines in the first 512 bytes, then after `_bits[]`
each byte as the two characters after the next 'x' (a non-hex character
counts 0), eight pixels a byte, least significant bit first, a set bit
white."""
from __future__ import annotations

import re

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
    _HEX[bytes([_c]).upper()[0]] = _i


def rgb8(data: bytes) -> np.ndarray:
    m = _HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not a XBM file")
    width, height = int(m.group("width")), int(m.group("height"))
    stride = (width + 7) // 8
    n = stride * height
    body = np.frombuffer(data, np.uint8)
    xs = np.flatnonzero(body[m.end():] == ord("x")) + m.end()
    vals = []
    pos = m.end()
    for x in xs:  # a value's two characters may hold an 'x': step on from after them
        if x < pos:
            continue
        if x + 3 > len(data):
            break
        vals.append(_HEX[body[x + 1]] << 4 | _HEX[body[x + 2]])
        pos = x + 3
        if len(vals) == n:
            break
    if len(vals) < n:
        raise DecodeError("image file is truncated")
    rows = np.array(vals, np.uint8).reshape(height, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :width]
    return grey_rgb(bits * np.uint8(255))
