"""IM Tools (IMT), as PIL's ImtImagePlugin reads it: "key value" lines
(width, height, `pixel n8` for 8-bit grey; `*` comments) up to a form
feed, then the rows."""
from __future__ import annotations

import re

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, raw_rows

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def rgb8(data: bytes) -> np.ndarray:
    buffer, pos = data[:100], min(100, len(data))
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM file")
    width = height = 0
    grey = False
    offset = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], pos + 1
        if not s:
            break
        if s == b"\x0c":
            offset = min(pos, len(data)) - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer, pos = buffer + more, pos + len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                width = int(v)
            elif k == b"height":
                height = int(v)
        except ValueError as e:
            raise DecodeError(f"IMT header value {v!r}") from e
        if k == b"pixel" and v == b"n8":
            grey = True
    if not grey or width <= 0 or height <= 0:
        raise NotThisFormat("not identified by the IMT reader")
    if offset is None:
        raise DecodeError("IMT image without its form feed")
    return grey_rgb(raw_rows(data, offset, height, width, what="IMT"))
