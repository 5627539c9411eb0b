"""X11 pixmaps (XPM), as PIL's XpmImagePlugin reads them: the values line,
the colour table (`c #RRGGBB` only; `None` makes no entry), then the pixel
strings, `bpp` characters a pixel; up to 256 colours a palette image,
more an RGB one."""
from __future__ import annotations

import re

import numpy as np

from ._common import DecodeError, NotThisFormat

_VALUES = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def rgb8(data: bytes) -> np.ndarray:
    lines = [line + b"\n" for line in data[9:].split(b"\n")]  # readline's lines
    lines[-1] = lines[-1][:-1]
    i = 0
    while True:
        if i >= len(lines):
            raise NotThisFormat("broken XPM file")
        m = _VALUES.match(lines[i])
        i += 1
        if m:
            break
    try:
        width, height, n_colours, bpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise NotThisFormat("bad XPM values") from e
    palette = {}
    for _ in range(n_colours):
        line = (lines[i] if i < len(lines) else b"").rstrip()
        i += 1
        key, words = line[1:bpp + 1], line[bpp + 1:-2].split()
        for j in range(0, len(words), 2):
            if words[j] == b"c":
                value = words[j + 1] if j + 1 < len(words) else b""
                if value == b"None":
                    pass
                elif value.startswith(b"#"):
                    v = int(value[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise DecodeError("cannot read this XPM file")
                break
        else:
            raise DecodeError("cannot read this XPM file")
    keys = list(palette)
    index = {k: j for j, k in reversed(list(enumerate(keys)))}
    n = width * height
    out = []
    header = False
    while len(out) < n and i < len(lines):
        line = lines[i]
        i += 1
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        s = b'"'.join(line.split(b'"')[1:-1])
        for j in range(0, len(s), bpp):
            k = s[j:j + bpp]
            if k not in index:
                raise DecodeError(f"XPM pixel {k!r} not in its colour table")
            out.append(index[k])
    if len(out) < n:
        raise DecodeError("not enough image data")
    colours = np.array([palette[k] for k in keys], np.uint8).reshape(-1, 3)
    return colours[np.array(out[:n], np.int64).reshape(height, width)]
