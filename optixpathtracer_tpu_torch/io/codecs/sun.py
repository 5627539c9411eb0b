"""Sun raster files, as PIL's SunImagePlugin reads them: 1-bit (set bits
black), 4 and 8-bit grey or, with an RGB colour map (all reds, then all
greens, then all blues), palette; 24 and 32-bit BGR(X), RGB(X) for type 3;
raw rows padded to 16 bits, or the RLE of type 2 (0x80 n v: n + 1 copies
of v; 0x80 0: one 0x80), whose rows PIL packs without that padding."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, need, pil_palette, raw_rows, u32be, unpack_bits


def _rle(data: bytes, pos: int, n: int) -> bytes:
    out = bytearray()
    end = len(data)
    while len(out) < n:
        if pos >= end:
            raise DecodeError("truncated SUN RLE data")
        b = data[pos]
        if b != 0x80:
            out.append(b)
            pos += 1
        elif pos + 1 >= end:
            raise DecodeError("truncated SUN RLE data")
        elif data[pos + 1] == 0:
            out.append(0x80)
            pos += 2
        else:
            if pos + 2 >= end:
                raise DecodeError("truncated SUN RLE data")
            out += bytes([data[pos + 2]]) * (data[pos + 1] + 1)
            pos += 3
    return bytes(out[:n])


def rgb8(data: bytes) -> np.ndarray:
    need(data, 32, "SUN")
    width, height, depth = u32be(data, 4), u32be(data, 8), u32be(data, 12)
    kind, pal_type, pal_len = u32be(data, 20), u32be(data, 24), u32be(data, 28)
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat("Unsupported Mode/Bit Depth")
    palette = None
    if pal_len:
        if pal_len > 1024 or pal_type != 1:
            raise NotThisFormat("Unsupported Color Palette")
        raw = np.frombuffer(data[32:32 + pal_len], np.uint8)
        n = len(raw) // 3
        palette = pil_palette(raw[:3 * n].reshape(3, n).T) if depth in (4, 8) else None
    if kind not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("Unsupported Sun Raster file type")
    pos = 32 + pal_len
    row = (width * depth + 7) // 8
    if kind == 2:
        rows = np.frombuffer(_rle(data, pos, row * height), np.uint8).reshape(height, row)
    else:
        rows = raw_rows(data, pos, height, row, (width * depth + 15) // 16 * 2, "SUN")
    if depth == 1:
        return grey_rgb(255 - unpack_bits(rows, width, 1) * np.uint8(255))
    if depth in (4, 8):
        v = unpack_bits(rows, width, depth)
        return palette[v] if palette is not None else grey_rgb(v * np.uint8(17) if depth == 4 else v)
    px = rows.reshape(height, width, depth // 8)[..., :3]
    return np.ascontiguousarray(px if kind == 3 else px[..., ::-1])
