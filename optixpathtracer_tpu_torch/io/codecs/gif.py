"""GIF87a / GIF89a, frame 0, as PIL's GifImagePlugin reads it.

Global and local palettes (a palette that is the grey ramp 0, 1, 2, ...
makes PIL open the frame as grey: indices read as grey levels), the
transparency index of the graphic control extension, interlacing, LZW code
sizes 2-8 with clear codes and the full 4096-entry table. The image is the
logical screen grown to hold frame 0; what frame 0 leaves uncovered holds
index 0, or the transparency index if frame 0 has one, as PIL fills it.
Later frames of an animation are not read."""
from __future__ import annotations

import numpy as np

from . import lzw
from ._common import DecodeError, NotThisFormat, grey_rgb, need, u16le


def _palette(raw: bytes):
    """A colour table -> (256, 3) uint8, entries past it black; None where
    PIL needs no palette (the grey ramp)."""
    ent = np.frombuffer(raw[:len(raw) // 3 * 3], np.uint8).reshape(-1, 3)
    if all(e[0] == e[1] == e[2] == i for i, e in enumerate(ent.tolist())):
        return None
    pal = np.zeros((256, 3), np.uint8)
    pal[:min(256, len(ent))] = ent[:256]
    return pal


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 13:
        raise NotThisFormat("GIF header")
    width, height = u16le(data, 6), u16le(data, 8)
    flags = data[10]
    pos = 13
    global_pal = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos:pos + n])
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise DecodeError("image not found in GIF frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension: its label, then sub-blocks
            label = data[pos]
            pos += 1
            first = data[pos + 1:pos + 1 + data[pos]] if pos < len(data) and data[pos] else None
            if label == 0xF9 and first is not None and len(first) >= 4 and first[0] & 1:
                transparency = first[3]
            _, pos = _sub_blocks(data, pos)
        elif kind == 0x2C:
            need(data, pos + 9, "GIF")
            x0, y0, fw, fh = (u16le(data, pos + 2 * i) for i in range(4))
            fflags = data[pos + 8]
            pos += 9
            palette = global_pal
            if fflags & 128:
                n = 3 << ((fflags & 7) + 1)
                palette = _palette(data[pos:pos + n])
                pos += n
            need(data, pos + 1, "GIF")
            min_size = data[pos]
            codes, _ = _sub_blocks(data, pos + 1)
            break
        # PIL skips any other byte between blocks
    size_w, size_h = max(width, x0 + fw), max(height, y0 + fh)
    canvas = np.full((size_h, size_w), transparency or 0, np.uint8)
    n = fw * fh
    px = lzw.gif_decode(codes, min_size, n)
    if len(px) < n:
        raise DecodeError("truncated GIF image data")
    frame = np.frombuffer(px, np.uint8, n).reshape(fh, fw)
    if fflags & 64:  # interlaced: rows 0::8, 4::8, 2::4, 1::2 in that order
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8), np.arange(2, fh, 4),
                                np.arange(1, fh, 2)])
        deint = np.empty_like(frame)
        deint[order] = frame
        frame = deint
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return grey_rgb(canvas)
    return palette[canvas]
