"""Autodesk FLI / FLC animations, the first frame, as PIL's FliImagePlugin
and FliDecode read it: the palette of the first frame's first COLOR chunk
(256-colour, or 64-colour scaled by 4; a grey ramp without one), then the
frame's chunks over a black image: BRUN (byte runs), COPY, BLACK, LC (byte
deltas), SS2 (word deltas) and the ignored PSTAMP; any other chunk fails,
as PIL fails it."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, u16le, u32le


def _i16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise DecodeError("truncated FLI chunk")
    return u16le(data, pos)


def _palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    i = 0
    for _ in range(_i16(data, pos)):
        skip, n = data[pos + 2:pos + 4]
        pos += 4
        i += skip
        n = n or 256
        rgb = np.frombuffer(data[pos:pos + 3 * n][:3 * n - (len(data[pos:pos + 3 * n]) % 3)], np.uint8)
        pos += 3 * n
        rgb = rgb.reshape(-1, 3).astype(np.int64) << shift
        if i + len(rgb) > 256:
            raise DecodeError("FLI palette past 256 entries")
        pal[i:i + len(rgb)] = rgb
        i += len(rgb)
    return pal


def rgb8(data: bytes) -> np.ndarray:
    width, height = u16le(data, 8), u16le(data, 10)
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    head = data[128:144]
    pos = 128
    if len(head) == 16 and u16le(head, 4) == 0xF100:
        pos = 128 + u32le(head, 0)
        head = data[pos:pos + 16]
    if len(head) == 16 and u16le(head, 4) == 0xF1FA:  # the first frame's first COLOR chunk sets the palette
        at, size = pos + 16, None
        for _ in range(u16le(head, 6)):
            if size is not None:
                at += size
            sub = data[at:at + 6]
            if len(sub) < 6:
                break
            if u16le(sub, 4) in (4, 11):
                pal = _palette(data, at + 6, 2 if u16le(sub, 4) == 11 else 0)
                break
            size = u32le(sub, 0)
            if not size:
                break
    img = np.zeros((height, width), np.uint8)
    frame = data[128:]
    if len(frame) < 4:
        raise DecodeError("missing frame size")
    size = u32le(frame, 0)
    if len(frame) + len(frame) % 2 < size:
        raise DecodeError("image file is truncated")
    if len(frame) < 8 or u16le(frame, 4) != 0xF1FA:
        raise DecodeError("FLI frame of an unknown chunk type")
    chunks = u16le(frame, 6)
    ptr, left = 16, len(frame) - 16
    for _ in range(chunks):
        if left < 10:
            raise DecodeError("FLI chunk past the data")
        kind, d = u16le(frame, ptr + 4), ptr + 6
        if kind == 7:
            _ss2(frame, d, img)
        elif kind == 12:
            _lc(frame, d, img)
        elif kind == 13:
            img[:] = 0
        elif kind == 15:
            _brun(frame, d, img)
        elif kind == 16:
            n = width * height
            if d + n > ptr + left:
                raise DecodeError("image file is truncated")
            img[:] = np.frombuffer(frame[d:d + n], np.uint8).reshape(height, width)
        elif kind not in (4, 11, 18):
            raise DecodeError(f"unknown FLI chunk {kind}")
        advance = u32le(frame, ptr)
        if advance == 0 or advance > left:
            raise DecodeError("broken FLI chunk size")
        ptr, left = ptr + advance, left - advance
    return pal[img].astype(np.uint8)


def _brun(f: bytes, d: int, img: np.ndarray) -> None:
    height, width = img.shape
    for y in range(height):
        d += 1  # the packet count byte, which PIL ignores
        x = 0
        while x < width:
            if d + 2 > len(f):
                raise DecodeError("FLI BRUN past the data")
            c = f[d]
            if c & 0x80:
                n = 256 - c
                if x + n > width:
                    break
                img[y, x:x + n] = np.frombuffer(f[d + 1:d + 1 + n].ljust(n, b"\0"), np.uint8)
                d += n + 1
            else:
                n = c
                if x + n > width:
                    break
                img[y, x:x + n] = f[d + 1]
                d += 2
            x += n
        if x != width:
            raise DecodeError("FLI BRUN line not unpacked whole")


def _lc(f: bytes, d: int, img: np.ndarray) -> None:
    height, width = img.shape
    y = _i16(f, d)
    ymax = y + _i16(f, d + 2)
    d += 4
    while y < ymax and y < height:
        packets = f[d]
        d += 1
        x, p = 0, 0
        while p < packets:
            x += f[d]
            c = f[d + 1]
            if c & 0x80:
                n = 256 - c
                if x + n > width:
                    break
                img[y, x:x + n] = f[d + 2]
                d += 3
            else:
                n = c
                if x + n > width:
                    break
                img[y, x:x + n] = np.frombuffer(f[d + 2:d + 2 + n], np.uint8)
                d += n + 2
            x += n
            p += 1
        if p < packets:
            break
        y += 1
    if y < ymax:
        raise DecodeError("FLI LC lines not processed")


def _ss2(f: bytes, d: int, img: np.ndarray) -> None:
    height, width = img.shape
    lines = _i16(f, d)
    d += 2
    y, line = 0, 0
    while line < lines and y < height:
        packets = _i16(f, d)
        d += 2
        while packets & 0x8000:
            if packets & 0x4000:
                y += 65536 - packets
                if y >= height:
                    raise DecodeError("FLI SS2 skips past the image")
            else:
                img[y, width - 1] = packets & 0xFF
            packets = _i16(f, d)
            d += 2
        x, p = 0, 0
        while p < packets:
            x += f[d]
            c = f[d + 1]
            if c >= 128:
                n = 256 - c
                if x + 2 * n > width:
                    break
                img[y, x:x + 2 * n] = np.tile(np.frombuffer(f[d + 2:d + 4], np.uint8), n)
                d += 4
                x += 2 * n
            else:
                n = 2 * c
                if x + n > width:
                    break
                img[y, x:x + n] = np.frombuffer(f[d + 2:d + 2 + n], np.uint8)
                d += 2 + n
                x += n
            p += 1
        if p < packets:
            break
        line += 1
        y += 1
    if line < lines:
        raise DecodeError("FLI SS2 lines not processed")
