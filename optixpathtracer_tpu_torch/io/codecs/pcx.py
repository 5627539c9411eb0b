"""ZSoft PCX, as PIL's PcxImagePlugin and PcxDecode read it: 1-bit, 2 and
4 bit planes of an EGA palette, 8-bit grey or palette (the 256-colour
table at the end of the file, a grey ramp read as grey) and 24-bit
(three planes a line); PCX's RLE per line, padded lines compacted as PIL
compacts them. DCX: the first frame of the container."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, u16le, u32le


def _lines(data: bytes, pos: int, line: int, width: int, height: int) -> list[bytes]:
    out = []
    buf = bytearray()
    n = len(data)
    while len(out) < height:
        if pos >= n:
            raise DecodeError("truncated PCX image data")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise DecodeError("truncated PCX image data")
            count = b & 0x3F
            if len(buf) + count > line:
                raise DecodeError("PCX run past the end of its line")
            buf += data[pos + 1:pos + 2] * count
            pos += 2
        else:
            buf.append(b)
            pos += 1
        if len(buf) >= line:
            if line % width and line > width:  # PIL packs padded planes to `width` bytes each
                bands = line // width
                stride = line // bands
                for i in range(1, bands):
                    buf[i * width:(i + 1) * width] = buf[i * stride:i * stride + width]
            out.append(bytes(buf))
            buf = bytearray()
    return out


def rgb8(data: bytes, base: int = 0) -> np.ndarray:
    """The PCX image whose header starts at data[base] (0, or a DCX
    frame's offset); the 256-colour table is the file's last 769 bytes."""
    if len(data) < base + 68:  # PIL's header read runs short: no PCX, the search goes on
        raise NotThisFormat("short PCX header")
    x0, y0, x1, y1 = (u16le(data, base + 4 + 2 * i) for i in range(4))
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    version, bits, planes, given = data[base + 1], data[base + 3], data[base + 65], u16le(data, base + 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P;L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(data[base + 16:base + 64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise DecodeError("unknown PCX mode")
    stride = (width * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    lines = _lines(data, base + 128, planes * stride, width, height)
    rows = np.frombuffer(b"".join(lines), np.uint8).reshape(height, -1)
    if mode == "1":
        return grey_rgb(np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255))
    if mode == "P;L":  # bit planes, each (width + 7) / 8 bytes apart (PIL's P;2L / P;4L)
        s = (width + 7) // 8
        idx = np.zeros((height, width), np.int64)
        for p in range(planes):
            idx |= np.unpackbits(rows[:, p * s:(p + 1) * s], axis=1)[:, :width].astype(np.int64) << p
        return palette[idx]
    if mode == "L":
        return grey_rgb(rows[:, :width])
    if mode == "P":
        return palette[rows[:, :width]]
    return np.stack([rows[:, c * width:(c + 1) * width] for c in range(3)], -1)


def dcx_rgb8(data: bytes) -> np.ndarray:
    """Intel DCX, as PIL's DcxImagePlugin reads it: the first of up to 1024
    frame offsets (a zero ends the table), a PCX image there."""
    if len(data) < 8 or not u32le(data, 4):
        raise DecodeError("DCX without frames")
    return rgb8(data, u32le(data, 4))
