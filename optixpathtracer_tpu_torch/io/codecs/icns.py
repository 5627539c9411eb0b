"""Apple icon images (ICNS), as PIL's IcnsImagePlugin reads them: the
largest (width, height, scale) any entry gives; its PNG entry (decoded by
io/image.py), or else its 24-bit entry, raw or in the icon RLE (n < 128:
n + 1 literal bytes; n >= 128: n - 125 copies of the next byte, the red,
green and blue planes one after the other; it32 after four zero bytes).
A JPEG 2000 entry decodes through codecs/jp2.py, its bytes read alone."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, need, u32be

# PIL's IcnsFile.SIZES: (width, height, scale) -> its entries in reading order
_SIZES = {
    (512, 512, 2): [b"ic10"], (512, 512, 1): [b"ic09"], (256, 256, 2): [b"ic14"], (256, 256, 1): [b"ic08"],
    (128, 128, 2): [b"ic13"], (128, 128, 1): [b"ic07", b"it32", b"t8mk"], (64, 64, 1): [b"icp6"],
    (32, 32, 2): [b"ic12"], (48, 48, 1): [b"ih32", b"h8mk"], (32, 32, 1): [b"icp5", b"il32", b"l8mk"],
    (16, 16, 2): [b"ic11"], (16, 16, 1): [b"icp4", b"is32", b"s8mk"]}
_RGB = (b"it32", b"ih32", b"il32", b"is32")
_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")


def _rgb24(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise DecodeError("truncated ICNS entry")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3).copy()
    planes = []
    pos = start
    for _ in range(3):
        out = bytearray()
        left = n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                k = b - 125
                out += data[pos:pos + 1] * k
                pos += 1
            else:
                k = b + 1
                out += data[pos:pos + k]
                pos += k
            left -= k
        if left != 0:
            raise DecodeError(f"Error reading channel [{left!r} left]")
        if len(out) < n:
            raise DecodeError("not enough image data")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8).reshape(side, side))
    return np.stack(planes, -1)


def rgb8(data: bytes) -> np.ndarray:
    need(data, 8, "ICNS")
    size = u32be(data, 4)
    entries = {}
    i = 8
    while i < size:
        if i + 8 > len(data):
            raise NotThisFormat("truncated ICNS block header")
        sig, block = data[i:i + 4], u32be(data, i + 4)
        if block <= 0:
            raise NotThisFormat("invalid block header")
        entries[sig] = (i + 8, block - 8)
        i += block
    sizes = [s for s, codes in _SIZES.items() if any(c in entries for c in codes)]
    if not sizes:
        raise NotThisFormat("No 32bit icon resources found")
    best = max(sizes)
    side = best[0] * best[2]
    rgb = None
    for code in _SIZES[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if code in _MASKS:
            continue  # alpha, which convert("RGB") drops
        if code in _RGB:
            if code == b"it32":
                if data[start:start + 4] != bytes(4):
                    raise DecodeError("Unknown signature, expecting 0x00000000")
                start, length = start + 4, length - 4
            got = _rgb24(data, start, length, side)
            rgb = got if rgb is None else rgb
            continue
        sig = data[start:start + 12]
        if sig.startswith(b"\x89PNG\r\n\x1a\n"):
            from ..image import rgb8_from_png

            return rgb8_from_png(data[start:])  # PIL reads the PNG from the entry on, to its IEND
        if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
            from . import jp2

            try:  # PIL reads the entry's bytes as a JPEG 2000 file of their own
                return jp2.rgb8(data[start:start + length])
            except NotThisFormat as e:
                raise DecodeError(f"ICNS JPEG 2000 entry PIL cannot open: {e}") from e
        raise DecodeError("Unsupported icon subimage format")
    if rgb is None:
        raise DecodeError("ICNS size with a mask and no colour")
    return rgb
