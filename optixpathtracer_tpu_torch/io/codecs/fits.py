"""FITS, as PIL's FitsImagePlugin reads it: 80-byte header cards in 2880-
byte blocks, the first HDU with NAXIS > 0 (a later one when the first has
none); BITPIX 8 (grey), 16 and 32 (read, as PIL reads them, little-endian
whatever FITS says: mode I;16 and I clamped into 0-255), -32 and -64 (four
bytes a pixel read as a little-endian float, F -> L); rows bottom-up.
A tile-compressed image (BINTABLE, ZIMAGE, GZIP_1) is PIL's gzip stream of
4-byte big-endian pixels, their low bytes read as above, rows flipped."""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from ._common import DecodeError, NotThisFormat, float_l, grey_rgb, raw_rows


def _size(h: dict, prefix: bytes):
    naxis = int(h[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(h[prefix + b"NAXIS1"])
    return int(h[prefix + b"NAXIS1"]), int(h[prefix + b"NAXIS2"])


def _parse(h: dict):
    prefix, kind, offset = b"", "raw", 0
    if h.get(b"XTENSION") == b"'BINTABLE'" and h.get(b"ZIMAGE") == b"T" and h[b"ZCMPTYPE"] == b"'GZIP_1  '":
        w, ht = _size(h, prefix) or (0, 0)
        offset = w * ht * (int(h[b"BITPIX"]) // 8)
        prefix, kind = b"Z", "gzip"
    size = _size(h, prefix)
    if not size:
        return None
    bits = int(h[prefix + b"BITPIX"])
    if bits not in (8, 16, 32, -32, -64):
        raise DecodeError(f"FITS BITPIX {bits}, which PIL gives no mode")
    return kind, offset, size, bits


def _pixels(flat: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """Little-endian samples of PIL's mode for `bits` -> RGB, rows as given."""
    if bits == 8:
        return grey_rgb(raw_rows(flat, 0, height, width, what="FITS"))
    n = 2 if bits == 16 else 4
    rows = raw_rows(flat, 0, height, n * width, what="FITS").copy()
    if bits == 16:
        v = rows.view("<u2").astype(np.int64)
    elif bits == 32:
        v = rows.view("<i4").astype(np.int64)
    else:
        return grey_rgb(float_l(rows.view("<f4")))
    return grey_rgb(np.clip(v, 0, 255).astype(np.uint8))


def rgb8(data: bytes) -> np.ndarray:
    headers: dict = {}
    in_header = False
    found = None
    pos = 0
    while True:
        card = data[pos:pos + 80]
        pos += 80
        if not card:
            raise DecodeError("Truncated FITS file")
        key = card[:8].strip()
        if key in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif key == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                try:
                    found = _parse(headers)
                except (KeyError, ValueError) as e:
                    raise DecodeError(f"FITS header: {e!r}") from e
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not key.startswith(b"SIMPLE") or value != b"T"):
            raise NotThisFormat("Not a FITS file")
        headers[key] = value
    if not found:
        raise DecodeError("No image data")
    kind, offset, (width, height), bits = found
    start = offset + pos - 80
    if kind == "raw":
        n = {8: 1, 16: 2, 32: 4}.get(bits, 4)
        rows = raw_rows(data, start, height, n * width, what="FITS")
        return np.ascontiguousarray(_pixels(rows.tobytes(), width, height, bits)[::-1])
    try:
        value = gzip.decompress(data[start:])
    except (OSError, EOFError, zlib.error) as e:
        raise DecodeError(f"FITS gzip tile data: {e!r}") from e
    if bits < 0:  # PIL takes value[offset + 8:offset + 4] of each word: nothing
        raise DecodeError("not enough image data")
    n = min(bits // 8, 4)
    words = np.frombuffer(value[:4 * width * height].ljust(4 * width * height, b"\0"), np.uint8)
    if len(value) < 4 * width * height:
        raise DecodeError("not enough image data")
    px = words.reshape(height, width, 4)[..., 4 - n:]
    return _pixels(np.ascontiguousarray(px[::-1]).tobytes(), width, height, bits)
