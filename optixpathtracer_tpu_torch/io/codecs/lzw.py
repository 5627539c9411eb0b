"""LZW, the variants the ported formats use.

GIF: codes LSB first, starting at min_code_size + 1 bits, clear = 2^min and
end = clear + 1, the width growing once the next free code reaches 2^width
(up to 12 bits, then no new entries until a clear). TIFF: codes MSB first
from 9 bits, clear 256, end 257, the width growing one code early (the
"early change" libtiff and every TIFF writer use); the old-style TIFF
codes LSB first, growing as GIF's do. All are sequential:
a Python loop over 24-bit windows of the code stream, strings built by
concatenation."""
from __future__ import annotations

from ._common import DecodeError


def _run(data: bytes, min_size: int, limit: int, msb: bool, early: int) -> bytes:
    clear = 1 << min_size
    end = clear + 1
    buf = data + bytes(4)
    n_bits = 8 * len(data)
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = min_size + 1
    pos = 0
    out = bytearray()
    prev = b""
    while len(out) < limit:
        if pos + size > n_bits:
            break  # the data ended without an end code
        i = pos >> 3
        if msb:
            code = ((buf[i] << 16 | buf[i + 1] << 8 | buf[i + 2]) >> (24 - (pos & 7) - size)) & ((1 << size) - 1)
        else:
            code = ((buf[i] | buf[i + 1] << 8 | buf[i + 2] << 16) >> (pos & 7)) & ((1 << size) - 1)
        pos += size
        if code == clear:
            table = list(base)
            size = min_size + 1
            prev = b""
            continue
        if code == end:
            break
        n = len(table)
        if not prev:
            if code >= n:
                raise DecodeError("corrupt LZW data: code past the table")
            entry = table[code]
        elif code < n:
            entry = table[code]
            if n < 4096:
                table.append(prev + entry[:1])
        elif code == n:
            entry = prev + prev[:1]
            if n < 4096:
                table.append(entry)
        else:
            raise DecodeError("corrupt LZW data: code past the table")
        out += entry
        prev = entry
        if len(table) + early >= 1 << size and size < 12:
            size += 1
    return bytes(out)


def gif_decode(data: bytes, min_size: int, limit: int) -> bytes:
    """GIF LZW (the sub-blocks already joined) -> at most `limit` indices
    (more if the last string runs past; fewer if the data ends early)."""
    if not 1 <= min_size <= 11:
        raise DecodeError(f"GIF LZW minimum code size {min_size}")
    return _run(data, min_size, limit, msb=False, early=0)


def tiff_decode(data: bytes, limit: int) -> bytes:
    """TIFF LZW (compression 5) -> the strip's bytes (at most about `limit`)."""
    return _run(data, 8, limit, msb=True, early=1)


def tiff_old_decode(data: bytes, limit: int) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat, told by a first code
    of 256 written LSB first): codes LSB first from 9 bits, the width
    growing as GIF's does."""
    return _run(data, 8, limit, msb=False, early=0)
