"""Microsoft Paint (MSP), as PIL's MspImagePlugin reads it: a 32-byte
header whose 16-bit words XOR to zero; version 1 ("DanM") raw 1-bit rows,
version 2 ("LinS") a row map of byte counts, each row RLE (0 n v: n copies
of v; n > 0: n literal bytes), the rows' bytes joined and read as packed
1-bit rows (PIL does not pad a short row), an empty row white."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, need, raw_rows, u16le


def rgb8(data: bytes) -> np.ndarray:
    need(data, 32, "MSP")
    check = 0
    for i in range(0, 32, 2):
        check ^= u16le(data, i)
    if check:
        raise NotThisFormat("bad MSP checksum")
    width, height = u16le(data, 4), u16le(data, 6)
    stride = (width + 7) // 8
    if data.startswith(b"DanM"):
        rows = raw_rows(data, 32, height, stride, what="MSP")
    else:
        counts = data[32:32 + 2 * height]
        if len(counts) < 2 * height:
            raise DecodeError("Truncated MSP file in row map")
        pos = 32 + 2 * height
        out = bytearray()
        for y in range(height):
            n = u16le(counts, 2 * y)
            if n == 0:
                out += b"\xff" * stride
                continue
            row = data[pos:pos + n]
            pos += n
            if len(row) != n:
                raise DecodeError(f"Truncated MSP file, expected {n} bytes on row {y}")
            i = 0
            while i < n:
                t = row[i]
                i += 1
                if t == 0:
                    if i + 2 > n:
                        raise DecodeError(f"Corrupted MSP file in row {y}")
                    out += row[i + 1:i + 2] * row[i]
                    i += 2
                else:
                    out += row[i:i + t]
                    i += t
        if len(out) < stride * height:
            raise DecodeError("not enough image data")
        rows = np.frombuffer(bytes(out[:stride * height]), np.uint8).reshape(height, stride)
    return grey_rgb(np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255))
