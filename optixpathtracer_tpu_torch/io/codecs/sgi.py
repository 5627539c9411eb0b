"""SGI image files, as PIL's SgiImagePlugin reads them: 8 or 16 bits a
sample (16 keeps the high byte), grey, RGB and RGBA, raw (one plane after
another) or RLE (per-row offsets, runs of bytes or 16-bit words), rows
bottom-up."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, grey_rgb, need, u16be, u32be

_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1, (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4,
          (2, 3, 4): 4}


def _rle_row(data: bytes, pos: int, n: int, bpc: int) -> bytes:
    """One RLE row of n samples from `pos`: a count byte (or word), then
    that many literal samples (bit 7 set) or one sample repeated."""
    out = bytearray()
    while len(out) < n * bpc:
        if pos + bpc > len(data):
            raise DecodeError("truncated SGI RLE data")
        head = data[pos + bpc - 1]
        pos += bpc
        count = head & 0x7F
        if not count:
            break
        if head & 0x80:
            out += data[pos:pos + count * bpc]
            pos += count * bpc
        else:
            out += data[pos:pos + bpc] * count
            pos += bpc
    if len(out) != n * bpc:
        raise DecodeError("SGI RLE row of the wrong length")
    return bytes(out)


def rgb8(data: bytes) -> np.ndarray:
    need(data, 512, "SGI")
    compression, bpc, dim = data[2], data[3], u16be(data, 4)
    width, height, zsize = u16be(data, 6), u16be(data, 8), u16be(data, 10)
    if (bpc, dim, zsize) not in _MODES:
        raise DecodeError("Unsupported SGI image mode")
    bands = _MODES[(bpc, dim, zsize)]
    if compression == 0:
        n = width * height * bpc
        planes = []
        for z in range(bands):
            raw = data[512 + z * n:512 + (z + 1) * n]
            if len(raw) < n:
                raise DecodeError("truncated SGI image data")
            planes.append(np.frombuffer(raw, np.uint8).reshape(height, width * bpc))
    elif compression == 1:
        starts = [u32be(data, 512 + 4 * i) for i in range(height * zsize)]
        planes = [np.frombuffer(b"".join(_rle_row(data, starts[z * height + y], width, bpc)
                                         for y in range(height)), np.uint8).reshape(height, width * bpc)
                  for z in range(bands)]
    else:
        raise DecodeError(f"SGI compression {compression}")
    if bpc == 2:
        planes = [p[:, 0::2] for p in planes]  # the high byte of each big-endian sample
    img = np.stack(planes, -1)[::-1]  # rows are stored bottom-up
    return grey_rgb(img[..., 0]) if bands == 1 else np.ascontiguousarray(img[..., :3])
