"""Adobe Photoshop PSD, the composite image, as PIL's PsdImagePlugin reads
it: version 1, 8-bit grey, indexed (the 768-byte colour mode data as its
palette), RGB (RGBA with a fourth channel), CMYK (stored inverted), CIELAB
(converted as PIL converts its LAB mode: codecs/lab.py) and
1-bit bitmap, duotone and multichannel (the first channel, as grey); the
composite raw or PackBits-compressed (per-row byte counts, then each
channel's rows). The layers are skipped."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, cmyk_rgb, grey_rgb, need, packbits, u16be, u32be

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
          (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 26 or u16be(data, 4) != 1:
        raise NotThisFormat("not a PSD file")
    channels, height, width = u16be(data, 12), u32be(data, 14), u32be(data, 18)
    bits, mode_id = u16be(data, 22), u16be(data, 24)
    if (mode_id, bits) not in _MODES:
        raise DecodeError(f"PSD mode {mode_id} at {bits} bits, which PIL does not read")
    mode, n = _MODES[(mode_id, bits)]
    if n > channels:
        raise DecodeError("not enough PSD channels")
    pos = 26
    need(data, pos + 4, "PSD")
    size = u32be(data, pos)
    palette = None
    if mode == "P" and size == 768:
        palette = np.frombuffer(data[pos + 4:pos + 4 + 768], np.uint8).reshape(3, 256).T
    pos += 4 + size
    for _ in range(2):  # image resources, then layer and mask information
        need(data, pos + 4, "PSD")
        pos += 4 + u32be(data, pos)
    need(data, pos + 2, "PSD")
    compression = u16be(data, pos)
    pos += 2
    row = (width * bits + 7) // 8
    if compression == 0:
        n_bytes = row * height
        planes = []
        for c in range(n):  # PIL steps width * height bytes a channel, whatever the depth
            raw = data[pos + c * width * height:pos + c * width * height + n_bytes]
            if len(raw) < n_bytes:
                raise DecodeError("truncated PSD image data")
            planes.append(np.frombuffer(raw, np.uint8).reshape(height, row))
    elif compression == 1:
        counts = data[pos:pos + 2 * channels * height]
        pos += 2 * channels * height
        planes = []
        for c in range(n):
            rows = []
            p = pos
            for _ in range(height):
                r, p = packbits(data, p, row)
                if len(r) != row:
                    raise DecodeError("PSD PackBits row of the wrong length")
                rows.append(r)
            planes.append(np.frombuffer(b"".join(rows), np.uint8).reshape(height, row))
            pos += sum(u16be(counts, 2 * (c * height + y)) for y in range(height))
    else:
        raise DecodeError(f"PSD compression {compression}, which PIL does not read")
    if mode == "1":
        return grey_rgb(np.unpackbits(planes[0], axis=1)[:, :width] * np.uint8(255))
    if mode == "L" or (mode == "P" and palette is None):
        return grey_rgb(planes[0])
    if mode == "P":
        return palette[planes[0]]
    px = np.stack(planes, -1)
    if mode == "CMYK":
        return cmyk_rgb(255 - px.astype(np.int64))
    if mode == "LAB":  # each channel's bytes as they are: a* and b* offset by 128
        from .lab import lab_rgb

        return lab_rgb(px[..., :3])
    return np.ascontiguousarray(px[..., :3])
