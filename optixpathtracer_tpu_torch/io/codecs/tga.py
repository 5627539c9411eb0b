"""Truevision TGA, as PIL's TgaImagePlugin reads it.

Image types 1 (colour-mapped), 2 (true colour) and 3 (grey) and their RLE
forms 9/10/11; 8-bit maps and grey, 16-bit (5-5-5, each channel scaled
by 255/31), 24- and 32-bit BGR(A) colour; colour maps of 16, 24 and 32 bits
(entries below the map's first index black); the image-ID field; the
origin bits (bottom-up unless bit 5, mirrored if bit 4). The format has no
magic number: the header is tried as PIL tries it, after every format with
one. What PIL opens but cannot load (32-bit maps, maps past 256 entries,
type 1 without a map, 1-bit RLE, 16-bit colour maps on 16-bit images)
raises DecodeError."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, need, scale_bits, u16le


def _bgr15(px: np.ndarray) -> np.ndarray:
    """(..., 2) little-endian 5-5-5 bytes -> (..., 3) RGB (PIL's BGRA;15Z)."""
    v = px[..., 0].astype(np.int64) | px[..., 1].astype(np.int64) << 8
    return np.stack([scale_bits((v >> s) & 31, 5) for s in (10, 5, 0)], -1)


def _rle(data: bytes, pos: int, n_bytes: int, size: int) -> np.ndarray:
    """TgaRleDecode: packets of 1-128 pixels of `size` bytes, a run (bit 7)
    or literals, over the whole image (a packet may cross a scanline)."""
    out = bytearray()
    while len(out) < n_bytes:
        if pos >= len(data):
            raise DecodeError("truncated TGA image")
        head = data[pos]
        n = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos + 1:pos + 1 + size]
            pos += 1 + size
            out += px * n
        else:
            px = data[pos + 1:pos + 1 + n * size]
            pos += 1 + n * size
            out += px
        if len(px) < size or (not head & 0x80 and len(px) < n * size):
            raise DecodeError("truncated TGA image")
    if len(out) > n_bytes:
        raise DecodeError("TGA RLE data overruns the image")
    return np.frombuffer(bytes(out), np.uint8)


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 18:
        raise NotThisFormat("TGA header")
    id_len, cmap_type, kind = data[0], data[1], data[2]
    width, height = u16le(data, 12), u16le(data, 14)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if kind not in (1, 2, 3, 9, 10, 11):
        raise NotThisFormat("unknown TGA mode")
    orientation = flags & 0x30
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, map_depth = u16le(data, 3), u16le(data, 5), data[7]
        if map_depth not in (16, 24, 32):
            raise NotThisFormat("unknown TGA map depth")
        if map_depth == 32 or start + size > 256 or kind & 7 == 2:
            # PIL fails these maps: no BGRA palette unpacker, more than 256
            # entries, a palette on a true-colour image
            raise DecodeError(f"TGA colour map of {map_depth} bits, {start}+{size} entries, type {kind}")
        nb = map_depth // 8
        raw = np.frombuffer(data[pos:pos + nb * size], np.uint8)
        pos += nb * size
        entries = raw[:len(raw) // nb * nb].reshape(-1, nb)
        palette = np.zeros((256, 3), np.uint8)  # what the map leaves out reads black
        cols = _bgr15(entries) if nb == 2 else entries[:, 2::-1]
        cols = cols[:max(0, 256 - start)]
        palette[start:start + len(cols)] = cols
    base = kind & 7
    mode = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "15", (2, 24): "BGR",
            (2, 32): "BGRA"}.get((base, depth))
    if mode is None or (mode == "P" and not cmap_type) or (mode == "1" and kind & 8):
        # PIL opens the header but has no unpacker for it (or, for RLE at one
        # bit, runs out of data)
        raise DecodeError(f"cannot decode TGA image type {kind} at {depth} bits")
    size = max(1, depth // 8)
    stride = (width * depth + 7) // 8
    n_bytes = stride * height
    if kind & 8:
        flat = _rle(data, pos, n_bytes, size)
    else:
        need(data, pos + n_bytes, "TGA")
        flat = np.frombuffer(data, np.uint8, n_bytes, pos)
    rows = flat.reshape(height, stride)
    if orientation in (0, 0x10):  # bottom-up
        rows = rows[::-1]
    if mode == "1":
        img = grey_rgb(np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255))
    elif mode == "L":
        img = grey_rgb(rows)
    elif mode == "LA":  # under a colour map PIL looks the grey up in it
        img = palette[rows[:, 0::2]] if cmap_type else grey_rgb(rows[:, 0::2])
    elif mode == "P":
        img = palette[rows]
    elif mode == "15":
        img = _bgr15(rows.reshape(height, width, 2))
    else:
        img = rows.reshape(height, width, size)[..., 2::-1]
    if orientation in (0x10, 0x30):
        img = img[:, ::-1]
    return np.ascontiguousarray(img)
