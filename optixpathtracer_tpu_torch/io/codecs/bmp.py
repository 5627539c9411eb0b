"""Windows BMP and DIB, as PIL's BmpImagePlugin reads them.

Header sizes 12 (OS/2) and 40/52/56/64/108/124; 1, 4, 8, 16, 24 and 32 bits;
BI_RGB, BI_RLE8, BI_RLE4 (PIL's own RLE decoder, quirks included) and
BI_BITFIELDS with the masks PIL takes (5-6-5, 5-5-5, 8-8-8 and the 8-8-8-8
orders); bottom-up or top-down (negative height); palettes of any length
(entries past it black), and a palette of 2 or 2^bits grey entries read as
PIL reads it, as bits or grey bytes. `bitmap` also serves ICO and CUR
entries."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, grey_rgb, need, scale_bits, u16le, u32le, unpack_bits

_BIT2RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_MASK_RAW = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> bytes:
    """BmpRleDecoder, as PIL writes it: a delta escape reads four bytes
    (the offsets are the last two), absolute runs pad to an even file
    offset, and decoding stops at end of bitmap or of the data."""
    out = bytearray()
    x = 0
    total = width * height
    n = len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            right, up = data[pos:pos + 2]
            if len(data[pos:pos + 2]) < 2:
                raise DecodeError("truncated BMP RLE delta")
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            if rle4:
                chunk = data[pos:pos + byte // 2]
                pos += byte // 2
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
                if len(chunk) < byte // 2:
                    break
            else:
                chunk = data[pos:pos + byte]
                pos += byte
                out += chunk
                if len(chunk) < byte:
                    break
            x += byte
            if pos % 2:
                pos += 1
    return bytes(out)


def _unpack(rows: np.ndarray, width: int, raw: str) -> np.ndarray:
    """(h, >= bytes a row needs) raw bytes -> (h, width) indices / grey or
    (h, width, 3) RGB."""
    h = rows.shape[0]
    if raw in ("1", "P;1", "P;4"):
        vals = unpack_bits(rows, width, 4 if raw == "P;4" else 1)
        return vals * np.uint8(255) if raw == "1" else vals
    if raw in ("L", "P"):
        return rows[:, :width]
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].reshape(h, width, 2).astype(np.int64)
        v = v[..., 0] | v[..., 1] << 8
        if raw == "BGR;15":
            return np.stack([scale_bits((v >> s) & 31, 5) for s in (10, 5, 0)], -1)
        return np.stack([scale_bits(v >> 11 & 31, 5), scale_bits(v >> 5 & 63, 6), scale_bits(v & 31, 5)], -1)
    n = len(raw)
    px = rows[:, :n * width].reshape(h, width, n)
    return px[..., [raw.index(c) for c in "RGB"]]


def bitmap(data: bytes, header: int, offset: int, height_div: int = 1) -> np.ndarray:
    """The DIB whose header starts at `header` -> (H, W, 3) uint8. `offset`
    is the pixel data's file offset (0: right after the palette);
    `height_div` divides the height (2 for an icon's XOR + AND masks)."""
    need(data, header + 4, "BMP")
    size = u32le(data, header)
    h_data = data[header + 4:header + size]
    need(data, header + size, "BMP")
    pos = header + size
    masks = None
    if size == 12:
        width, height = u16le(h_data, 0), u16le(h_data, 2)
        bits = u16le(h_data, 6)
        compression, colors, padding, direction = 0, 0, 3, -1
    elif size in (40, 52, 56, 64, 108, 124):
        flip = h_data[7] == 0xFF
        direction = 1 if flip else -1
        width = u32le(h_data, 0)
        height = u32le(h_data, 4)
        if flip:
            height = 2 ** 32 - height
        bits = u16le(h_data, 10)
        compression = u32le(h_data, 12)
        colors = u32le(h_data, 28)
        padding = 4
        if compression == 3:
            if len(h_data) >= 48:
                n = 4 if len(h_data) >= 52 else 3
                masks = [u32le(h_data, 36 + 4 * i) for i in range(n)] + [0] * (4 - n)
            else:
                need(data, pos + 12, "BMP")
                masks = [u32le(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        raise DecodeError(f"Unsupported BMP header type ({size})")
    height //= height_div
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2RAW:
        raise DecodeError(f"Unsupported BMP pixel depth ({bits})")
    raw = _BIT2RAW[bits]
    if compression == 3:
        key = (bits, tuple(masks if bits == 32 else masks[:3]))
        if key not in _MASK_RAW:
            raise DecodeError("Unsupported BMP bitfields layout")
        raw = _MASK_RAW[key]
    elif compression not in (0, 1, 2):
        raise DecodeError(f"Unsupported BMP compression ({compression})")
    mode = "P" if bits <= 8 else "RGB"
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise DecodeError(f"Unsupported BMP Palette size ({colors})")
        pal = data[pos:pos + padding * colors]
        pos += padding * colors
        entries = np.frombuffer(pal[:len(pal) // padding * padding], np.uint8).reshape(-1, padding)
        grey_vals = (0, 255) if colors == 2 else range(colors)
        grey = len(entries) >= min(colors, len(grey_vals)) and all(
            bytes(entries[i, :3]) == bytes([v & 255]) * 3 for i, v in enumerate(grey_vals))
        if grey:
            mode = raw = "1" if colors == 2 else "L"
        else:
            if colors > 256:
                raise DecodeError("invalid palette size")
            palette = np.zeros((256, 3), np.uint8)  # entries past the palette read black
            palette[:len(entries)] = entries[:, 2::-1]
    if width <= 0 or height <= 0:
        raise DecodeError(f"BMP of size {width}x{height}")
    start = offset or pos
    if compression in (1, 2):
        if mode == "1":
            raise DecodeError("BMP RLE on a two-colour grey palette")
        px = _rle(data, start, width, height, compression == 2)
        if len(px) < width * height:
            raise DecodeError("not enough BMP image data")
        flat = np.frombuffer(px, np.uint8, width * height).reshape(height, width)
        idx = flat
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        row_bytes = (width * _RAW_BITS.get(raw, 8 * len(raw)) + 7) // 8
        if row_bytes > stride:
            raise DecodeError("BMP rows shorter than their pixels")
        need(data, start + stride * height, "BMP")
        rows = np.frombuffer(data, np.uint8, stride * height, start).reshape(height, stride)
        idx = _unpack(rows, width, raw)
    if direction == -1:
        idx = idx[::-1]
    if mode == "P":
        img = palette[idx]
    elif mode in ("1", "L"):
        img = grey_rgb(idx)
    else:
        img = idx
    return np.ascontiguousarray(img)


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 14:
        raise NotThisFormat("BMP header")
    return bitmap(data, 14, u32le(data, 10))


def dib_rgb8(data: bytes) -> np.ndarray:
    return bitmap(data, 0, 0)
