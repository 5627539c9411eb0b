"""What every codec shares: the error classes and PIL's sample expansions."""
from __future__ import annotations

import numpy as np


class UnidentifiedImageError(ValueError, OSError):
    """Bytes that no reader takes: what PIL raises as its own
    `UnidentifiedImageError` (an OSError). A ValueError too, so callers that
    caught the decoders' ValueError still catch it."""


class DecodeError(ValueError, OSError):
    """Bytes of a known format that do not decode: truncated or corrupt data,
    where PIL raises an OSError."""


class NotThisFormat(Exception):
    """A header that does not parse as the format its magic suggested: the
    search goes on with the next format, as PIL's `Image.open` goes on after
    a plugin's SyntaxError."""


def unported(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} decoding is not ported (ROADMAP A.1)")


def u16le(data: bytes, pos: int) -> int:
    return data[pos] | data[pos + 1] << 8


def u32le(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 4], "little")


def u16be(data: bytes, pos: int) -> int:
    return data[pos] << 8 | data[pos + 1]


def u32be(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 4], "big")


def scale_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """`bits`-bit values onto 0-255 as PIL's unpackers scale them:
    v * 255 / (2^bits - 1), truncated."""
    return (v.astype(np.int64) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def unpack_bits(rows: np.ndarray, width: int, bits: int) -> np.ndarray:
    """(h, stride) bytes of MSB-first packed `bits`-bit samples -> (h, width)
    uint8 values."""
    if bits == 8:
        return rows[:, :width]
    per = 8 // bits
    shifts = (8 - bits - bits * np.arange(per)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width].astype(np.uint8)


def packbits(src: bytes, pos: int, n: int) -> tuple[bytes, int]:
    """PackBits from src[pos] until n bytes are out or the data ends: a
    count c < 128 copies c + 1 bytes, c > 128 repeats the next byte 257 - c
    times, 128 is a no-op. -> (the bytes, possibly past n; the position
    after them)."""
    out = bytearray()
    end = len(src)
    while len(out) < n and pos < end:
        c = src[pos]
        if c < 128:
            out += src[pos + 1:pos + 2 + c]
            pos += 2 + c
        elif c > 128:
            out += src[pos + 1:pos + 2] * (257 - c)
            pos += 2
        else:
            pos += 1
    return bytes(out), pos


def grey_rgb(grey: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(grey, np.uint8)[..., None], 3, axis=-1)


def cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB (Convert.c cmyk2rgb): each channel
    255 - k - c * (255 - k) / 255, the product rounded as MULDIV255."""
    x = np.asarray(cmyk, np.int64)
    nk = 255 - x[..., 3:4]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def need(data: bytes, end: int, what: str) -> None:
    if len(data) < end:
        raise DecodeError(f"truncated {what} image")


def raw_rows(data: bytes, pos: int, height: int, row_bytes: int, stride: int | None = None,
             what: str = "image") -> np.ndarray:
    """`height` rows of `row_bytes` bytes from data[pos], each `stride`
    bytes apart (default: packed), as PIL's raw decoder reads them: the
    last row needs no padding after it; fewer bytes raise DecodeError, as
    PIL's "image file is truncated"."""
    stride = row_bytes if stride is None else stride
    end = pos + (height - 1) * stride + row_bytes if height else pos
    if len(data) < end or pos < 0:
        raise DecodeError(f"truncated {what} image data")
    buf = np.frombuffer(data[pos:pos + height * stride].ljust(height * stride, b"\0"), np.uint8)
    return buf.reshape(height, stride)[:, :row_bytes]


def pil_palette(colours: np.ndarray) -> np.ndarray:
    """A palette of n <= 256 RGB entries as PIL converts it to RGB: the
    entries past n black."""
    pal = np.zeros((256, 3), np.uint8)
    colours = np.asarray(colours, np.uint8).reshape(-1, 3)[:256]
    pal[:len(colours)] = colours
    return pal


def float_l(f: np.ndarray) -> np.ndarray:
    """PIL's F -> L (then RGB): clipped into 0-255, then truncated toward
    zero (Convert.c f2l via CLIP8); NaN 0."""
    with np.errstate(invalid="ignore"):
        g = np.where(f <= 0, 0, np.where(f >= 255, 255, f))
    return np.nan_to_num(g, nan=0).astype(np.int64).astype(np.uint8)
