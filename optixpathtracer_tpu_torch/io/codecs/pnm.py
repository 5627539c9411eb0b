"""Netpbm P1-P6 and greyscale PFM (Pf), as PIL's PpmImagePlugin reads them.

Header comments, any whitespace, maxval 1-65535: samples are scaled by
round(v / maxval * 255) (Python's rounding, half to even), 16-bit grey
opens as PIL's mode I (scaled to 65535, or raw at maxval 65535) and clamps
to 255 on the way to RGB; plain (ASCII) forms as PIL's plain decoder reads
them; PIL's own test modes P0CMYK / PyCMYK (CMYK), PyRGBA and PyP (a
palette image without a palette: black). P7 (PAM) is not a format PIL
reads."""
from __future__ import annotations

import re

import numpy as np

from ._common import DecodeError, NotThisFormat, cmyk_rgb, float_l, grey_rgb

_WS = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int = 1) -> bytes:
        s = self.data[self.pos:self.pos + n]
        self.pos += len(s)
        return s

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.read()
            if not c or c in _WS:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        """PpmImageFile._read_token: up to 10 characters after whitespace and
        comments (to CR, LF or the end)."""
        token = b""
        while len(token) <= 10:
            c = self.read()
            if not c:
                break
            if c in _WS:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise DecodeError("Reached EOF while reading header")
        if len(token) > 10:
            raise DecodeError("Token too long in file header")
        return token


def _strip_comments(block: bytes) -> bytes:
    """PpmPlainDecoder._ignore_comments on one block: '#' to the first CR or
    LF (or the end) removed."""
    while True:
        start = block.find(b"#")
        if start < 0:
            return block
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        end = min(a, b) if a * b > 0 else max(a, b)
        if end < 0:
            return block[:start]
        block = block[:start] + block[end + 1:]


def _plain(body: bytes, n: int, bitonal: bool, maxval: int, out_max: int) -> np.ndarray:
    """The plain formats' first n samples (fewer if the data ends)."""
    block = _strip_comments(body)
    if bitonal:
        tokens = b"".join(block.split())
        bad = re.search(rb"[^01]", tokens[:n])
        if bad:
            raise DecodeError(f"Invalid token for this mode: {bad.group()!r}")
        return np.frombuffer(tokens[:n], np.uint8)
    vals = []
    for token in block.split()[:n]:
        if len(token) > 10:
            raise DecodeError("Token too long found in data")
        v = int(token)
        if v < 0 or v > maxval:
            raise DecodeError(f"Channel value out of range: {v}")
        vals.append(round(v / maxval * out_max))
    return np.array(vals, np.int64)


def rgb8(data: bytes) -> np.ndarray:
    r = _Reader(data)
    magic = r.magic()
    if magic not in _MODES:
        raise NotThisFormat("not a PPM file")
    mode = _MODES[magic]
    width, height = int(r.token()), int(r.token())
    if mode == "F":
        scale = float(r.token())
        if scale == 0.0 or not np.isfinite(scale):
            raise DecodeError("scale must be finite and non-zero")
        n = width * height
        raw = data[r.pos:r.pos + 4 * n]
        if len(raw) < 4 * n:
            raise DecodeError("truncated PFM image")
        f = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(height, width)[::-1]
        return grey_rgb(float_l(f))
    plain = magic in (b"P1", b"P2", b"P3")
    bands = {"RGB": 3, "CMYK": 4, "RGBA": 4}.get(mode, 1)
    n = width * height * bands
    if mode == "1":
        if plain:
            v = _plain(data[r.pos:], n, True, 1, 1)
            if len(v) < n:
                raise DecodeError("truncated PBM image")
            px = np.where(v == ord("1"), 0, 255).astype(np.uint8)
        else:
            stride = (width + 7) // 8
            raw = data[r.pos:r.pos + stride * height]
            if len(raw) < stride * height:
                raise DecodeError("truncated PBM image")
            bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(height, stride), axis=1)
            px = np.where(bits[:, :width] == 1, 0, 255).astype(np.uint8)
        return grey_rgb(px.reshape(height, width))
    maxval = int(r.token())
    if not 0 < maxval < 65536:
        raise DecodeError("maxval must be greater than 0 and less than 65536")
    wide = maxval > 255 and mode == "L"  # PIL's mode I
    out_max = 65535 if wide else 255
    if plain:
        v = _plain(data[r.pos:], n, False, maxval, out_max)
        if len(v) < n:
            raise DecodeError("truncated plain Netpbm image")
    else:
        size = 1 if maxval < 256 else 2
        raw = data[r.pos:r.pos + size * n]
        if len(raw) < size * n:
            raise DecodeError("truncated Netpbm image")
        v = np.frombuffer(raw, np.uint8 if size == 1 else ">u2").astype(np.int64)
        if not (maxval == 255 or (maxval == 65535 and mode == "L")):
            # PpmDecoder: min(out_max, round(v / maxval * out_max)) per sample
            v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(np.int64)
    px = np.minimum(v, 255).astype(np.uint8)  # mode I clamps on the way to RGB
    if mode == "L":
        return grey_rgb(px.reshape(height, width))
    if mode == "P":  # PIL's test mode PyP: a palette image without a palette, black
        return np.zeros((height, width, 3), np.uint8)
    px = px.reshape(height, width, bands)
    return cmyk_rgb(px) if mode == "CMYK" else np.ascontiguousarray(px[..., :3])
