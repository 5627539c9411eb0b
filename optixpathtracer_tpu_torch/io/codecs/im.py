"""IFUNC Image Memory (IM), as PIL's ImImagePlugin reads it: "key: value"
header lines up to a NUL or ^Z (the size, the image type), an optional
768-byte Lut (a colour one turns grey types into palette ones; a grey one
is ignored), then the first frame's rows bottom-up: 1-bit, grey, B2 / B4
palettes, RGB interleaved ("X 24"), line-interleaved planes (RGB, RGBA,
RGBX, CMYK, YCC, LA, PA), RGB3 / RYB3 plane after plane (G, R, B), 16-bit
(I;16 clamped as PIL converts it) and 32-bit integers, the integer and
float samples PIL reads as mode F (F -> L), "L*N" images of N bits a pixel
(PIL's bit decoder); a palette type without a colour Lut is black."""
from __future__ import annotations

import re

import numpy as np

from ._common import DecodeError, NotThisFormat, cmyk_rgb, float_l, grey_rgb, pil_palette, unpack_bits

_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"),
    "B1 image": ("1", "1"), "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
    "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    _OPEN[f"L {_i} image"] = _OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_OPEN["L 32S image"] = _OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name",
         "Scale (x,y)", "Image size (x*y)", "Image type")
# raw mode -> (bytes a sample, numpy type) of the samples PIL reads as I, I;16 or F
_SAMPLES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4", "I;32S": "<i4", "F;8": "u1",
            "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<i4", "F;32F": "<f4"}
_PLANES = {"RGB;L": 3, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4, "YCbCr;L": 3, "LA;L": 2, "PA;L": 2}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(data: bytes):
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    raw = "L"
    n = 0
    pos = 0
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise NotThisFormat("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            except ValueError as e:
                raise DecodeError(f"IM header value {v!r}") from e
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _OPEN:
            v, raw = _OPEN[v]
        info[k] = v
        n += k in _TAGS
    if not n:
        raise NotThisFormat("Not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += 1
    if not s:
        raise NotThisFormat("File truncated")
    return info, raw, pos


def rgb8(data: bytes) -> np.ndarray:
    info, raw, pos = _header(data)
    mode, size = info["Image type"], info["Image size (x*y)"]
    if not isinstance(size, tuple) or len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise DecodeError(f"IM image size {size!r}")
    width, height = size
    palette = None
    if "Lut" in info:
        lut = data[pos:pos + 768]
        pos += 768
        if len(lut) < 768:
            raise NotThisFormat("truncated IM Lut")
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((p[0] == p[1]).all() and (p[0] == p[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode = "P" if mode in ("L", "P") else "PA"
            raw = "P" if mode == "P" else "PA;L"
            palette = pil_palette(p.T)
    if mode not in ("1", "L", "P", "LA", "PA", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F", "I;16", "I;16L",
                    "I;16B"):
        raise DecodeError(f"IM image type {mode!r}, no mode PIL has")
    if raw == "RLB":
        raise DecodeError("unknown raw mode for given image mode")
    if mode == "P" and palette is None:  # a palette image without a palette converts to black
        palette = np.zeros((256, 3), np.uint8)
    if raw.startswith("F;") and raw not in _SAMPLES:
        return grey_rgb(float_l(_bits(data[pos:], int(raw[2:]), width, height)))

    def rows(row_bytes: int, at: int = pos) -> np.ndarray:
        n = row_bytes * height
        if len(data) < at + n:
            raise DecodeError("truncated IM image data")
        return np.frombuffer(data[at:at + n], np.uint8).reshape(height, row_bytes)[::-1]

    if raw in ("RGB;T", "RYB;T"):  # whole planes: G, then R, then B
        n = width * height
        g, r, b = (rows(width, pos + i * n) for i in range(3))
        return np.stack([r, g, b], -1)
    if raw == "1":
        return grey_rgb(unpack_bits(rows((width + 7) // 8), width, 1) * np.uint8(255))
    if raw in ("P;2", "P;4"):
        bits = int(raw[2])
        return palette[unpack_bits(rows((width * bits + 7) // 8), width, bits)]
    if raw in ("L", "P"):
        v = rows(width)
        return grey_rgb(v) if mode == "L" else palette[v]
    if raw == "RGB":
        return rows(3 * width).reshape(height, width, 3).copy()
    if raw in _PLANES:
        k = _PLANES[raw]
        px = rows(k * width).reshape(height, k, width).transpose(0, 2, 1)
        if raw == "LA;L":
            return grey_rgb(px[..., 0])
        if raw == "PA;L":
            return palette[px[..., 0]]
        if raw == "CMYK;L":
            return cmyk_rgb(px)
        if raw == "YCbCr;L":
            return ycbcr_rgb(px)
        return np.ascontiguousarray(px[..., :3])
    dt = np.dtype(_SAMPLES[raw])
    v = rows(dt.itemsize * width).copy().view(dt).reshape(height, width)
    if mode == "F":
        return grey_rgb(float_l(v.astype(np.float32)))
    return grey_rgb(np.clip(v.astype(np.int64), 0, 255).astype(np.uint8))


def _bits(data: bytes, bits: int, width: int, height: int) -> np.ndarray:
    """PIL's bit decoder as IM's "L*N" images use it (BitDecode.c, fill 3,
    padded lines, unsigned): `bits` a pixel, least significant bits first,
    rows bottom-up; at each line's end the bit count restarts while the
    bits left in the buffer stay, to be ORed with the next bytes."""
    if not 1 <= bits < 32:
        raise DecodeError(f"IM of {bits} bits a pixel")
    mask = (1 << bits) - 1
    out = np.zeros((height, width), np.float32)
    buffer, count, x, y = 0, 0, 0, height - 1
    for byte in data:
        buffer |= byte << count
        count += 8
        while count >= bits:
            value = buffer & mask
            if count > 32:  # PIL's 32-bit buffer overflowed: restored from the last byte
                buffer = byte >> (8 - (count - bits))
            else:
                buffer >>= bits
            count -= bits
            out[y, x] = value
            x += 1
            if x >= width:
                y -= 1
                if y < 0:
                    return out
                x, count = 0, 0
    raise DecodeError("truncated IM image data")


def ycbcr_rgb(px: np.ndarray) -> np.ndarray:
    """PIL's YCbCr -> RGB: fixed-point tables at 6 bits, each entry
    (int)(k * 64 * (c - 128) + 0.5) as C truncates it."""
    y, cb, cr = (px[..., i].astype(np.int64) for i in range(3))
    r = y + (_R_CR[cr] >> 6)
    g = y + ((_G_CB[cb] + _G_CR[cr]) >> 6)
    b = y + (_B_CB[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_C = 64 * (np.arange(256) - 128)
_R_CR, _G_CB, _G_CR, _B_CB = (np.trunc(k * _C + 0.5).astype(np.int64) for k in (1.402, -0.34414, -0.71414, 1.772))
