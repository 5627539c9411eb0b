"""Image IO: PNG read-write, the Radiance .hdr loader and PFM (port of
optixpathtracer_tpu/io/image.py).

The reference decodes and encodes PNG through PIL. The port has its own
PNG codec written with `zlib` and `struct`, so it needs no image library:
8-bit, non-interlaced, colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA), all five scanline filters. `read_rgb8`
gives the uint8 values PIL's `Image.open(...).convert("RGB")` gives for
those files: grey is replicated, palettes are looked up and alpha is
dropped. Interlaced PNGs, other bit depths and JPEG raise
NotImplementedError naming ROADMAP A.1; they never decode to something
else. The Radiance RGBE and PFM code is the reference's numpy.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _chunks(data: bytes):
    """(type, body) of each PNG chunk after the signature, up to IEND."""
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length  # length, type, body, CRC
    raise ValueError("PNG without IEND")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Paeth filter in place (PNG spec 9.4)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pa = abs(b - c)
        pb = abs(a - c)
        pc = abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 scanlines with every row's filter undone."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data too short")
    out = np.zeros((height + 1, stride), np.uint8)  # row 0: the zero prior line
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        prior = out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum mod 256 of each byte lane
            out[y + 1] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y + 1] = line + prior
        elif kind == 3:  # Average of left and up, left from the decoded row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        elif kind == 4:
            cur = bytearray(line.tobytes())
            _paeth_row(cur, prior.tobytes(), bpp)
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
    return out[1:]


def decode_png(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None]:
    """PNG bytes -> (samples (H, W, C) uint8, colour type, palette (256, 3)
    uint8 or None)."""
    if data.startswith(_JPEG_MAGIC):
        raise NotImplementedError("JPEG decoding is not ported (ROADMAP A.1)")
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG image")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            entries = np.frombuffer(body, np.uint8).reshape(-1, 3)
            palette = np.zeros((256, 3), np.uint8)  # indices past the table read black
            palette[: len(entries)] = entries[:256]
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _compression, _filter, interlace = header
    if interlace:
        raise NotImplementedError("interlaced PNG decoding is not ported (ROADMAP A.1)")
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNG decoding is not ported (ROADMAP A.1)")
    if color not in _CHANNELS:
        raise ValueError(f"invalid PNG colour type {color}")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    rows = _unfilter(raw, height, width * ch, ch)
    return rows.reshape(height, width, ch), color, palette


def rgb8_from_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's convert("RGB") gives it."""
    px, color, palette = decode_png(data)
    if color == 3:
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_rgb8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return rgb8_from_png(f.read())


def load_image(path: str, flip_y: bool = True) -> np.ndarray:
    """8-bit image -> (H, W, 3) float32 in [0,1]. flip_y matches the
    reference's texture convention (Model.cpp:116-125 mirrors stb rows)."""
    img = read_rgb8(path).astype(np.float32) / 255.0
    return img[::-1] if flip_y else img


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes
    (filter 0 on every row)."""
    if arr.ndim == 2:
        arr = arr[..., None]
    color = {1: 0, 3: 2, 4: 6}[arr.shape[-1]]
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3|4) uint8 or float in [0,1] -> PNG."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))


# ---- Radiance .hdr (RGBE) ---------------------------------------------------

def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr -> (H, W, 3) float32 linear (stbi_loadf equivalent).

    Supports the common '-Y H +X W' orientation with new-style RLE scanlines.
    """
    with open(path, "rb") as f:
        data = f.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    header_end = data.index(b"\n\n") + 2
    nl = data.index(b"\n", header_end)
    res_line = data[header_end:nl].decode("ascii").split()
    pos = nl + 1
    if len(res_line) != 4 or res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {' '.join(res_line)}")
    h, w = int(res_line[1]), int(res_line[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    idx = 0
    for y in range(h):
        # new-style RLE scanline: 0x02 0x02 hi lo (hi/lo must encode the
        # width — a flat pixel can also start with 0x02 0x02)
        if (
            w >= 8
            and w < 32768
            and raw[idx] == 2
            and raw[idx + 1] == 2
            and (int(raw[idx + 2]) << 8 | int(raw[idx + 3])) == w
        ):
            idx += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(raw[idx])
                    idx += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = raw[idx]
                        idx += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = raw[idx : idx + count]
                        idx += count
                        x += count
        else:  # flat scanline
            rgbe[y] = raw[idx : idx + 4 * w].reshape(w, 4)
            idx += 4 * w

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 2^(e-128)/256
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] == 0, 0.0, 1.0
    )


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W, 4) RGBE bytes (shared-exponent encode)."""
    m = img.max(axis=-1)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    mant, exp = np.frexp(np.maximum(m, 0.0))
    valid = m > 1e-32
    s = np.where(valid, mant * 256.0 / np.maximum(m, 1e-32), 0.0)
    out[..., 0] = np.clip(img[..., 0] * s, 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(img[..., 1] * s, 0, 255).astype(np.uint8)
    out[..., 2] = np.clip(img[..., 2] * s, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    return out


def save_hdr(path: str, img: np.ndarray) -> None:
    """(H, W, 3) float32 -> uncompressed Radiance .hdr."""
    h, w = img.shape[:2]
    rgbe = float_to_rgbe(np.asarray(img, np.float32))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---- PFM (the reference's BSDFTest output format) ---------------------------

def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(img[::-1].tobytes())


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if kind == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)[::-1]
    return img.squeeze()
