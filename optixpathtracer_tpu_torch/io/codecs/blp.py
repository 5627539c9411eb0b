"""Blizzard BLP textures, as PIL's BlpImagePlugin reads them: BLP1 with
JPEG content (the shared header, then the first mip's data, decoded by
io/image.py; a four-component stream taken as CMYK, never YCCK, inverted
as PIL reads CMYK; the RGB bytes taken as BGR, as PIL's decoder does) or a BGRA palette (encodings 4 and 5);
BLP2 with a palette or DXT1 / DXT3 / DXT5 blocks decoded as PIL's own
Python decoder does (5-6-5 endpoints shifted, not replicated; DXT3 and
DXT5 colours always in four-colour mode). PIL joins each decoder's bytes
and reads them as rows of the header's width, RGBA when the header says
alpha and RGB otherwise, whatever the decoder gave: so does the port."""
from __future__ import annotations

import struct

import numpy as np

from ._common import DecodeError, cmyk_rgb, need

_SIZES = {0: 8, 1: 16, 7: 16}


def _565(c: np.ndarray) -> np.ndarray:
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _dxt(blk: np.ndarray, kind: int) -> np.ndarray:
    """(n, 8 or 16) blocks -> (n, 16, 4) RGBA, as PIL's decode_dxt1/3/5."""
    colour = blk[:, -8:].astype(np.int64)
    c0 = colour[:, 0] | colour[:, 1] << 8
    c1 = colour[:, 2] | colour[:, 3] << 8
    code = colour[:, 4] | colour[:, 5] << 8 | colour[:, 6] << 16 | colour[:, 7] << 24
    p0, p1 = _565(c0), _565(c1)
    four = (c0 > c1)[:, None] if kind == 0 else np.ones((len(blk), 1), bool)
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (2 * p1 + p0) // 3, 0)
    alpha = np.full((len(blk), 4), 255, np.int64)
    if kind == 0:
        alpha[:, 3] = np.where(four[:, 0], 255, 0)
    pal = np.concatenate([np.stack([p0, p1, p2, p3], 1), alpha[..., None]], -1)  # (n, 4, 4)
    idx = (code[:, None] >> (2 * np.arange(16))) & 3
    px = np.take_along_axis(pal, idx[..., None], 1)
    if kind == 1:
        nib = blk[:, :8].astype(np.int64)
        a = (nib[:, np.arange(16) // 2] >> (4 * (np.arange(16) % 2))) & 0xF
        px[..., 3] = a * 17
    elif kind == 7:
        a0, a1 = blk[:, 0].astype(np.int64)[:, None], blk[:, 1].astype(np.int64)[:, None]
        bits = np.zeros(len(blk), np.int64)
        for i in range(6):
            bits |= blk[:, 2 + i].astype(np.int64) << (8 * i)
        c = (bits[:, None] >> (3 * np.arange(16))) & 7
        eight = ((8 - c) * a0 + (c - 1) * a1) // 7
        six = np.where(c == 6, 0, np.where(c == 7, 255, ((6 - c) * a0 + (c - 1) * a1) // 5))
        a = np.where(c == 0, a0, np.where(c == 1, a1, np.where(a0 > a1, eight, six)))
        px[..., 3] = a
    return px


def _indexed(data: bytes, pos: int, length: int, palette: np.ndarray, alpha: bool) -> bytes:
    raw = data[pos:pos + length]
    if len(raw) < length:
        raise DecodeError("Truncated File Read")
    idx = np.frombuffer(raw, np.uint8).astype(np.int64)
    return palette[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]].tobytes()


def _palette(data: bytes, pos: int) -> np.ndarray:
    """256 BGRA entries: PIL reads all of them whatever the encoding."""
    need(data, pos + 1024, "BLP")
    return np.frombuffer(data[pos:pos + 1024], np.uint8).reshape(256, 4)


def rgb8(data: bytes) -> np.ndarray:
    v1 = data.startswith(b"BLP1")
    need(data, 28 if v1 else 20, "BLP")
    compression = struct.unpack("<i", data[4:8])[0]
    if v1:
        alpha = struct.unpack("<I", data[8:12])[0] != 0
        encoding = struct.unpack("<i", data[20:24])[0]
        pos = 28
    else:
        encoding, alpha_flag, alpha_encoding = struct.unpack("<bbb", data[8:11])
        alpha = alpha_flag != 0
        pos = 20
    width, height = struct.unpack("<II", data[12:20])
    need(data, pos + 128, "BLP")
    offsets = struct.unpack("<16I", data[pos:pos + 64])
    lengths = struct.unpack("<16I", data[pos + 64:pos + 128])
    pos += 128
    nch = 4 if alpha else 3
    if v1 and compression == 0:
        from ..image import decode_jpeg

        need(data, pos + 4, "BLP")
        head = struct.unpack("<I", data[pos:pos + 4])[0]
        pos += 4
        header = data[pos:pos + head]
        pos = max(pos + head, offsets[0])
        body = data[pos:pos + lengths[0]]
        if len(header) < head or len(body) < lengths[0]:
            raise DecodeError("Truncated File Read")
        px = decode_jpeg(header + body, "raw")
        if px.shape[-1] == 4:  # PIL forces the stream's colour space to CMYK (no YCCK), read inverted
            px = cmyk_rgb(255 - px)
        elif px.shape[-1] == 3:
            px = decode_jpeg(header + body)
        elif px.shape[-1] == 1:
            px = np.repeat(px, 3, -1)
        stream = np.ascontiguousarray(px)
        n = width * height * 3  # PIL sets the RGB bytes as BGR, alpha opaque
        if stream.size < n:
            raise DecodeError("not enough image data")
        bgr = stream.reshape(-1)[:n].reshape(height, width, 3)
        return np.ascontiguousarray(bgr[..., ::-1])
    if v1:
        if compression != 1 or encoding not in (4, 5):
            raise DecodeError(f"Unsupported BLP compression {compression} / encoding {encoding}")
        palette = _palette(data, pos)
        stream = _indexed(data, pos + 1024, lengths[0], palette, alpha)
    else:
        palette = _palette(data, pos)
        if compression != 1 or encoding not in (1, 2):
            raise DecodeError(f"Unknown BLP compression {compression} / encoding {encoding}")
        if encoding == 1:
            stream = _indexed(data, offsets[0], lengths[0], palette, alpha)
        else:
            if alpha_encoding not in _SIZES:
                raise DecodeError(f"Unsupported alpha encoding {alpha_encoding!r}")
            size = _SIZES[alpha_encoding]
            bw, bh = (width + 3) // 4, (height + 3) // 4
            raw = data[offsets[0]:offsets[0] + bw * bh * size]
            if len(raw) < bw * bh * size:
                raise DecodeError("Truncated File Read")
            px = _dxt(np.frombuffer(raw, np.uint8).reshape(-1, size), alpha_encoding)
            img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, 4)
            if alpha_encoding == 0 and not alpha:
                img = img[..., :3]
            stream = img.astype(np.uint8).tobytes()
    n = width * height * nch
    if len(stream) < n:
        raise DecodeError("not enough image data")
    px = np.frombuffer(stream[:n], np.uint8).reshape(height, width, nch)
    return np.ascontiguousarray(px[..., :3])
