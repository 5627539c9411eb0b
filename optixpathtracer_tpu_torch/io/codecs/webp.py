"""WebP, the first frame, as PIL reads it through libwebp's
WebPAnimDecoder: the RIFF container, simple lossy (VP8) and lossless
(VP8L) files, and extended ones (VP8X) with ALPH, ICCP, EXIF / XMP and
animation chunks. The first frame is decoded into a canvas of the VP8X
size, transparent black elsewhere (an animation's frame 0 may be smaller
and offset). Lossy frames go through codecs/vp8.py and libwebp's fancy
upsampling and conversion (codecs/webp_yuv.py); lossless ones through
codecs/vp8l.py. PIL's RGB is the frame's colour, not premultiplied: the
alpha channel (ALPH, or VP8L's own) does not change it and is not
decoded."""
from __future__ import annotations

import numpy as np

from . import vp8, vp8l
from ._common import DecodeError, NotThisFormat, u32le
from .webp_yuv import yuv420_to_rgb


def _chunks(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        kind, size = data[pos:pos + 4], u32le(data, pos + 4)
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise DecodeError(f"truncated WebP chunk {kind!r}")
        yield kind, body
        pos += 8 + size + (size & 1)


def _frame(chunks) -> np.ndarray:
    """The image chunks of one frame (ALPH? then VP8 or VP8L) -> RGB."""
    for kind, body in chunks:
        if kind == b"VP8 ":
            y, u, v, w, h = vp8.decode(body)
            return yuv420_to_rgb(y, u, v, w, h)
        if kind == b"VP8L":
            return vp8l.decode(body)[..., :3]
    raise DecodeError("WebP frame without image data")


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 16 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise NotThisFormat("not a WebP file")
    end = min(len(data), 8 + u32le(data, 4))
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise DecodeError("WebP without chunks")
    if chunks[0][0] != b"VP8X":
        return np.ascontiguousarray(_frame(chunks[:1]))
    head = chunks[0][1]
    if len(head) < 10:
        raise DecodeError("truncated VP8X chunk")
    cw = 1 + (head[4] | head[5] << 8 | head[6] << 16)
    ch = 1 + (head[7] | head[8] << 8 | head[9] << 16)
    for kind, body in chunks[1:]:
        if kind == b"ANMF":
            if len(body) < 16:
                raise DecodeError("truncated ANMF chunk")
            x0 = 2 * (body[0] | body[1] << 8 | body[2] << 16)
            y0 = 2 * (body[3] | body[4] << 8 | body[5] << 16)
            img = _frame(_chunks(body, 16, len(body)))
            canvas = np.zeros((ch, cw, 3), np.uint8)
            fh, fw = img.shape[:2]
            if x0 + fw > cw or y0 + fh > ch:
                raise DecodeError("WebP frame outside its canvas")
            canvas[y0:y0 + fh, x0:x0 + fw] = img
            return canvas
        if kind in (b"VP8 ", b"VP8L"):
            img = _frame([(kind, body)])
            if img.shape[:2] != (ch, cw):
                raise DecodeError("WebP image and canvas sizes differ")
            return np.ascontiguousarray(img)
    raise DecodeError("WebP without a frame")
