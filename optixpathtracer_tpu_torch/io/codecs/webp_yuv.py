"""Y'CbCr 4:2:0 -> RGB as libwebp writes RGBA for PIL: the "fancy"
upsampler (upsampling.c: each chroma sample of a pair of output rows from
the 2x2 chroma samples around it, weighted 9-3-3-1, the first and the
last row mirrored) and the 14-bit fixed-point conversion of yuv.h
(VP8YUVToR / G / B). Every row at once in numpy."""
from __future__ import annotations

import numpy as np


def _rows(t: np.ndarray, c: np.ndarray, width: int, near_top: np.ndarray) -> np.ndarray:
    """The upsampled chroma of output rows whose chroma rows above / below
    are t and c ((h, uv_w) each); near_top[r]: row r is the top one of
    its pair (weights 3/4 on t), else the bottom one (3/4 on c)."""
    h = t.shape[0]
    out = np.zeros((h, width), np.int64)
    nt = near_top[:, None]
    first_t = (3 * t[:, :1] + c[:, :1] + 2) >> 2
    first_b = (3 * c[:, :1] + t[:, :1] + 2) >> 2
    out[:, :1] = np.where(nt, first_t, first_b)
    pairs = (width - 1) >> 1
    if pairs:
        tl, tt, ll, cc = t[:, :pairs], t[:, 1:pairs + 1], c[:, :pairs], c[:, 1:pairs + 1]
        avg = tl + tt + ll + cc + 8
        d12 = (avg + 2 * (tt + ll)) >> 3
        d03 = (avg + 2 * (tl + cc)) >> 3
        out[:, 1:2 * pairs:2] = np.where(nt, (d12 + tl) >> 1, (d03 + ll) >> 1)
        out[:, 2:2 * pairs + 1:2] = np.where(nt, (d03 + tt) >> 1, (d12 + cc) >> 1)
    if width % 2 == 0:
        last_t = (3 * t[:, pairs:pairs + 1] + c[:, pairs:pairs + 1] + 2) >> 2
        last_b = (3 * c[:, pairs:pairs + 1] + t[:, pairs:pairs + 1] + 2) >> 2
        out[:, width - 1:] = np.where(nt, last_t, last_b)
    return out


def _upsample(p: np.ndarray, width: int, height: int) -> np.ndarray:
    """One chroma plane (at least ((h + 1) / 2, (w + 1) / 2)) -> (h, w)."""
    uvh, uvw = (height + 1) // 2, (width + 1) // 2
    p = p[:uvh, :uvw].astype(np.int64)
    r = np.arange(height)
    k = (r + 1) // 2
    top = p[np.maximum(k - 1, 0)]
    cur = p[np.minimum(k, uvh - 1)]
    near_top = (r % 2 == 1) | (r == 0)
    return _rows(top, cur, width, near_top)


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, width: int, height: int) -> np.ndarray:
    """Planes (luma at least (h, w)) -> (h, w, 3) uint8."""
    yy = y[:height, :width].astype(np.int64) * 19077 >> 8
    uu = _upsample(u, width, height)
    vv = _upsample(v, width, height)
    r = _clip8(yy + (vv * 26149 >> 8) - 14234)
    g = _clip8(yy - (uu * 6419 >> 8) - (vv * 13320 >> 8) + 8708)
    b = _clip8(yy + (uu * 33050 >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)
