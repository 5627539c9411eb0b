"""libavif 1.3's own YUV -> RGB (reformat.c), for the matrices libyuv does
not take: what `avifImageYUVToRGB` does when libavif finds no libyuv
constants for the image (codecs/avif_yuv.py routes the rest to libyuv).

- Which images libavif refuses (`refused`): matrix 3, 10, 11, 13, 14 and
  17 or above; identity (0) in 4:2:0 or 4:2:2; YCgCo (8) in limited
  range; YCgCo-Re (16) other than full range at 10 bits (an 8-bit RGB
  result takes two bits fewer). They fail in every layout, with or
  without alpha, 4:0:0 included; PIL raises "Conversion from YUV failed:
  Reformat failed" (ROADMAP C.16).
- The rest goes through float32 unorm tables of the depth: Y as (Y - 16
  << (depth - 8)) / (219 << (depth - 8)) in limited range and Y / (2^depth
  - 1) in full; U and V centred on 2^(depth - 1) over 224 << (depth - 8)
  or 2^depth - 1 (identity takes the Y table for them too). Subsampled
  chroma is upsampled in float, bilinear with weights 9/16, 3/16, 3/16,
  1/16 of the nearest, the adjacent column, the adjacent row and the
  diagonal sample (libavif's slow path; AVIF_CHROMA_UPSAMPLING_AUTOMATIC
  is bilinear there), each edge repeating its sample. Then by mode:
  identity G = Y, B = U, R = V; YCgCo (8) t = Y - Cg, G = Y + Cg, B = t -
  Co, R = t + Co; YCgCo-Re (16) on integers (Cg, Co rounded back to codes);
  any other matrix R = Y + 2 (1 - kr) Cr, B = Y + 2 (1 - kb) Cb, G = Y - 2
  (kr (1 - kr) Cr + kb (1 - kb) Cb) / kg with libavif's kr / kb (BT.601's
  where the matrix has none of its own, 2 and 15 so; for 12 derived from
  the nclx colour primaries). Each channel clamped to [0, 1], times 255
  plus 0.5, truncated.
- Premultiplied colour: libavif's slow path (subsampled chroma, YCgCo, or
  identity other than 8-bit full range) divides each channel by the
  alpha's unorm (0 where alpha is 0, capped at 1) before the rounding;
  its fast paths (4:4:4 and 4:0:0) convert straight and leave the
  un-premultiply to libyuv's ARGBUnattenuate on the 8-bit RGBA
  (avif_yuv.unpremultiply), the alpha brought to 8 bits in float as
  libavif's avifReformatAlpha does (avif_yuv.alpha8's float table)."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError

REFORMAT_FAILED = "Conversion from YUV failed: Reformat failed"
IDENTITY, YCGCO, CHROMA_DERIVED_NCL, YCGCO_RE = 0, 8, 12, 16
_REFUSED = {3, 10, 11, 13, 14}
# libavif's kr / kb (float) by matrix; any other matrix it takes is BT.601's
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114), 6: (0.299, 0.114), 7: (0.212, 0.087),
          9: (0.2627, 0.0593)}
# libavif's colour primaries (rX, rY, gX, gY, bX, bY, wX, wY); BT.709's for any other
_PRIMARIES = {
    1: (0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}
f32 = np.float32


def refused(matrix: int, ss, depth: int, full: int) -> bool:
    """Whether libavif 1.3 refuses to convert the image (`ss` None for
    4:0:0)."""
    if matrix in _REFUSED or matrix > YCGCO_RE:
        return True
    if matrix == IDENTITY:
        return ss is not None and tuple(ss) != (0, 0)
    if matrix == YCGCO:
        return not full
    if matrix == YCGCO_RE:
        return not full or depth != 10
    return False


def check(matrix: int, ss, depth: int, full: int) -> None:
    if refused(matrix, ss, depth, full):
        raise DecodeError(REFORMAT_FAILED)


def y_coefficients(primaries: int) -> tuple:
    """avifColorPrimariesComputeYCoeffs: (kr, kb) of matrix 12 from the
    colour primaries, in float32 in libavif's order."""
    rx, ry, gx, gy, bx, by, wx, wy = (f32(v) for v in _PRIMARIES.get(primaries, _PRIMARIES[1]))
    one = f32(1)
    rz, gz, bz, wz = one - (rx + ry), one - (gx + gy), one - (bx + by), one - (wx + wy)
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) + wz * (rx * gy - gx * ry))) / den
    return kr, kb


def coefficients(matrix: int, primaries: int) -> tuple:
    """(kr, kg, kb) in float32, as avifCalcYUVCoefficients gives them."""
    if matrix == CHROMA_DERIVED_NCL:
        kr, kb = y_coefficients(primaries)
    else:
        kr, kb = (f32(v) for v in _KR_KB.get(matrix, _KR_KB[6]))
    return kr, f32(1) - kr - kb, kb


def _tables(depth: int, full: int, identity: bool):
    """The unorm float tables of Y and of U / V."""
    cp = np.arange(1 << depth, dtype=f32)
    top = f32((1 << depth) - 1)
    if full:
        y = (cp - f32(0)) / top
        uv = (cp - f32(1 << (depth - 1))) / top
    else:
        y = (cp - f32(16 << (depth - 8))) / f32(219 << (depth - 8))
        uv = (cp - f32(1 << (depth - 1))) / f32(224 << (depth - 8))
    return y, (y if identity else uv)


def _neighbours(n: int, shift: int) -> tuple:
    """(nearest, adjacent) chroma index of each of n samples along an axis
    subsampled by `shift` (libavif's uAdjCol / uAdjRow); the adjacent one is
    the nearest itself without subsampling and at the edges."""
    i = np.arange(n)
    near = i >> shift
    if not shift:
        return near, near
    step = np.where(i % 2 == 1, 1, -1)
    step[(i == 0) | ((i == n - 1) & (i % 2 == 1))] = 0
    return near, near + step


def _chroma(plane, table, h: int, w: int, ss) -> np.ndarray:
    """A chroma plane -> (h, w) float32 unorm, upsampled as libavif's slow
    path upsamples it."""
    sx, sy = ss
    t = table[plane]
    if not sx and not sy:
        return t
    cols, adj_cols = _neighbours(w, sx)
    rows, adj_rows = _neighbours(h, sy)
    if not sy:  # 4:2:2: the row is its own neighbour
        adj_rows = rows
    a = t[rows][:, cols]
    b = t[rows][:, adj_cols]
    c = t[adj_rows][:, cols]
    d = t[adj_rows][:, adj_cols]
    return a * f32(9.0 / 16.0) + b * f32(3.0 / 16.0) + c * f32(3.0 / 16.0) + d * f32(1.0 / 16.0)


def _round(x: np.ndarray) -> np.ndarray:
    """(uint8_t)(0.5f + x * 255.0f) of x in [0, 1]."""
    return (f32(0.5) + x * f32(255)).astype(np.uint8)


def uses_slow_path(matrix: int, ss, depth: int, full: int) -> bool:
    """Whether libavif converts through its slow path (which also
    un-premultiplies) rather than a fast one (4:4:4 and 4:0:0 in a matrix
    with kr / kb, or 8-bit full-range identity)."""
    if ss is None:
        return matrix in (YCGCO, YCGCO_RE)
    if tuple(ss) != (0, 0) or matrix in (YCGCO, YCGCO_RE):
        return True
    return matrix == IDENTITY and not (depth == 8 and full)


def to_rgb(y: np.ndarray, u, v, ss, matrix: int, full: int, depth: int = 8, primaries: int = 2,
           alpha=None) -> np.ndarray:
    """Planes of `depth` bits (u / v None for 4:0:0) -> (H, W, 3) uint8;
    `alpha` (the alpha plane at the depth, or None) un-premultiplies the
    colour in float where libavif's slow path does it."""
    top = (1 << depth) - 1
    ty, tuv = _tables(depth, full, matrix == IDENTITY)
    yc = np.minimum(y, top)
    luma = ty[yc]
    h, w = y.shape
    if u is None:
        r = g = b = luma
    else:
        cb = _chroma(np.minimum(u, top), tuv, h, w, ss)
        cr = _chroma(np.minimum(v, top), tuv, h, w, ss)
        if matrix == IDENTITY:
            g, b, r = luma, cb, cr
        elif matrix == YCGCO:
            t = luma - cb
            g, b, r = luma + cb, t - cr, t + cr
        elif matrix == YCGCO_RE:
            yy = yc.astype(np.int64)
            cg = np.floor(cb * f32(top) + f32(0.5)).astype(np.int64)
            co = np.floor(cr * f32(top) + f32(0.5)).astype(np.int64)
            t = yy - (cg >> 1)
            gi = np.clip(t + cg, 0, 255)
            bi = np.clip(t - (co >> 1), 0, 255)
            ri = np.clip(bi + co, 0, 255)
            g, b, r = (x.astype(f32) / f32(255) for x in (gi, bi, ri))
        else:
            kr, kg, kb = coefficients(matrix, primaries)
            one, two = f32(1), f32(2)
            r = luma + (two * (one - kr)) * cr
            b = luma + (two * (one - kb)) * cb
            g = luma - ((two * ((kr * (one - kr) * cr) + (kb * (one - kb) * cb))) / kg)
    out = [np.clip(c, f32(0), f32(1)) for c in (r, g, b)]
    if alpha is not None:
        a = np.clip(np.minimum(alpha, top).astype(f32) / f32(top), f32(0), f32(1))
        part = (a > 0) & (a < 1)
        out = [np.where(a == 0, f32(0), np.where(part, np.minimum(c / np.where(part, a, f32(1)), f32(1)), c))
               for c in out]
    return np.stack([_round(c) for c in out], -1)
