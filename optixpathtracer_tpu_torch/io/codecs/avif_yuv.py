"""libavif 1.3's YUV -> RGB for 8-bit stills, as PIL asks for it (RGB or
RGBA, depth 8, AVIF_CHROMA_UPSAMPLING_AUTOMATIC), and its un-premultiply.

- 4:2:0 (`yuv420_to_rgb`): libavif hands the planes to libyuv's
  I420ToRGB24MatrixFilter with the bilinear filter, so the chroma is
  upsampled 2x with libyuv's ScaleRowUp2 kernels (9:3:3:1 inside, 3:1 on
  the first and last rows and columns, the edge rows linear only);
- 4:2:2 (`yuv422_to_rgb`): I422ToRGB24MatrixFilter, each chroma row
  upsampled 2x across with the linear kernel (3:1) alone;
- 4:4:4 (`yuv444_to_rgb`): I444ToRGB24Matrix, no upsampling;

each pixel then converted with libyuv's fixed-point YuvConstants (6-bit
chroma coefficients, a 16.16 luma gain, >> 6 and a clamp). The constants
are libyuv's for the matrices libavif maps onto it: BT.601 (matrix 5, 6
and unspecified 2; "I601" limited, "JPEG" full range), BT.709 (1; "H709" /
"F709") and BT.2020 non-constant luminance (9; "2020" / "V2020"). Any
other matrix goes to libavif's own converter and raises
NotImplementedError naming ROADMAP A.1.

- 4:0:0 (`yuv400_to_rgb`): libavif's own grey path, whatever the matrix:
  Y scaled to [0, 1] in float32 ((Y - 16) / 219 in limited range, Y / 255
  in full), clamped, times 255 plus 0.5, truncated; R = G = B. With an
  alpha item PIL asks for RGBA, and libavif takes libyuv's
  I400ToARGBMatrix instead (the 4:4:4 conversion at mid-grey chroma), for
  the matrices above only.
- `unpremultiply(rgb, alpha)`: libyuv's ARGBUnattenuate, which libavif
  runs when the item says its colour is premultiplied (a `prem`
  reference) and PIL asks for straight alpha: a 16-bit reciprocal
  (0x10000 / a; 0xFFFF for a = 1), c * 257 times it >> 16, saturated as
  the SIMD lanes saturate (above 32767 -> 0, above 255 -> 255); a = 255
  leaves the colour, a = 0 makes it 0."""
from __future__ import annotations

import numpy as np

# (YG, YB, UB, UG, VG, VR) by (matrix family, full range)
_CONSTANTS = {
    ("601", 0): (18997, -1160, 128, 25, 52, 102),
    ("601", 1): (16320, 32, 113, 22, 46, 90),
    ("709", 0): (18997, -1160, 128, 14, 34, 115),
    ("709", 1): (16320, 32, 119, 12, 30, 101),
    ("2020", 0): (19003, -1160, 128, 12, 42, 107),
    ("2020", 1): (16320, 32, 120, 11, 37, 94),
}
_FAMILY = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}


def _up_linear(row: np.ndarray, width: int) -> np.ndarray:
    """libyuv ScaleRowUp2_Linear_Any: a chroma row -> `width` samples."""
    s = row.astype(np.int32)
    out = np.empty(width, np.int32)
    out[0] = s[0]
    work = (width - 1) & ~1
    if work > 0:
        k = np.arange(work // 2)
        out[1:work + 1:2] = (s[k] * 3 + s[k + 1] + 2) >> 2
        out[2:work + 2:2] = (s[k] + s[k + 1] * 3 + 2) >> 2
    out[width - 1] = s[(width - 1) // 2]
    return out


def _up_bilinear(a: np.ndarray, b: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """libyuv ScaleRowUp2_Bilinear_Any: two chroma rows -> the two output
    rows between them (the first nearer `a`)."""
    s, t = a.astype(np.int32), b.astype(np.int32)
    d = np.empty(width, np.int32)
    e = np.empty(width, np.int32)
    d[0] = (3 * s[0] + t[0] + 2) >> 2
    e[0] = (s[0] + 3 * t[0] + 2) >> 2
    work = (width - 1) & ~1
    if work > 0:
        k = np.arange(work // 2)
        d[1:work + 1:2] = (s[k] * 9 + s[k + 1] * 3 + t[k] * 3 + t[k + 1] + 8) >> 4
        d[2:work + 2:2] = (s[k] * 3 + s[k + 1] * 9 + t[k] + t[k + 1] * 3 + 8) >> 4
        e[1:work + 1:2] = (s[k] * 3 + s[k + 1] + t[k] * 9 + t[k + 1] * 3 + 8) >> 4
        e[2:work + 2:2] = (s[k] + s[k + 1] * 3 + t[k] * 3 + t[k + 1] * 9 + 8) >> 4
    m = (width - 1) // 2
    d[width - 1] = (3 * s[m] + t[m] + 2) >> 2
    e[width - 1] = (s[m] + 3 * t[m] + 2) >> 2
    return d, e


def upsample(c: np.ndarray, width: int, height: int) -> np.ndarray:
    """A (ceil(h / 2), ceil(w / 2)) chroma plane -> (height, width), the rows
    in the order I420ToRGB24MatrixBilinear builds them."""
    rows = [_up_linear(c[0], width)]
    k = 0
    for _ in range(0, height - 2, 2):
        d, e = _up_bilinear(c[k], c[k + 1], width)
        rows += [d, e]
        k += 1
    if not height & 1:
        rows.append(_up_linear(c[k], width))
    return np.stack(rows[:height])


def yuv444_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int) -> np.ndarray:
    """libyuv YuvPixel over whole planes -> (H, W, 3) uint8."""
    if matrix not in _FAMILY:
        raise NotImplementedError(f"AVIF of matrix coefficients {matrix} is not ported (ROADMAP A.1)")
    yg, yb, ub, ug, vg, vr = _CONSTANTS[(_FAMILY[matrix], int(bool(full)))]
    bb, bg, br = ub * 128 - yb, ug * 128 + vg * 128 + yb, vr * 128 - yb
    y1 = ((y.astype(np.int64) * 0x0101 * yg) & 0xFFFFFFFF) >> 16
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    b = y1 + u * ub - bb
    g = y1 + bg - (u * ug + v * vg)
    r = y1 + v * vr - br
    return np.clip(np.stack([r, g, b], -1) >> 6, 0, 255).astype(np.uint8)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int) -> np.ndarray:
    h, w = y.shape
    return yuv444_to_rgb(y, upsample(u, w, h), upsample(v, w, h), matrix, full)


def yuv422_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int) -> np.ndarray:
    w = y.shape[1]
    return yuv444_to_rgb(y, np.stack([_up_linear(r, w) for r in u]), np.stack([_up_linear(r, w) for r in v]),
                         matrix, full)


def _grey_table(full: int) -> np.ndarray:
    f = np.float32
    y = np.arange(256, dtype=f)
    unorm = y / f(255) if full else (y - f(16)) / f(219)
    return (f(0.5) + np.clip(unorm, f(0), f(1)) * f(255)).astype(np.uint8)


_GREY = {0: _grey_table(0), 1: _grey_table(1)}


def yuv400_to_rgb(y: np.ndarray, full: int) -> np.ndarray:
    return np.repeat(_GREY[int(bool(full))][y][..., None], 3, -1)


def to_rgb(y: np.ndarray, u, v, ss, matrix: int, full: int, rgba: bool = False) -> np.ndarray:
    """Planes of any layout (`ss` the subsampling, u / v None for 4:0:0)
    -> (H, W, 3) uint8; `rgba` where the image has alpha (PIL asks
    libavif for RGBA)."""
    if u is None:
        if not rgba:
            return yuv400_to_rgb(y, full)
        u = v = np.full_like(y, 128)
        return yuv444_to_rgb(y, u, v, matrix, full)
    convert = {(1, 1): yuv420_to_rgb, (1, 0): yuv422_to_rgb, (0, 0): yuv444_to_rgb}[tuple(ss)]
    return convert(y, u, v, matrix, full)


_RECIP = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 256)], np.int64)


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    a = alpha.astype(np.int64)[..., None]
    v = (rgb.astype(np.int64) * 257 * _RECIP[a]) >> 16
    out = np.where(v > 32767, 0, np.minimum(v, 255))
    return np.where(a == 255, rgb, out).astype(np.uint8)
