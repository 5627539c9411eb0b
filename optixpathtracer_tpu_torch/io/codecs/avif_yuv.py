"""libavif 1.3's YUV -> RGB for 8-bit 4:2:0, as PIL asks for it (RGB, depth
8, AVIF_CHROMA_UPSAMPLING_AUTOMATIC): libavif hands the planes to libyuv's
I420ToRGB24MatrixFilter with the bilinear filter, so the chroma is
upsampled 2x with libyuv's ScaleRowUp2 kernels (9:3:3:1 inside, 3:1 on
the first and last rows and columns, the edge rows linear only) and each
pixel converted with libyuv's fixed-point YuvConstants (6-bit chroma
coefficients, a 16.16 luma gain, >> 6 and a clamp).

The constants are libyuv's for the matrices libavif maps onto it: BT.601
(matrix 5, 6 and unspecified 2; "I601" limited, "JPEG" full range), BT.709
(1; "H709" / "F709") and BT.2020 non-constant luminance (9; "2020" /
"V2020"). Any other matrix goes to libavif's own converter and raises
NotImplementedError naming ROADMAP A.1."""
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
