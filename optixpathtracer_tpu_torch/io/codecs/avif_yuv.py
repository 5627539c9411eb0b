"""libavif 1.3's YUV -> RGB for 8-, 10- and 12-bit stills, as PIL asks for
it (RGB or RGBA, depth 8, AVIF_CHROMA_UPSAMPLING_AUTOMATIC), and its
un-premultiply.

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
"F709"), BT.2020 non-constant luminance (9; "2020" / "V2020"), and
chroma-derived NCL (12) where the colour primaries are BT.709 or
unspecified (1, 2), BT.601 (5, 6) or BT.2020 (9). Any other matrix goes
to libavif's own converter (codecs/avif_reformat.py) at the planes' own
depth, and the matrices libavif refuses for the layout, range and depth
raise DecodeError with PIL's "Conversion from YUV failed: Reformat
failed" (ROADMAP C.16).

- 4:0:0 (`yuv400_to_rgb`): libavif's own grey path, whatever matrix it
  takes: Y scaled to [0, 1] in float32 ((Y - 16) / 219 in limited range,
  Y / 255 in full), clamped, times 255 plus 0.5, truncated; R = G = B.
  With an alpha item PIL asks for RGBA, and libavif takes libyuv's
  I400ToARGBMatrix instead (the 4:4:4 conversion at mid-grey chroma), for
  the libyuv matrices above and identity (0, which libavif hands libyuv
  as BT.601 in 4:0:0); the others keep the grey path.
- `unpremultiply(rgb, alpha)`: libyuv's ARGBUnattenuate, which libavif
  runs when the item says its colour is premultiplied (a `prem`
  reference) and PIL asks for straight alpha: a 16-bit reciprocal
  (0x10000 / a; 0xFFFF for a = 1), c * 257 times it >> 16, saturated as
  the SIMD lanes saturate (above 32767 -> 0, above 255 -> 255); a = 255
  leaves the colour, a = 0 makes it 0.

10- and 12-bit planes (`to_rgb(..., depth=)`) take one of three routes,
as libavif 1.3 picks them for an 8-bit RGB(A) result:

- RGB (no alpha item) in 4:4:4, 4:2:2 and 4:2:0, and RGBA in 4:4:4 and
  4:2:2 at 12 bits, and in 4:0:0 at either depth: the planes brought to
  8 bits first (libyuv's Convert16To8Plane: Y >> (depth - 8)), then the
  8-bit route above;
- RGB in 4:0:0: the grey path at the depth ((Y - (16 << (depth - 8))) /
  (219 << (depth - 8)) limited, Y / (2^depth - 1) full, in float32);
- RGBA at 10 bits (I410 / I210ToARGBMatrix(Filter), I010ToARGBMatrixFilter:
  the chroma upsampled at 10 bits with the kernels above) and 4:2:0 at 12
  bits (I012ToARGBMatrix: each chroma sample repeated over its 2 x 2
  pixels): libyuv's YuvPixel10 / YuvPixel12, the luma widened to 16 bits
  ((Y << 6) | (Y >> 4), (Y << 4) | (Y >> 8)) and the chroma cut to 8
  (U >> 2, U >> 4) before the same constants.

`alpha8(alpha, depth, layout)` brings an alpha plane of that depth to 8
bits as libavif does beside each route: Y >> (depth - 8) where libyuv
converts the alpha with the colour (10-bit 4:4:4 / 4:2:2 / 4:2:0, 12-bit
4:4:4 / 4:2:2), libavif's float rounding (a / (2^depth - 1) * 255 + 0.5,
truncated) where it does not (4:0:0, 12-bit 4:2:0). The un-premultiply
then runs on the 8-bit RGBA."""
from __future__ import annotations

import numpy as np

from . import avif_reformat

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
# chroma-derived NCL (12) by colour primaries, as libavif hands it to libyuv
_DERIVED = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}


def libyuv_matrix(matrix: int, primaries: int, mono: bool):
    """The matrix whose libyuv constants libavif takes for the image, or
    None where it converts on its own."""
    if matrix == avif_reformat.CHROMA_DERIVED_NCL:
        return _DERIVED.get(primaries)
    if matrix == avif_reformat.IDENTITY and mono:
        return 6
    return matrix if matrix in _FAMILY else None


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


def yuv444_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int,
                  depth: int = 8) -> np.ndarray:
    """libyuv YuvPixel (YuvPixel10 / YuvPixel12 at `depth` 10 / 12) over
    whole planes -> (H, W, 3) uint8."""
    if matrix not in _FAMILY:
        raise ValueError(f"libyuv has no constants for matrix coefficients {matrix}")
    yg, yb, ub, ug, vg, vr = _CONSTANTS[(_FAMILY[matrix], int(bool(full)))]
    bb, bg, br = ub * 128 - yb, ug * 128 + vg * 128 + yb, vr * 128 - yb
    y = y.astype(np.int64)
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    if depth == 8:
        y32 = y * 0x0101
    else:  # the luma widened to 16 bits, the chroma cut to 8
        y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
        u = np.minimum(u >> (depth - 8), 255)
        v = np.minimum(v >> (depth - 8), 255)
    y1 = ((y32 * yg) & 0xFFFFFFFF) >> 16
    b = y1 + u * ub - bb
    g = y1 + bg - (u * ug + v * vg)
    r = y1 + v * vr - br
    return np.clip(np.stack([r, g, b], -1) >> 6, 0, 255).astype(np.uint8)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int,
                  depth: int = 8) -> np.ndarray:
    h, w = y.shape
    return yuv444_to_rgb(y, upsample(u, w, h), upsample(v, w, h), matrix, full, depth)


def yuv422_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int,
                  depth: int = 8) -> np.ndarray:
    w = y.shape[1]
    return yuv444_to_rgb(y, np.stack([_up_linear(r, w) for r in u]), np.stack([_up_linear(r, w) for r in v]),
                         matrix, full, depth)


def _grey_table(full: int, depth: int) -> np.ndarray:
    f = np.float32
    y = np.arange(1 << depth, dtype=f)
    scale = 1 << (depth - 8)
    unorm = y / f((1 << depth) - 1) if full else (y - f(16 * scale)) / f(219 * scale)
    return (f(0.5) + np.clip(unorm, f(0), f(1)) * f(255)).astype(np.uint8)


_GREY = {(full, depth): _grey_table(full, depth) for full in (0, 1) for depth in (8, 10, 12)}


def yuv400_to_rgb(y: np.ndarray, full: int, depth: int = 8) -> np.ndarray:
    return np.repeat(_GREY[(int(bool(full)), depth)][y][..., None], 3, -1)


def downshift(plane, depth: int):
    """libyuv's Convert16To8Plane at libavif's scale: a plane of `depth`
    bits -> uint8 (None stays None)."""
    return None if plane is None else (plane >> (depth - 8)).astype(np.uint8)


def _alpha_table(depth: int) -> np.ndarray:
    f = np.float32
    a = np.arange(1 << depth, dtype=f)
    return (f(0.5) + a / f((1 << depth) - 1) * f(255)).astype(np.uint8)


_ALPHA = {depth: _alpha_table(depth) for depth in (10, 12)}


def alpha8(alpha: np.ndarray, depth: int, ss) -> np.ndarray:
    """An alpha plane of `depth` bits -> uint8, as libavif brings it beside
    the colour of layout `ss` (None for 4:0:0): shifted where libyuv
    converts it, rounded in float where libavif does."""
    if depth == 8:
        return alpha
    if ss is None or (depth == 12 and tuple(ss) == (1, 1)):
        return _ALPHA[depth][alpha]
    return downshift(alpha, depth)


def alpha_bytes(alpha: np.ndarray, depth: int, ss, matrix: int, primaries: int = 2) -> np.ndarray:
    """The alpha channel of the 8-bit RGBA libavif writes for an image of
    that layout (`ss` None for 4:0:0) and matrix: alpha8 beside libyuv's
    routes, avifReformatAlpha's float rounding beside libavif's own."""
    if depth == 8 or libyuv_matrix(matrix, primaries, ss is None) is not None:
        return alpha8(alpha, depth, ss)
    return _ALPHA[depth][alpha]


def to_rgb(y: np.ndarray, u, v, ss, matrix: int, full: int, rgba: bool = False, depth: int = 8,
           primaries: int = 2, alpha=None) -> np.ndarray:
    """Planes of any layout (`ss` the subsampling, u / v None for 4:0:0)
    and depth (8, 10, 12) -> (H, W, 3) uint8; `rgba` where the image has
    alpha (PIL asks libavif for RGBA); `primaries` the nclx colour
    primaries (they pick matrix 12's coefficients); `alpha` the alpha
    plane at the depth where the colour is premultiplied, which the result
    is un-premultiplied by. A matrix libavif refuses raises DecodeError."""
    layout = None if u is None else ss
    avif_reformat.check(matrix, layout, depth, full)
    if u is None and not rgba:
        return yuv400_to_rgb(y, full, depth)
    lib = libyuv_matrix(matrix, primaries, u is None)
    if lib is None and alpha is not None and avif_reformat.uses_slow_path(matrix, layout, depth, full):
        return avif_reformat.to_rgb(y, u, v, layout, matrix, full, depth, primaries, alpha)  # un-premultiplied there
    if lib is None:
        rgb = avif_reformat.to_rgb(y, u, v, layout, matrix, full, depth, primaries)
    else:
        rgb = _libyuv_rgb(y, u, v, ss, lib, full, rgba, depth)
    return rgb if alpha is None else unpremultiply(rgb, alpha_bytes(alpha, depth, layout, matrix, primaries))


def _libyuv_rgb(y: np.ndarray, u, v, ss, matrix: int, full: int, rgba: bool, depth: int) -> np.ndarray:
    """libavif's libyuv routes for a matrix libyuv takes."""
    if depth == 12 and rgba and u is not None and tuple(ss) == (1, 1):  # I012ToARGBMatrix: nearest chroma
        h, w = y.shape
        u, v = (np.repeat(np.repeat(c, 2, 0), 2, 1)[:h, :w] for c in (u, v))
        return yuv444_to_rgb(y, u, v, matrix, full, depth)
    if depth > 8 and not (depth == 10 and rgba and u is not None):  # every other route but libyuv's 10-bit
        y, u, v, depth = downshift(y, depth), downshift(u, depth), downshift(v, depth), 8
    if u is None:
        u = v = np.full_like(y, 128)
        return yuv444_to_rgb(y, u, v, matrix, full)
    convert = {(1, 1): yuv420_to_rgb, (1, 0): yuv422_to_rgb, (0, 0): yuv444_to_rgb}[tuple(ss)]
    return convert(y, u, v, matrix, full, depth)


_RECIP = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 256)], np.int64)


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    a = alpha.astype(np.int64)[..., None]
    v = (rgb.astype(np.int64) * 257 * _RECIP[a]) >> 16
    out = np.where(v > 32767, 0, np.minimum(v, 255))
    return np.where(a == 255, rgb, out).astype(np.uint8)
