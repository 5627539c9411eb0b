"""libavif 1.3's avifImageScale, as PIL's libavif runs it: libyuv's
ScalePlane (8 bits) and ScalePlane_12 (10 and 12 bits) in box filter mode
on each plane, for a frame of another size than its item's `ispe` (or its
track's `tkhd`) and an alpha plane of another size than the colour.

libyuv first reduces the filter (box to bilinear where an axis scales to
half or more, bilinear to linear where the height stays or shrinks by 3,
linear to none where the width does) and then takes one path by size, each
ported here with its own rounding:
- the same size: a copy; the same width: rows blended vertically;
- exactly 3/4, 1/2, 3/8 and 1/4 down: their fixed box and 3:1 row
  filters;
- below half in both axes: box sums over 16.16-stepped boxes, scaled by
  65536 / area;
- exactly twice up (one more or not): the 9-3-3-1 (or 3-1) filters;
- otherwise bilinear, up (columns first, then rows) or down (rows first,
  then columns), stepping in 16.16 from libyuv's ScaleSlope start; or
  point sampling.
The column filter of 8-bit planes is libyuv's SSSE3 one, which weighs the
two samples by 7-bit fractions (what PIL's libavif runs on x86-64); the
16-bit planes take libyuv's C filter, with 16-bit fractions. Plain numpy
on the host: this is not a device kernel."""
from __future__ import annotations

import numpy as np

NONE, LINEAR, BILINEAR, BOX = 0, 1, 2, 3  # libyuv's FilterMode


def _filter_reduce(sw: int, sh: int, dw: int, dh: int, filtering: int) -> int:
    """libyuv's ScaleFilterReduce."""
    if filtering == BOX and (dw * 2 >= sw or dh * 2 >= sh):
        filtering = BILINEAR
    if filtering == BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            filtering = LINEAR
        if sw == 1:
            filtering = NONE
    if filtering == LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        filtering = NONE
    return filtering


def _fixed_div(num: int, div: int) -> int:
    return (num << 16) // div


def _fixed_div1(num: int, div: int) -> int:
    return ((num << 16) - 0x00010001) // (div - 1)


def _slope(sw: int, sh: int, dw: int, dh: int, filtering: int):
    """libyuv's ScaleSlope -> (x, y, dx, dy), 16.16."""
    x = y = dx = dy = 0
    if filtering == BOX:
        return 0, 0, _fixed_div(sw, dw), _fixed_div(sh, dh)
    if filtering in (BILINEAR, LINEAR):
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = (dx >> 1) - 32768
        elif sw > 1 and dw > 1:
            dx = _fixed_div1(sw, dw)
        if filtering == LINEAR:
            dy = _fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = _fixed_div(sh, dh)
            y = (dy >> 1) - 32768
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        return x, y, dx, dy
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    return dx >> 1, dy >> 1, dx, dy


def _cols(rows: np.ndarray, dw: int, x: int, dx: int, wide: bool) -> np.ndarray:
    """ScaleFilterCols: each output column between two source samples."""
    xs = x + dx * np.arange(dw, dtype=np.int64)
    xi = xs >> 16
    a = rows[:, xi]
    b = rows[:, np.minimum(xi + 1, rows.shape[1] - 1)]
    if wide:  # ScaleFilterCols_16_C
        return a + (((xs & 0xFFFF) * (b - a) + 0x8000) >> 16)
    f = (xs >> 9) & 0x7F  # ScaleFilterCols_SSSE3
    return (a * (128 - f) + b * f + 64) >> 7


def _blend(r0: np.ndarray, r1: np.ndarray, f) -> np.ndarray:
    """InterpolateRow: r0 and r1 weighed (256 - f, f) / 256."""
    f = np.asarray(f, np.int64)
    return np.where(f == 0, r0, (r0 * (256 - f) + r1 * f + 128) >> 8)


def _bilinear_down(src, dw, dh, filtering, wide):
    sh = src.shape[0]
    x, y, dx, dy = _slope(src.shape[1], sh, dw, dh, filtering)
    max_y = (sh - 1) << 16
    ys = np.minimum(y + dy * np.arange(dh, dtype=np.int64), max_y)
    yi = ys >> 16
    rows = src[yi]
    if filtering != LINEAR:
        rows = _blend(rows, src[np.minimum(yi + 1, sh - 1)], ((ys >> 8) & 255)[:, None])
    return _cols(rows, dw, x, dx, wide)


def _bilinear_up(src, dw, dh, filtering, wide):
    sh = src.shape[0]
    x, y, dx, dy = _slope(src.shape[1], sh, dw, dh, filtering)
    cols = _cols(src, dw, x, dx, wide) if filtering else src[:, (x + dx * np.arange(dw, dtype=np.int64)) >> 16]
    ys = np.minimum(y + dy * np.arange(dh, dtype=np.int64), (sh - 1) << 16)
    yi = ys >> 16
    if filtering == LINEAR:
        return cols[yi]
    return _blend(cols[yi], cols[np.minimum(yi + 1, sh - 1)], ((ys >> 8) & 255)[:, None])


def _vertical(src, dh, filtering):
    sh = src.shape[0]
    dy, y = 0, 0
    if dh <= sh:
        dy = _fixed_div(sh, dh)
        y = (dy >> 1) - 32768
    elif sh > 1 and dh > 1:
        dy = _fixed_div1(sh, dh)
    max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
    ys = np.minimum(y + dy * np.arange(dh, dtype=np.int64), max_y)
    yi = ys >> 16
    yf = ((ys >> 8) & 255) if filtering else np.zeros_like(ys)
    return _blend(src[yi], src[np.minimum(yi + 1, sh - 1)], yf[:, None])


def _box(src, dw, dh, wide):
    sh, sw = src.shape
    _, _, dx, dy = _slope(sw, sh, dw, dh, BOX)
    ys = np.minimum(dy * np.arange(dh + 1, dtype=np.int64), sh << 16)
    iy = ys[:-1] >> 16
    bh = np.maximum((ys[1:] >> 16) - iy, 1)
    xs = dx * np.arange(dw + 1, dtype=np.int64)
    ix = xs[:-1] >> 16
    bw = np.maximum((xs[1:] >> 16) - ix, 1)
    sums = np.zeros((sh + 1, sw + 1), np.int64)
    sums[1:, 1:] = src.cumsum(0).cumsum(1)
    y0, y1, x0, x1 = iy[:, None], (iy + bh)[:, None], ix[None], (ix + bw)[None]
    total = sums[y1, x1] - sums[y0, x1] - sums[y1, x0] + sums[y0, x0]
    min_w = dx >> 16
    scale = np.where(bw[None] == min_w, 65536 // (max(min_w, 1) * bh[:, None]),
                     65536 // (max(min_w + 1, 1) * bh[:, None]))
    return ((total * scale) & 0xFFFFFFFF) >> 16


def _down2(src):
    s = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]
    return (s + 2) >> 2


def _down4(src):
    h, w = src.shape
    return (src.reshape(h // 4, 4, w // 4, 4).sum((1, 3)) + 8) >> 4


def _avg(a, b):
    return (a + b + 1) >> 1  # pavgb


def _down34(src, dh, filtering, wide):
    """ScalePlaneDown34: columns 3:1, 1:1 and 1:3 within each 4, rows 3:1,
    1:1 and 1:3 between two source rows. On 8-bit planes the SSSE3 rows
    (every 24 output columns; the rest C) blend the rows first, by pavgb,
    where the C rows blend the filtered columns."""
    dw = src.shape[1] * 3 // 4
    simd = 0 if wide else dw // 24 * 24

    def cols(r):
        r = r.reshape(-1, 4)
        return np.stack([(r[:, 0] * 3 + r[:, 1] + 2) >> 2, (r[:, 1] + r[:, 2] + 1) >> 1,
                         (r[:, 2] + r[:, 3] * 3 + 2) >> 2], 1).reshape(-1)

    def row0(s, t):  # ScaleRowDown34_0_Box: 3:1
        c = (cols(s) * 3 + cols(t) + 2) >> 2
        c[:simd] = cols(_avg(s, _avg(s, t)))[:simd]
        return c

    def row1(s, t):  # ScaleRowDown34_1_Box: 1:1
        c = (cols(s) + cols(t) + 1) >> 1
        c[:simd] = cols(_avg(s, t))[:simd]
        return c
    linear = filtering == LINEAR
    out, at = [], 0
    for _ in range(0, dh - 2, 3):
        out.append(row0(src[at], src[at if linear else at + 1]))
        out.append(row1(src[at + 1], src[at + 2]))
        out.append(row0(src[at + 3], src[at + 3 if linear else at + 2]))
        at += 4
    if dh % 3 == 2:
        out.append(row0(src[at], src[at if linear else at + 1]))
        out.append(row1(src[at + 1], src[at + 1]))
    elif dh % 3 == 1:
        out.append(row0(src[at], src[at]))
    return np.stack(out)


def _down38(src, dh, filtering, wide):
    """ScalePlaneDown38 with box rows: boxes of 3, 3 and 2 columns in each
    8, over 3, 3 and 2 rows (the last rows of an odd height over one),
    scaled by 65536 / area. The 8-bit SSSE3 two-row box (every 6 output
    columns; the rest C) averages the rows by pavgb first."""
    dw = src.shape[1] * 3 // 8
    simd = 0 if wide else dw // 6 * 6

    def boxes(rows, weights=None):
        n = len(rows)
        r = sum(rows).reshape(-1, 8)
        c = np.stack([(r[:, 0:3].sum(1) * (65536 // (3 * n))) >> 16, (r[:, 3:6].sum(1) * (65536 // (3 * n))) >> 16,
                      (r[:, 6:8].sum(1) * (65536 // (2 * n))) >> 16], 1).reshape(-1)
        if n == 2:
            a = _avg(rows[0], rows[1]).reshape(-1, 8)
            c[:simd] = np.stack([(a[:, 0:3].sum(1) * (65536 // 3)) >> 16, (a[:, 3:6].sum(1) * (65536 // 3)) >> 16,
                                 (a[:, 6:8].sum(1) * (65536 // 2)) >> 16], 1).reshape(-1)[:simd]
        return c
    linear = filtering == LINEAR
    out, at = [], 0

    def three():
        return boxes([src[at]] * 3 if linear else [src[at], src[at + 1], src[at + 2]])
    for _ in range(0, dh - 2, 3):
        out.append(three())
        at += 3
        out.append(three())
        at += 3
        out.append(boxes([src[at]] * 2 if linear else [src[at], src[at + 1]]))
        at += 2
    if dh % 3 == 2:
        out.append(three())
        at += 3
        out.append(boxes([src[at]] * 3))
    elif dh % 3 == 1:
        out.append(boxes([src[at]] * 3))
    return np.stack(out)


def _up2_row(s: np.ndarray, dw: int) -> np.ndarray:
    """ScaleRowUp2_Linear_Any: the ends copied, each pair between two
    samples 3:1 and 1:3."""
    out = np.empty(s.shape[:-1] + (dw,), np.int64)
    out[..., 0] = s[..., 0]
    n = (dw - 1) // 2
    out[..., 1:2 * n + 1:2] = (s[..., :n] * 3 + s[..., 1:n + 1] + 2) >> 2
    out[..., 2:2 * n + 2:2] = (s[..., :n] + s[..., 1:n + 1] * 3 + 2) >> 2
    out[..., -1] = s[..., (dw - 1) // 2]
    return out


def _up2_linear(src, dw, dh):
    sh = src.shape[0]
    if dh == 1:
        rows = [(sh - 1) // 2]
    else:
        dy = _fixed_div(sh - 1, dh - 1)
        rows = ((1 << 15) - 1 + dy * np.arange(dh, dtype=np.int64)) >> 16
    return _up2_row(src[rows], dw)


def _up2_bilinear(src, dw, dh):
    """ScalePlaneUp2_Bilinear: rows 3:1 and 1:3 between source rows (the
    first and, for an even height, the last row from one source row), each
    row's columns as _up2_row but 9-3-3-1 inside."""
    sh, sw = src.shape
    pairs = [(0, 0)] + [(k, k + 1) for k in range(sh - 1)] + ([(sh - 1, sh - 1)] if dh % 2 == 0 else [])
    out = []
    for i, (a, b) in enumerate(pairs):
        s, t = src[a], src[b]
        rows = _up2_pair(s, t, dw)
        out += [rows[1]] if i == 0 else [rows[0]] if i == len(pairs) - 1 and dh % 2 == 0 else list(rows)
    return np.stack(out[:dh])


def _up2_pair(s, t, dw):
    """ScaleRowUp2_Bilinear_Any_C: two output rows, near s and near t."""
    n = (dw - 1) // 2
    d = np.empty(dw, np.int64)
    e = np.empty(dw, np.int64)
    d[0] = (3 * s[0] + t[0] + 2) >> 2
    e[0] = (s[0] + 3 * t[0] + 2) >> 2
    s0, s1, t0, t1 = s[:n], s[1:n + 1], t[:n], t[1:n + 1]
    d[1:2 * n + 1:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
    d[2:2 * n + 2:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
    e[1:2 * n + 1:2] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
    e[2:2 * n + 2:2] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
    last = (dw - 1) // 2
    d[-1] = (3 * s[last] + t[last] + 2) >> 2
    e[-1] = (s[last] + 3 * t[last] + 2) >> 2
    return d, e


def scale_plane(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """libyuv's ScalePlane (uint8) or ScalePlane_12 (uint16) of `src` to
    width x height in box filter mode."""
    sh, sw = src.shape
    dtype, wide = src.dtype, src.dtype != np.uint8
    if (sw, sh) == (width, height):
        return src.copy()
    f = _filter_reduce(sw, sh, width, height, BOX)
    s = src.astype(np.int64)
    if width == sw and f != BOX:
        out = _vertical(s, height, f)
    elif width <= sw and height <= sh and 4 * width == 3 * sw and 4 * height == 3 * sh:
        out = _down34(s, height, f, wide)
    elif width <= sw and height <= sh and 2 * width == sw and 2 * height == sh:
        out = _down2(s)
    elif width <= sw and height <= sh and 8 * width == 3 * sw and 8 * height == 3 * sh:
        out = _down38(s, height, f, wide)
    elif width <= sw and height <= sh and 4 * width == sw and 4 * height == sh and f in (BOX, NONE):
        out = _down4(s)
    elif f == BOX and height * 2 < sh:
        out = _box(s, width, height, wide)
    elif (width + 1) // 2 == sw and f == LINEAR:
        out = _up2_linear(s, width, height)
    elif (height + 1) // 2 == sh and (width + 1) // 2 == sw and f in (BILINEAR, BOX):
        out = _up2_bilinear(s, width, height)
    elif f and height > sh:
        out = _bilinear_up(s, width, height, f, wide)
    elif f:
        out = _bilinear_down(s, width, height, f, wide)
    else:
        x, y, dx, dy = _slope(sw, sh, width, height, NONE)
        out = s[((y + dy * np.arange(height, dtype=np.int64)) >> 16)[:, None],
                ((x + dx * np.arange(width, dtype=np.int64)) >> 16)[None]]
    return out.astype(dtype)


def scale(y, u, v, ss, width: int, height: int):
    """avifImageScale's YUV planes: Y to width x height, U and V to the
    subsampled size of it ((width + ssx) >> ssx, ...); U / V None for 4:0:0."""
    if u is None:
        return scale_plane(y, width, height), None, None
    sx, sy = ss
    cw, ch = (width + sx) >> sx, (height + sy) >> sy
    return scale_plane(y, width, height), scale_plane(u, cw, ch), scale_plane(v, cw, ch)
