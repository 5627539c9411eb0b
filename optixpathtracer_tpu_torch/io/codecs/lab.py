"""CIELAB -> RGB as PIL converts its LAB mode: LittleCMS's transform from
its built-in Lab profile (D50) to its built-in sRGB profile, perceptual,
8 bits in and out, rebuilt step by step.

PIL keeps a* and b* offset by 128 (its LAB unpacker flips their sign bit),
so the bytes of a TIFF's signed a* and b* reach LittleCMS as 8-bit Lab,
and PSD's unsigned ones as they are. LittleCMS widens each byte to 16 bits
(v * 257) and optimises the 16-bit pipeline into a 33-point grid, sampled
where `_cmsQuantizeVal` puts its nodes, then interpolated tetrahedrally in
16.16 fixed point; the result narrows to 8 bits as (v * 65281 + 2^23) >> 24.
The pipeline at each node is LittleCMS's float one: Lab -> XYZ (D50, in
doubles, stored as float32 over 1 + 32767/32768), the inverse of the sRGB
colorant matrix (LittleCMS's own values and its cofactor inverse, scaled by
that same constant; float32 out), then the inverse of the sRGB tone curve
(parametric type -4), saturated to 16 bits with LittleCMS's rounding.
Numpy over the whole grid; the table is built at its first use."""
from __future__ import annotations

import numpy as np

_N = 33
_MAX_XYZ = 1.0 + 32767.0 / 32768.0
# LittleCMS's sRGB colorants (D65 Rec. 709 primaries adapted to D50 by
# Bradford), as its cmsCreate_sRGBProfile stores them: columns R, G, B
_RGB2XYZ = ((0.43604125161605084, 0.3851129107981557, 0.14304583758579362),
            (0.22248454022947742, 0.7169050786084579, 0.060610381162065304),
            (0.013920187471375375, 0.09706723869712407, 0.713912573831501))
_SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_table = None


def _inverse(a):
    """_cmsMAT3inverse: the cofactor inverse, in doubles, as LittleCMS
    computes it."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return ((c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord(d): d + 0.5, clamped, floored the way its
    fixed-point trick floors (to the nearest 2^-16 first)."""
    d = d + 0.5
    fl = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, fl)).astype(np.int64)


def _pipeline(lab16: np.ndarray) -> np.ndarray:
    """(..., 3) 16-bit Lab (V4 encoding) -> (..., 3) 16-bit sRGB, through
    LittleCMS's float pipeline."""
    x = (lab16.astype(np.float64) / 65535.0).astype(np.float32).astype(np.float64)
    L, a, b = x[..., 0] * 100.0, x[..., 1] * 255.0 - 128.0, x[..., 2] * 255.0 - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + 0.002 * a
    fz = fy - 0.005 * b

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = [(f_1(t) * w / _MAX_XYZ).astype(np.float32).astype(np.float64)
           for t, w in ((fx, 0.9642), (fy, 1.0), (fz, 0.8249))]
    inv = _inverse(_RGB2XYZ)
    out = []
    g, p1, p2, p3, p4 = _SRGB
    disc = (p1 * p4 + p2) ** g
    for i in range(3):
        m = [v * _MAX_XYZ for v in inv[i]]
        r = ((xyz[0] * m[0] + xyz[1] * m[1]) + xyz[2] * m[2]).astype(np.float32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            v = np.where(r >= disc, (np.power(np.maximum(r, 0), 1.0 / g) - p2) / p1, r / p3)
        out.append(_saturate_word(v.astype(np.float32).astype(np.float64) * 65535.0))
    return np.stack(out, -1)


def _grid() -> np.ndarray:
    global _table
    if _table is None:
        q = np.floor(np.arange(_N) * 65535.0 / (_N - 1) + 0.5).astype(np.int64)
        nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1)
        _table = _pipeline(nodes)
    return _table


def _tetrahedral(inp: np.ndarray, table: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 over the (33, 33, 33, 3) grid: (n, 3) 16-bit in.
    The cell's corners from (0,0,0) to (1,1,1) step along the axes in the
    order of their rests (LittleCMS's six cases, its ties included)."""
    inp = inp.astype(np.int64)
    a = inp * (_N - 1)
    f = a + (a + 0x7FFF) // 0xFFFF
    i0, r = f >> 16, f & 0xFFFF
    step = (inp != 0xFFFF) * np.array([_N * _N, _N, 1], np.int64)  # the last node has no next one
    flat = table.reshape(-1, 3)
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    # the axis order of each case: x >= y >= z; z > x >= y; x > z > y; y > x >= z; y >= z > x; z > y > x
    case = np.where(rx >= ry, np.where(ry >= rz, 0, np.where(rz >= rx, 1, 2)),
                    np.where(rx >= rz, 3, np.where(ry >= rz, 4, 5)))
    order = np.array([[0, 1, 2], [2, 0, 1], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 1, 0]])[case]
    steps = np.take_along_axis(step, order, 1)
    rests = np.take_along_axis(r, order, 1)
    pos = i0[:, 0] * (_N * _N) + i0[:, 1] * _N + i0[:, 2]
    prev = flat[pos]
    out = prev.copy()
    rest = np.full_like(prev, 0x8001)
    for k in range(3):
        pos = pos + steps[:, k]
        v = flat[pos]
        rest += (v - prev) * rests[:, k:k + 1]
        prev = v
    return out + ((rest + (rest >> 16)) >> 16)


def lab_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 Lab as PIL's LAB mode holds it (L, a + 128, b + 128)
    -> (..., 3) uint8 RGB, bit for bit as PIL's convert("RGB")."""
    lab = np.asarray(lab, np.uint8)
    out16 = _tetrahedral(lab.reshape(-1, 3).astype(np.int64) * 257, _grid())
    return ((out16 * 65281 + 8388608) >> 24).astype(np.uint8).reshape(lab.shape)
