"""JPEG 2000 reconstruction of one tile, as OpenJPEG 2.5 does it: the
code-blocks' values put in place (ROI max-shift undone, then halved toward
zero on the reversible path or scaled by half the band's step on the
irreversible one), the inverse 5/3 in integers and the inverse 9/7 in
float32 with OpenJPEG's constants and order (rows, then columns, each
resolution; its 2/K on the high band, its one-sample cases), RCT / ICT,
then the DC level shift with lrintf and the clamp to the precision."""
from __future__ import annotations

import numpy as np

_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_ALPHA, _BETA = np.float32(-1.586134342), np.float32(-0.052980118)
_GAMMA, _DELTA = np.float32(0.882911075), np.float32(0.443506852)


def band_stepsize(prec: int, bandno: int, qmfbid: int, expn: int, mant: int) -> np.float32:
    """opj_tcd_init_tile's Delta_b, in float32 (no sub-band gain on the
    irreversible path, where the 9/7 scales its high bands by 2/K)."""
    gain = 0 if qmfbid == 0 else (0 if bandno == 0 else 2 if bandno == 3 else 1)
    return np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec + gain - expn))


def place(vals: np.ndarray, roishift: int, qmfbid: int, stepsize: np.float32) -> np.ndarray:
    """One code-block's tier-1 values -> what OpenJPEG writes into the tile."""
    v = vals.astype(np.int64)
    if roishift:
        if roishift >= 31:
            v = np.zeros_like(v)
        else:
            mag = np.abs(v)
            big = mag >= (1 << roishift)
            v = np.where(big, np.sign(v) * (mag >> roishift), v)
    if qmfbid == 1:
        return (np.sign(v) * (np.abs(v) >> 1)).astype(np.int32)
    return v.astype(np.int32).astype(np.float32) * (np.float32(0.5) * stepsize)


def _neighbours(n: int, pos: np.ndarray):
    left = pos - 1
    right = pos + 1
    left = np.where(left < 0, right, left)
    right = np.where(right >= n, left, right)
    return left, right


def _interleave(a: np.ndarray, sn: int, cas: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows of [low | high] -> rows of the interleaved signal, and the low
    and high positions."""
    n = a.shape[1]
    lows = np.arange(cas, n, 2)
    highs = np.arange(1 - cas, n, 2)
    x = np.empty_like(a)
    x[:, lows] = a[:, :sn]
    x[:, highs] = a[:, sn:]
    return x, lows, highs


def _idwt53_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    if n == 1:
        return (np.sign(a) * (np.abs(a) // 2)).astype(a.dtype) if cas else a  # C's `/= 2`
    x, lows, highs = _interleave(a.astype(np.int64), sn, cas)
    l, r = _neighbours(n, lows)
    x[:, lows] -= (x[:, l] + x[:, r] + 2) >> 2
    l, r = _neighbours(n, highs)
    x[:, highs] += (x[:, l] + x[:, r]) >> 1
    return x.astype(a.dtype)


def _idwt97_rows(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return a
    x, lows, highs = _interleave(a, sn, cas)
    x[:, lows] *= _K
    x[:, highs] *= _TWO_INV_K
    for pos, c in ((lows, -_DELTA), (highs, -_GAMMA), (lows, -_BETA), (highs, -_ALPHA)):
        l, r = _neighbours(n, pos)
        x[:, pos] += (x[:, l] + x[:, r]) * np.float32(c)
    return x


def idwt(buf: np.ndarray, res_boxes: list, reversible: bool) -> np.ndarray:
    """buf: the tile-component with each resolution's sub-bands in place
    (LL top left, HL right of it, LH below, HH diagonal); res_boxes: the
    (x0, y0, x1, y1) of each resolution. -> the full-resolution samples."""
    rows = _idwt53_rows if reversible else _idwt97_rows
    for r in range(1, len(res_boxes)):
        px0, py0, px1, py1 = res_boxes[r - 1]
        x0, y0, x1, y1 = res_boxes[r]
        rw, rh = x1 - x0, y1 - y0
        if rw and rh:
            buf[:rh, :rw] = rows(buf[:rh, :rw], px1 - px0, x0 % 2)
            buf[:rh, :rw] = rows(buf[:rh, :rw].T, py1 - py0, y0 % 2).T
    return buf


def mct(comps: list, reversible: bool) -> None:
    """The inverse RCT (integers) or ICT (float32) on the first three
    components, in place."""
    if reversible:
        y, u, v = (comps[i].astype(np.int64) for i in range(3))
        g = y - ((u + v) >> 2)
        comps[0], comps[1], comps[2] = (c.astype(np.int32) for c in (v + g, g, u + g))
    else:
        y, u, v = comps[:3]
        comps[0] = y + v * np.float32(1.402)
        comps[1] = (y - u * np.float32(0.34413)) - v * np.float32(0.71414)
        comps[2] = y + u * np.float32(1.772)


def level_shift(c: np.ndarray, prec: int, sgnd: bool, reversible: bool) -> np.ndarray:
    """DC level shift and clamp to the component's range (int64 out)."""
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    shift = 0 if sgnd else 1 << (prec - 1)
    if reversible:
        return np.clip(c.astype(np.int64) + shift, lo, hi)
    f = c.astype(np.float32)
    with np.errstate(invalid="ignore"):
        big = f > np.float32(2147483647)
        small = f < np.float32(-2147483648)
        r = np.rint(np.where(big | small | np.isnan(f), 0, f)).astype(np.int64)
    out = np.clip(r + shift, lo, hi)
    out[big] = hi
    out[small] = lo
    return out
