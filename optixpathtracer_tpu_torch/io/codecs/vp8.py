"""VP8 key frames, WebP's lossy bitstream, decoded to Y'CbCr 4:2:0 as RFC
6386 specifies (and libwebp's vp8_dec.c, tree_dec.c, quant_dec.c and
frame_dec.c decode it, bit for bit).

The boolean entropy decoder; the frame header (segments with their
quantiser and filter levels, the simple and normal loop filters with
sharpness and mode / reference deltas, one to eight token partitions, the
token probability updates, the skip probability); per macroblock the
segment, the skip flag and the intra modes (16x16 DC / V / H / TM, or
sixteen 4x4 modes with their above / left contexts; chroma DC / V / H /
TM); the DCT tokens with their bands, contexts and extra-bit categories,
dequantised and, for 16x16 macroblocks, the DC through the inverse WHT;
the inverse DCT; intra prediction from the unfiltered neighbours (127
above the frame, 129 left of it); then the loop filter over the whole
frame in macroblock order.

The entropy decoding is a sequential host loop; the inverse transforms run
over every block of the frame at once in numpy, the prediction per
macroblock (per 4x4 block where it depends on the block before it), the
loop filter per edge across its 16 (or 8) positions."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError
from .vp8_tables import AC_TABLE, BMODES_PROBA, COEFFS_PROBA0, COEFFS_UPDATE_PROBA, DC_TABLE

DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3  # also the 4x4 modes B_DC, B_TM, B_VE, B_HE
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 mode tree: a leaf is -mode (0: B_DC), a node the index of its pair
_YMODES4 = (0, 1, -TM_PRED, 2, -V_PRED, 3, 4, 6, -H_PRED, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_NORM = [0] + [7 - int(np.log2(r)) for r in range(1, 256)]  # shifts that bring a range back to >= 128


class BoolDecoder:
    """RFC 6386 section 7: `bit(prob)` with prob in 1-255 (of 256) for a 0."""

    def __init__(self, data: bytes):
        self.data = data
        self.value = (data[0] << 8 | data[1]) if len(data) >= 2 else (data[0] << 8 if data else 0)
        self.pos = 2
        self.range = 255
        self.count = 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            b = 1
        else:
            self.range = split
            b = 0
        if self.range < 128:
            shift = _NORM[self.range]
            self.range <<= shift
            self.value <<= shift
            self.count += shift
            if self.count >= 8:
                self.count -= 8
                p = self.pos
                self.value |= (self.data[p] if p < len(self.data) else 0) << self.count
                self.pos = p + 1
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def optional_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else hi if v > hi else v


def _large_value(bd: BoolDecoder, p) -> int:
    if not bd.bit(p[3]):
        if not bd.bit(p[4]):
            return 2
        return 3 + bd.bit(p[5])
    if not bd.bit(p[6]):
        if not bd.bit(p[7]):
            return 5 + bd.bit(159)
        v = 7 + 2 * bd.bit(165)
        return v + bd.bit(145)
    bit1 = bd.bit(p[8])
    bit0 = bd.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT[cat]:
        v += v + bd.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(bd: BoolDecoder, bands, ctx: int, dq, n: int, out: list, base: int) -> int:
    """GetCoeffs: tokens from position n into out[base + zigzag]; returns
    the position after the last nonzero coefficient (16 if none ends it)."""
    p = bands[n][ctx]
    while n < 16:
        if not bd.bit(p[0]):
            return n  # end of block
        while not bd.bit(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not bd.bit(p[2]):
            v = 1
            nxt = 1
        else:
            v = _large_value(bd, p)
            nxt = 2
        if bd.bit(128):
            v = -v
        q = v * dq[n > 0]
        out[base + _ZIGZAG[n]] = ((q + 0x8000) & 0xFFFF) - 0x8000  # libwebp stores int16
        n += 1
        if n < 16:
            p = bands[n][nxt]
    return 16


def _idct(c: np.ndarray) -> np.ndarray:
    """TransformOne on (n, 16) coefficient blocks -> (n, 4, 4) residuals
    (the >> 3 of each output; the caller adds and clips)."""
    x = c.reshape(-1, 4, 4).astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    i0, i1, i2, i3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]  # rows: the vertical pass runs down columns
    a, b = i0 + i2, i0 - i2
    cc, d = mul2(i1) - mul1(i3), mul1(i1) + mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], 1)  # t[:, k, col]
    dc = t[:, :, 0] + 4
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc, d = mul2(t[:, :, 1]) - mul1(t[:, :, 3]), mul1(t[:, :, 1]) + mul2(t[:, :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], 2) >> 3  # [:, row k, col]


def _wht(dc: list) -> list:
    """TransformWHT: the 16 Y2 values -> the DC of each 4x4 block."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        for k, v in ((0, a0 + a1), (1, a3 + a2), (2, a0 - a1), (3, a3 - a2)):
            out[4 * i + k] = (((v >> 3) + 0x8000) & 0xFFFF) - 0x8000
    return out


# ---- intra prediction on a work block: row 0 the row above (with the
# top-left at column 0 and, for luma, four top-right samples past the
# block), column 0 the column to the left -----------------------------------

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(w: np.ndarray, r: int, c: int, mode: int) -> np.ndarray:
    """The 4x4 prediction of the block whose top-left sample is w[r, c]."""
    top = w[r - 1, c - 1:c + 8].tolist()  # X, A .. H
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = w[r:r + 4, c - 1].tolist()
    if mode == DC_PRED:
        return np.full((4, 4), (A + B + C + D + I + J + K + L + 4) >> 3)
    if mode == TM_PRED:
        return np.clip(np.array([I, J, K, L])[:, None] + np.array([A, B, C, D])[None, :] - X, 0, 255)
    if mode == V_PRED:
        return np.tile([_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)], (4, 1))
    if mode == H_PRED:
        return np.repeat([[_avg3(X, I, J)], [_avg3(I, J, K)], [_avg3(J, K, L)], [_avg3(K, L, L)]], 4, 1)
    o = np.zeros((4, 4), np.int64)
    if mode == 4:  # RD, down-right
        e = [L, K, J, I, X, A, B, C, D]
        for y in range(4):
            for x in range(4):
                i = 3 - y + x + 1
                o[y, x] = _avg3(e[i - 1], e[i], e[i + 1])
    elif mode == 5:  # VR, vertical-right
        o[0, 0] = o[2, 1] = _avg2(X, A)
        o[0, 1] = o[2, 2] = _avg2(A, B)
        o[0, 2] = o[2, 3] = _avg2(B, C)
        o[0, 3] = _avg2(C, D)
        o[3, 0] = _avg3(K, J, I)
        o[2, 0] = _avg3(J, I, X)
        o[1, 0] = o[3, 1] = _avg3(I, X, A)
        o[1, 1] = o[3, 2] = _avg3(X, A, B)
        o[1, 2] = o[3, 3] = _avg3(A, B, C)
        o[1, 3] = _avg3(B, C, D)
    elif mode == 6:  # LD, down-left
        e = [A, B, C, D, E, F, G, H, H]
        for y in range(4):
            for x in range(4):
                i = x + y
                o[y, x] = _avg3(e[i], e[i + 1], e[i + 2])
    elif mode == 7:  # VL, vertical-left
        o[0, 0] = _avg2(A, B)
        o[0, 1] = o[2, 0] = _avg2(B, C)
        o[0, 2] = o[2, 1] = _avg2(C, D)
        o[0, 3] = o[2, 2] = _avg2(D, E)
        o[1, 0] = _avg3(A, B, C)
        o[1, 1] = o[3, 0] = _avg3(B, C, D)
        o[1, 2] = o[3, 1] = _avg3(C, D, E)
        o[1, 3] = o[3, 2] = _avg3(D, E, F)
        o[2, 3] = _avg3(E, F, G)
        o[3, 3] = _avg3(F, G, H)
    elif mode == 8:  # HD, horizontal-down
        o[0, 0] = o[1, 2] = _avg2(I, X)
        o[1, 0] = o[2, 2] = _avg2(J, I)
        o[2, 0] = o[3, 2] = _avg2(K, J)
        o[3, 0] = _avg2(L, K)
        o[0, 3] = _avg3(A, B, C)
        o[0, 2] = _avg3(X, A, B)
        o[0, 1] = o[1, 3] = _avg3(I, X, A)
        o[1, 1] = o[2, 3] = _avg3(J, I, X)
        o[2, 1] = o[3, 3] = _avg3(K, J, I)
        o[3, 1] = _avg3(L, K, J)
    else:  # HU, horizontal-up
        o[0, 0] = _avg2(I, J)
        o[0, 2] = o[1, 0] = _avg2(J, K)
        o[1, 2] = o[2, 0] = _avg2(K, L)
        o[0, 1] = _avg3(I, J, K)
        o[0, 3] = o[1, 1] = _avg3(J, K, L)
        o[1, 3] = o[2, 1] = _avg3(K, L, L)
        o[2, 2] = o[2, 3] = o[3, 0] = o[3, 1] = o[3, 2] = o[3, 3] = L
    return o


def _pred_block(w: np.ndarray, n: int, mode: int, has_top: bool, has_left: bool) -> np.ndarray:
    """16x16 luma or 8x8 chroma prediction from work block w (n + 1 rows)."""
    top, left, tl = w[0, 1:n + 1], w[1:n + 1, 0], int(w[0, 0])
    if mode == DC_PRED:
        shift = 4 if n == 16 else 3
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + n) >> (shift + 1)
        elif has_top:
            v = (int(top.sum()) + n // 2) >> shift
        elif has_left:
            v = (int(left.sum()) + n // 2) >> shift
        else:
            v = 128
        return np.full((n, n), v)
    if mode == V_PRED:
        return np.tile(top, (n, 1))
    if mode == H_PRED:
        return np.repeat(left[:, None], n, 1)
    return np.clip(left[:, None] + top[None, :] - tl, 0, 255)


# ---- the loop filter -------------------------------------------------------------

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip255(v):
    return np.clip(v, 0, 255)


def _edge(plane: np.ndarray, pos: int, axis: int, lo: int, hi: int, thresh: int, inner: int, hev_t: int,
          kind: str) -> None:
    """Filter the edge before sample `pos` along `axis` (0: a horizontal
    edge, filtering down columns; 1: a vertical edge), for samples lo..hi
    along it. kind: "simple", "mb" (the 6-tap edge filter) or "inner"."""
    take = (lambda k: plane[pos + k, lo:hi]) if axis == 0 else (lambda k: plane[lo:hi, pos + k])
    p3, p2, p1, p0, q0, q1, q2, q3 = (take(k).astype(np.int64) for k in range(-4, 4))
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        mask &= (np.abs(p3 - p2) <= inner) & (np.abs(p2 - p1) <= inner) & (np.abs(p1 - p0) <= inner) \
            & (np.abs(q3 - q2) <= inner) & (np.abs(q2 - q1) <= inner) & (np.abs(q1 - q0) <= inner)
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    out = {-3: p2, -2: p1, -1: p0, 0: q0, 1: q1, 2: q2}
    new = {k: v.copy() for k, v in out.items()}
    # filter 2 (simple, and high edge variance)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    m2 = mask & hev
    new[-1] = np.where(m2, _clip255(p0 + a2), new[-1])
    new[0] = np.where(m2, _clip255(q0 - a1), new[0])
    if kind == "mb":
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        w1, w2, w3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        m6 = mask & ~hev
        for k, v in ((-3, p2 + w3), (-2, p1 + w2), (-1, p0 + w1), (0, q0 - w1), (1, q1 - w2), (2, q2 - w3)):
            new[k] = np.where(m6, _clip255(v), new[k])
    elif kind == "inner":
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        m4 = mask & ~hev
        for k, v in ((-2, p1 + a3), (-1, p0 + a2), (0, q0 - a1), (1, q1 - a3)):
            new[k] = np.where(m4, _clip255(v), new[k])
    for k, v in new.items():
        if axis == 0:
            plane[pos + k, lo:hi] = v
        else:
            plane[lo:hi, pos + k] = v


def decode(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """A VP8 key frame -> (Y, U, V planes of the whole macroblocks, uint8;
    width; height)."""
    if len(data) < 10:
        raise DecodeError("truncated VP8 frame")
    tag = data[0] | data[1] << 8 | data[2] << 16
    if tag & 1:
        raise DecodeError("VP8 frame is not a key frame")
    part0 = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise DecodeError("bad VP8 start code")
    width = (data[6] | data[7] << 8) & 0x3FFF
    height = (data[8] | data[9] << 8) & 0x3FFF
    if not width or not height:
        raise DecodeError("VP8 frame without a size")
    if 10 + part0 > len(data):
        raise DecodeError("truncated VP8 first partition")
    bd = BoolDecoder(data[10:10 + part0])
    bd.literal(2)  # colour space, clamping type
    # segments
    use_segment = bd.bit(128)
    update_map, absolute, seg_q, seg_lf, seg_probs = 0, 0, [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = bd.bit(128)
        if bd.bit(128):
            absolute = bd.bit(128)
            seg_q = [bd.optional_signed(7) for _ in range(4)]
            seg_lf = [bd.optional_signed(6) for _ in range(4)]
        if update_map:
            seg_probs = [bd.literal(8) if bd.bit(128) else 255 for _ in range(3)]
    # loop filter
    simple = bd.bit(128)
    level = bd.literal(6)
    sharpness = bd.literal(3)
    use_lf_delta = bd.bit(128)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_lf_delta and bd.bit(128):
        ref_delta = [bd.signed(6) if bd.bit(128) else 0 for _ in range(4)]
        mode_delta = [bd.signed(6) if bd.bit(128) else 0 for _ in range(4)]
    filter_type = 0 if level == 0 else 1 if simple else 2
    # token partitions
    n_parts = 1 << bd.literal(2)
    pos = 10 + part0
    sizes = data[pos:pos + 3 * (n_parts - 1)]
    pos += 3 * (n_parts - 1)
    parts = []
    for p in range(n_parts):
        if p < n_parts - 1:
            sz = sizes[3 * p] | sizes[3 * p + 1] << 8 | sizes[3 * p + 2] << 16
        else:
            sz = len(data) - pos
        parts.append(BoolDecoder(data[pos:pos + sz]))
        pos += sz
    if pos > len(data):
        raise DecodeError("truncated VP8 partitions")
    # quantisers
    base_q = bd.literal(7)
    dq_y1_dc, dq_y2_dc, dq_y2_ac, dq_uv_dc, dq_uv_ac = (bd.optional_signed(4) for _ in range(5))
    quant = []
    for s in range(4):
        if use_segment:
            q = seg_q[s] + (0 if absolute else base_q)
        elif s > 0:
            quant.append(quant[0])
            continue
        else:
            q = base_q
        y2_ac = (AC_TABLE[_clip(q + dq_y2_ac, 127)] * 101581) >> 16
        quant.append(((DC_TABLE[_clip(q + dq_y1_dc, 127)], AC_TABLE[_clip(q, 127)]),
                      (DC_TABLE[_clip(q + dq_y2_dc, 127)] * 2, max(8, y2_ac)),
                      (DC_TABLE[_clip(q + dq_uv_dc, 117)], AC_TABLE[_clip(q + dq_uv_ac, 127)])))
    bd.bit(128)  # refresh_entropy_probs: one key frame, nothing to keep
    probs = []  # [type][band][ctx] -> 11 probabilities
    i = 0
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                row = []
                for _ in range(11):
                    row.append(bd.literal(8) if bd.bit(COEFFS_UPDATE_PROBA[i]) else COEFFS_PROBA0[i])
                    i += 1
                ctxs.append(row)
            bands.append(ctxs)
        probs.append([bands[_BANDS[n]] for n in range(17)])
    use_skip = bd.bit(128)
    skip_p = bd.literal(8) if use_skip else 0

    # filter strengths per segment and per (16x16, 4x4)
    fstrength = []
    for s in range(4):
        base = (seg_lf[s] + (0 if absolute else level)) if use_segment else level
        pair = []
        for i4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = _clip(lv, 63)
            if lv > 0:
                ilevel = lv
                if sharpness > 0:
                    ilevel >>= 2 if sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - sharpness)
                ilevel = max(ilevel, 1)
                pair.append((2 * lv + ilevel, ilevel, 2 if lv >= 40 else 1 if lv >= 15 else 0))
            else:
                pair.append((0, 0, 0))
        fstrength.append(pair)

    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    n_mb = mbw * mbh
    coeffs = [0] * (n_mb * 384)
    mb_i4 = [False] * n_mb
    mb_modes = [None] * n_mb
    mb_uv = [0] * n_mb
    mb_seg = [0] * n_mb
    mb_skip = [True] * n_mb
    intra_t = [DC_PRED] * (4 * mbw)
    nz_top = [0] * mbw  # bits 0-3: Y columns, 4-5: U, 6-7: V
    nz_dc_top = [0] * mbw
    for mb_y in range(mbh):
        intra_l = [DC_PRED] * 4
        nz_left, nz_dc_left = 0, 0
        tb = parts[mb_y & (n_parts - 1)]
        for mb_x in range(mbw):
            m = mb_y * mbw + mb_x
            # ---- modes, from the first partition
            seg = 0
            if update_map:
                seg = bd.bit(seg_probs[1]) if not bd.bit(seg_probs[0]) else bd.bit(seg_probs[2]) + 2
            skip = bd.bit(skip_p) if use_skip else 0
            i4 = not bd.bit(145)
            if not i4:
                ymode = (TM_PRED if bd.bit(128) else H_PRED) if bd.bit(156) else (
                    V_PRED if bd.bit(163) else DC_PRED)
                modes = [ymode]
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = BMODES_PROBA[(intra_t[4 * mb_x + x] * 10 + ym) * 9:][:9]
                        i = _YMODES4[bd.bit(prob[0])]
                        while i > 0:
                            i = _YMODES4[2 * i + bd.bit(prob[i])]
                        ym = -i
                        intra_t[4 * mb_x + x] = ym
                        modes.append(ym)
                    intra_l[y] = ym
            uvmode = DC_PRED if not bd.bit(142) else V_PRED if not bd.bit(114) else (
                TM_PRED if bd.bit(183) else H_PRED)
            mb_i4[m], mb_modes[m], mb_uv[m], mb_seg[m] = i4, modes, uvmode, seg
            # ---- residuals, from the row's token partition
            if skip:
                nz_top[mb_x] = 0
                nz_left = 0
                if not i4:
                    nz_dc_top[mb_x] = nz_dc_left = 0
                mb_skip[m] = True
                continue
            (y1, y2, uv) = quant[seg]
            base = m * 384
            nzs = []  # each block's end position: past 1, or a nonzero DC, makes the block nonzero
            if not i4:
                dc = [0] * 16
                ctx = nz_dc_top[mb_x] + nz_dc_left
                nz = _coeffs(tb, probs[1], ctx, y2, 0, dc, 0)
                nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
                if nz > 1:
                    dcs = _wht(dc)
                else:
                    dcs = [((((dc[0] + 3) >> 3) + 0x8000) & 0xFFFF) - 0x8000] * 16
                for k in range(16):
                    coeffs[base + 16 * k] = dcs[k]
                first, ac = 1, probs[0]
            else:
                first, ac = 0, probs[3]
            tnz, lnz = nz_top[mb_x], nz_left
            new_l = 0
            tcol = [(tnz >> x) & 1 for x in range(4)]
            for y in range(4):
                lft = (lnz >> y) & 1
                for x in range(4):
                    nz = _coeffs(tb, ac, lft + tcol[x], y1, first, coeffs, base + 16 * (4 * y + x))
                    nzs.append(nz)
                    lft = tcol[x] = int(nz > first)
                new_l |= lft << y
            new_t = sum(tcol[x] << x for x in range(4))
            for ch, shift in ((0, 4), (1, 6)):
                tc = [(tnz >> (shift + x)) & 1 for x in range(2)]
                for y in range(2):
                    lft = (lnz >> (shift + y)) & 1
                    for x in range(2):
                        nz = _coeffs(tb, probs[2], lft + tc[x], uv, 0, coeffs,
                                     base + 256 + 64 * ch + 16 * (2 * y + x))
                        nzs.append(nz)
                        lft = tc[x] = int(nz > 0)
                    new_l |= lft << (shift + y)
                new_t |= (tc[0] | tc[1] << 1) << shift
            nz_top[mb_x], nz_left = new_t, new_l
            mb_skip[m] = not (any(n > 1 for n in nzs) or any(coeffs[base + 16 * k] for k in range(24)))
    # ---- inverse transforms of every block at once
    res = _idct(np.array(coeffs, np.int64).reshape(-1, 16)).reshape(n_mb, 24, 4, 4)
    Y = np.zeros((mbh * 16, mbw * 16), np.int64)
    U = np.zeros((mbh * 8, mbw * 8), np.int64)
    V = np.zeros((mbh * 8, mbw * 8), np.int64)
    for mb_y in range(mbh):
        for mb_x in range(mbw):
            m = mb_y * mbw + mb_x
            y0, x0 = 16 * mb_y, 16 * mb_x
            w = np.zeros((17, 21), np.int64)
            if mb_y > 0:
                w[0, 1:17] = Y[y0 - 1, x0:x0 + 16]
                w[0, 17:21] = Y[y0 - 1, x0 + 15] if mb_x == mbw - 1 else Y[y0 - 1, x0 + 16:x0 + 20]
                w[0, 0] = Y[y0 - 1, x0 - 1] if mb_x > 0 else 129
            else:
                w[0, :] = 127
            w[1:, 0] = Y[y0:y0 + 16, x0 - 1] if mb_x > 0 else 129
            r = res[m]
            if mb_i4[m]:
                w[4, 17:21] = w[8, 17:21] = w[12, 17:21] = w[0, 17:21]
                for n in range(16):
                    by, bx = divmod(n, 4)
                    rr, cc = 1 + 4 * by, 1 + 4 * bx
                    pred = _pred4(w, rr, cc, mb_modes[m][n])
                    w[rr:rr + 4, cc:cc + 4] = np.clip(pred + r[n], 0, 255)
            else:
                mode = mb_modes[m][0]
                pred = _pred_block(w, 16, mode, mb_y > 0, mb_x > 0)
                blocks = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                w[1:17, 1:17] = np.clip(pred + blocks, 0, 255)
            Y[y0:y0 + 16, x0:x0 + 16] = w[1:17, 1:17]
            c0, d0 = 8 * mb_y, 8 * mb_x
            for plane, off in ((U, 16), (V, 20)):
                wc = np.zeros((9, 9), np.int64)
                if mb_y > 0:
                    wc[0, 1:] = plane[c0 - 1, d0:d0 + 8]
                    wc[0, 0] = plane[c0 - 1, d0 - 1] if mb_x > 0 else 129
                else:
                    wc[0, :] = 127
                wc[1:, 0] = plane[c0:c0 + 8, d0 - 1] if mb_x > 0 else 129
                pred = _pred_block(wc, 8, mb_uv[m], mb_y > 0, mb_x > 0)
                blocks = r[off:off + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[c0:c0 + 8, d0:d0 + 8] = np.clip(pred + blocks, 0, 255)
    # ---- the loop filter, macroblock by macroblock
    if filter_type:
        for mb_y in range(mbh):
            for mb_x in range(mbw):
                m = mb_y * mbw + mb_x
                limit, ilevel, hev_t = fstrength[mb_seg[m]][int(mb_i4[m])]
                if limit == 0:
                    continue
                inner = mb_i4[m] or not mb_skip[m]
                y0, x0 = 16 * mb_y, 16 * mb_x
                c0, d0 = 8 * mb_y, 8 * mb_x
                if filter_type == 1:
                    if mb_x > 0:
                        _edge(Y, x0, 1, y0, y0 + 16, limit + 4, 0, 0, "simple")
                    if inner:
                        for k in (4, 8, 12):
                            _edge(Y, x0 + k, 1, y0, y0 + 16, limit, 0, 0, "simple")
                    if mb_y > 0:
                        _edge(Y, y0, 0, x0, x0 + 16, limit + 4, 0, 0, "simple")
                    if inner:
                        for k in (4, 8, 12):
                            _edge(Y, y0 + k, 0, x0, x0 + 16, limit, 0, 0, "simple")
                    continue
                if mb_x > 0:
                    _edge(Y, x0, 1, y0, y0 + 16, limit + 4, ilevel, hev_t, "mb")
                    for P in (U, V):
                        _edge(P, d0, 1, c0, c0 + 8, limit + 4, ilevel, hev_t, "mb")
                if inner:
                    for k in (4, 8, 12):
                        _edge(Y, x0 + k, 1, y0, y0 + 16, limit, ilevel, hev_t, "inner")
                    for P in (U, V):
                        _edge(P, d0 + 4, 1, c0, c0 + 8, limit, ilevel, hev_t, "inner")
                if mb_y > 0:
                    _edge(Y, y0, 0, x0, x0 + 16, limit + 4, ilevel, hev_t, "mb")
                    for P in (U, V):
                        _edge(P, c0, 0, d0, d0 + 8, limit + 4, ilevel, hev_t, "mb")
                if inner:
                    for k in (4, 8, 12):
                        _edge(Y, y0 + k, 0, x0, x0 + 16, limit, ilevel, hev_t, "inner")
                    for P in (U, V):
                        _edge(P, c0 + 4, 0, d0, d0 + 8, limit, ilevel, hev_t, "inner")
    return Y.astype(np.uint8), U.astype(np.uint8), V.astype(np.uint8), width, height
