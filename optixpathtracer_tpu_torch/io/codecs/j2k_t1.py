"""JPEG 2000 tier 1: one code-block's embedded bit-planes back to its
coefficients, as OpenJPEG 2.5 decodes them (ITU-T T.800 annexes C and D).

The MQ decoder (C.3: the 47-state table, 19 contexts, 0xFF 0xFF set after
each segment's bytes so that reading past them yields marker bits), the
significance propagation, magnitude refinement and cleanup passes in
stripes of four rows with their zero-coding, sign and magnitude contexts
(Tables D.1-D.4), the run-length mode of the cleanup pass, and the
code-block style bits: BYPASS (the raw sig / ref passes after the first
four bit-planes), RESET (contexts reset after each pass), TERMALL (one
segment a pass, split by tier 2), VSC (row 3 of a stripe ignores the rows
below) and SEGSYM (four UNI decisions after each cleanup); predictable
termination changes nothing a decoder reads. Values come out at twice
their scale with OpenJPEG's half-step reconstruction: a coefficient that
turns significant at bit-plane p is (1 << p) | (1 << p) >> 1, and each
refinement adds or takes away the half step below; roishift lifts the
first bit-plane.

`decode_cblk_py` is the reference, over Python ints; `csrc/host/j2k_t1.cpp`
is its native twin, taken unless OPTIX_TPU_NO_NATIVE=1 (a failed build
raises)."""
from __future__ import annotations

import ctypes

import numpy as np

from ...utils import host_build

# (Qe, NMPS, NLPS, SWITCH) of the 47 MQ states (Table C.2)
_STATES = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0),
    (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0), (0x3801, 10, 14, 0),
    (0x3001, 11, 17, 0), (0x2401, 12, 18, 0), (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0), (0x1C01, 25, 22, 0),
    (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0),
    (0x02A1, 36, 33, 0), (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]
_QE = [s[0] for s in _STATES]
_NMPS = [s[1] for s in _STATES]
_NLPS = [s[2] for s in _STATES]
_SWITCH = [s[3] for s in _STATES]

CTX_MAG, CTX_AGG, CTX_UNI = 14, 17, 18  # the contexts beyond zero coding (0-8) and sign (9-13)
LAZY, RESET, VSC, SEGSYM = 1, 2, 8, 32  # the code-block style bits a decoder reads


def _zc_table(orient: int) -> list:
    """Zero-coding context by h * 15 + v * 5 + d (Table D.1); orient is the
    band: 0 LL, 1 HL (h and v swap), 2 LH, 3 HH."""
    lut = []
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if orient == 3:
                    hv = h + v
                    n = (8 if d >= 3 else 7 if hv >= 1 else 6) if d >= 2 else \
                        (5 if hv >= 2 else 4 if hv == 1 else 3) if d == 1 else (2 if hv >= 2 else hv)
                else:
                    a, b = (v, h) if orient == 1 else (h, v)
                    if a == 0:
                        n = (0 if d == 0 else 1 if d == 1 else 2) if b == 0 else 3 if b == 1 else 4
                    elif a == 1:
                        n = (5 if d == 0 else 6) if b == 0 else 7
                    else:
                        n = 8
                lut.append(n)
    return lut


ZC = [_zc_table(o) for o in range(4)]
# sign context and xor bit by (hc + 1) * 3 + (vc + 1) (Table D.3)
SC = [(13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0), (12, 0), (13, 0)]


class _MQ:
    """The MQ decoder over one segment (C.3.5 INITDEC, C.3.4 BYTEIN), and
    the raw bit reader of BYPASS segments."""

    def __init__(self, seg: bytes, raw: bool):
        self.buf = seg + b"\xff\xff"
        self.bp = 0
        if raw:
            self.c, self.ct = 0, 0
            return
        self.c = (0xFF if not seg else seg[0]) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        buf, bp = self.buf, self.bp
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += buf[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += buf[bp + 1] << 8
            self.ct = 8

    def decode(self, ctx: list, cx: int) -> int:
        st = ctx[cx]
        q = _QE[st >> 1]
        mps = st & 1
        a = self.a - q
        c = self.c
        if (c >> 16) < q:
            if a < q:
                d = mps
                ctx[cx] = (_NMPS[st >> 1] << 1) | mps
            else:
                d = 1 - mps
                ctx[cx] = (_NLPS[st >> 1] << 1) | (mps ^ _SWITCH[st >> 1])
            a = q
        else:
            c -= q << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return mps
            if a < q:
                d = 1 - mps
                ctx[cx] = (_NLPS[st >> 1] << 1) | (mps ^ _SWITCH[st >> 1])
            else:
                d = mps
                ctx[cx] = (_NMPS[st >> 1] << 1) | mps
        ct = self.ct
        while True:
            if ct == 0:
                self.c = c
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d

    def raw(self) -> int:
        if self.ct == 0:
            buf, bp = self.buf, self.bp
            if self.c == 0xFF:
                if buf[bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c, self.ct, self.bp = buf[bp], 7, bp + 1
            else:
                self.c, self.ct, self.bp = buf[bp], 8, bp + 1
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _reset(ctx: list) -> None:
    ctx[:] = [0] * 19
    ctx[CTX_UNI] = 46 << 1
    ctx[CTX_AGG] = 3 << 1
    ctx[0] = 4 << 1


def decode_cblk_py(data: bytes, segs: list, w: int, h: int, orient: int, numbps: int, roishift: int,
                   cblksty: int) -> np.ndarray:
    """The reference: `segs` is [(length, passes)] over `data`, in order.
    -> (h, w) int32 coefficients at twice their scale."""
    W = w + 2
    size = W * (h + 2)
    sig = [0] * size   # significant
    vis = [0] * size   # coded in this bit-plane's significance pass
    ref = [0] * size   # refined at least once
    val = [0] * size
    # each sample's significant neighbours, counted as they turn significant:
    # horizontal, vertical, diagonal, and the signed horizontal / vertical sums;
    # under VSC a sample in row 0 of a stripe is not told to the row above
    nh, nv, nd, sh, sv = ([0] * size for _ in range(5))
    zc = ZC[orient]
    vsc = cblksty & VSC
    ctx = [0] * 19
    _reset(ctx)

    def turn(p, y, s, oph):
        val[p] = -oph if s else oph
        sig[p] = 1
        g = -1 if s else 1
        nh[p - 1] += 1
        nh[p + 1] += 1
        sh[p - 1] += g
        sh[p + 1] += g
        q = p + W
        nv[q] += 1
        sv[q] += g
        nd[q - 1] += 1
        nd[q + 1] += 1
        if not (vsc and (y & 3) == 0):
            q = p - W
            nv[q] += 1
            sv[q] += g
            nd[q - 1] += 1
            nd[q + 1] += 1

    def sign(mq, p):
        hc, vc = sh[p], sv[p]
        cx, xor = SC[(1 if hc > 0 else -1 if hc < 0 else 0) * 3 + (1 if vc > 0 else -1 if vc < 0 else 0) + 4]
        return mq.decode(ctx, cx) ^ xor

    bp1 = roishift + numbps
    if bp1 >= 31:
        raise ValueError("code-block of 31 or more bit-planes")
    passtype = 2
    pos = 0
    for length, npasses in segs:
        raw = bp1 <= numbps - 4 and passtype < 2 and (cblksty & LAZY)
        mq = _MQ(data[pos:pos + length], bool(raw))
        pos += length
        for _ in range(npasses):
            if bp1 < 1:
                break
            one = 1 << bp1
            half = one >> 1
            oph = one | half
            if passtype == 0:  # significance propagation
                for k in range(0, h, 4):
                    for x in range(w):
                        for y in range(k, min(k + 4, h)):
                            p = (y + 1) * W + x + 1
                            if sig[p] or vis[p] or not (nh[p] or nv[p] or nd[p]):
                                continue
                            if raw:
                                if mq.raw():
                                    turn(p, y, mq.raw(), oph)
                            elif mq.decode(ctx, zc[nh[p] * 15 + nv[p] * 5 + nd[p]]):
                                turn(p, y, sign(mq, p), oph)
                            vis[p] = 1
            elif passtype == 1:  # magnitude refinement
                for k in range(0, h, 4):
                    for x in range(w):
                        for y in range(k, min(k + 4, h)):
                            p = (y + 1) * W + x + 1
                            if not sig[p] or vis[p]:
                                continue
                            if raw:
                                v = mq.raw()
                            else:
                                v = mq.decode(ctx, CTX_MAG + 2 if ref[p] else
                                              CTX_MAG + 1 if nh[p] or nv[p] or nd[p] else CTX_MAG)
                            val[p] += half if v ^ (val[p] < 0) else -half
                            ref[p] = 1
            else:  # cleanup
                for k in range(0, h, 4):
                    full = k + 4 <= h
                    for x in range(w):
                        start = k
                        if full:
                            p = (k + 1) * W + x + 1
                            quiet = True
                            for q in (p, p + W, p + 2 * W, p + 3 * W):
                                if sig[q] or vis[q] or nh[q] or nv[q] or nd[q]:
                                    quiet = False
                                    break
                            if quiet:
                                if not mq.decode(ctx, CTX_AGG):
                                    continue
                                run = mq.decode(ctx, CTX_UNI) << 1
                                run |= mq.decode(ctx, CTX_UNI)
                                y = k + run
                                p = (y + 1) * W + x + 1
                                turn(p, y, sign(mq, p), oph)
                                start = y + 1
                        for y in range(start, min(k + 4, h)):
                            p = (y + 1) * W + x + 1
                            if sig[p] or vis[p]:
                                continue
                            if mq.decode(ctx, zc[nh[p] * 15 + nv[p] * 5 + nd[p]]):
                                turn(p, y, sign(mq, p), oph)
                vis = [0] * size
                if cblksty & SEGSYM:
                    for _ in range(4):
                        mq.decode(ctx, CTX_UNI)
            if (cblksty & RESET) and not raw:
                _reset(ctx)
            passtype += 1
            if passtype == 3:
                passtype = 0
                bp1 -= 1
    out = np.array(val, np.int64).reshape(h + 2, W)[1:-1, 1:-1]
    return out.astype(np.int32)


_SIG = None


def _native():
    global _SIG
    lib = host_build.load("j2k_t1")
    if _SIG is None:
        f = lib.j2k_t1_decode_cblk
        f.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        f.restype = ctypes.c_int
        _SIG = f
    return _SIG


def decode_cblk_native(data: bytes, segs: list, w: int, h: int, orient: int, numbps: int, roishift: int,
                       cblksty: int) -> np.ndarray:
    """`decode_cblk_py` in C++ (csrc/host/j2k_t1.cpp), bit for bit."""
    if roishift + numbps >= 31:
        raise ValueError("code-block of 31 or more bit-planes")
    fn = _native()
    seg = np.array([v for s in segs for v in s], np.int32)
    out = np.zeros((h, w), np.int32)
    fn(bytes(data), seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(segs), w, h, orient, numbps, roishift,
       cblksty, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def decode_cblk(data: bytes, segs: list, w: int, h: int, orient: int, numbps: int, roishift: int,
                cblksty: int) -> np.ndarray:
    """The native twin unless OPTIX_TPU_NO_NATIVE=1, else the reference."""
    fn = decode_cblk_native if host_build.native_enabled() else decode_cblk_py
    return fn(data, segs, w, h, orient, numbps, roishift, cblksty)
