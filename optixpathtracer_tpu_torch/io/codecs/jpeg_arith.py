"""Arithmetic-coded JPEG scans (SOF9 / SOF10): the QM coder of T.81 Annex D
and the statistics of Annex F / G, as libjpeg's jdarith.c decodes them.

`decode_scan` fills a frame's coefficient stores (zigzag order, as the
Huffman path of io/image.py does) for one scan: sequential (DC and AC of
every block), or one progressive pass (DC first / refine, AC first /
refine). Each restart interval starts the coder and its statistics anew;
past the end of an interval the coder reads zeros, as libjpeg does at a
marker. Corrupt data decodes to what libjpeg makes of it: a magnitude or
spectral overflow stops decoding until the next restart interval, the
rest left as it was.
The coder is a sequential host loop over the interval's bytes."""
from __future__ import annotations

# T.81 Table D.2, one entry per state: (Qe, next index after an LPS, next
# index after an MPS, switch MPS); state 113 is libjpeg's fixed 0.5 bin
_QM = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]
QE = [q for q, _, _, _ in _QM]
NLPS = [s << 7 | lps for _, lps, _, s in _QM]  # libjpeg's packing: the switch bit beside it
NMPS = [mps for _, _, mps, _ in _QM]
FIXED = 113
DC_BINS, AC_BINS = 64, 256


class Overflow(Exception):
    """A magnitude or spectral overflow: libjpeg decodes nothing more of the
    restart interval."""


class QMDecoder:
    """The QM decoder over one restart interval's bytes (stuffing removed):
    `decode(stats, i)` decodes one binary decision with the adaptive state
    stats[i] (a byte: MPS in bit 7, the Table D.2 index below it)."""

    def __init__(self, seg: bytes):
        self.seg = seg
        self.pos = 0
        self.c = 0
        self.a = 0
        self.ct = -16

    def decode(self, st: list, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                data = self.seg[pos] if pos < len(self.seg) else 0  # zeros past the interval
                self.pos = pos + 1
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # the two initial bytes are in
            a <<= 1
        sv = st[i]
        s = sv & 0x7F
        qe = QE[s]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ NMPS[s]
            else:
                st[i] = (sv & 0x80) ^ NLPS[s]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ NLPS[s]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ NMPS[s]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _dc_diff(dec: QMDecoder, st: list, ctx: int, lower: int, upper: int) -> tuple[int, int]:
    """Figures F.19-F.24: one DC difference -> (value, the next context)."""
    if dec.decode(st, ctx) == 0:
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    i = ctx + 2 + sign
    m = dec.decode(st, i)
    if m:
        i = 20
        while dec.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise Overflow
            i += 1
    if m < (1 << lower) >> 1:
        nxt = 0
    elif m > (1 << upper) >> 1:
        nxt = 12 + sign * 4
    else:
        nxt = 4 + sign * 4
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), nxt


def _ac_value(dec: QMDecoder, st: list, i: int, k: int, kx: int, fixed: list) -> int:
    """Figures F.21-F.24 for an AC coefficient whose bins start at i."""
    sign = dec.decode(fixed, 0)
    i += 2
    m = dec.decode(st, i)
    if m:
        if dec.decode(st, i):
            m <<= 1
            i = 189 if k <= kx else 217
            while dec.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise Overflow
                i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _int16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def decode_scan(frame, comps, dc_tbls, ac_tbls, ss, se, ah, al, segs, restart, cond):
    """One arithmetic-coded scan into `frame`'s coefficient stores.
    dc_tbls / ac_tbls: each scan component's conditioning table numbers;
    cond: {("dc", t): (L, U), ("ac", t): Kx} from DAC (defaults 0, 1, 5)."""
    mcus = frame.scan_mcus(comps)
    per = restart or len(mcus)
    stores = [frame.coefs[c] for c in comps]
    sequential = not frame.progressive
    dc_first = ss == 0 and ah == 0
    p1, m1 = 1 << al, -1 << al
    for seg_i in range(-(-len(mcus) // per)):
        dec = QMDecoder(segs[seg_i] if seg_i < len(segs) else b"")
        dc_stats = {t: [0] * DC_BINS for t in set(dc_tbls)}
        ac_stats = {t: [0] * AC_BINS for t in set(ac_tbls)}
        fixed = [FIXED]
        last = [0] * len(comps)
        ctx = [0] * len(comps)
        try:
            for mcu in mcus[seg_i * per:(seg_i + 1) * per]:
                for ci, base in mcu:
                    co = stores[ci]
                    if dc_first:
                        t = dc_tbls[ci]
                        lo, up = cond.get(("dc", t), (0, 1))
                        d, ctx[ci] = _dc_diff(dec, dc_stats[t], ctx[ci], lo, up)
                        if sequential:
                            last[ci] = (last[ci] + d) & 0xFFFF
                            co[base] = _int16(last[ci])
                        else:
                            last[ci] += d
                            co[base] = _int16(last[ci] << al)
                        if not sequential:
                            continue
                    elif ss == 0:  # DC refine
                        if dec.decode(fixed, 0):
                            co[base] |= p1
                        continue
                    t = ac_tbls[ci]
                    st = ac_stats[t]
                    kx = cond.get(("ac", t), 5)
                    if sequential or ah == 0:  # the AC of a sequential block, or AC first
                        k0, k1 = (1, 63) if sequential else (ss, se)
                        shift = 0 if sequential else al
                        k = k0
                        while k <= k1:
                            i = 3 * (k - 1)
                            if dec.decode(st, i):
                                break  # EOB
                            while dec.decode(st, i + 1) == 0:
                                i += 3
                                k += 1
                                if k > k1:
                                    raise Overflow
                            co[base + k] = _int16(_ac_value(dec, st, i, k, kx, fixed) << shift)
                            k += 1
                    else:  # AC refine
                        kex = se
                        while kex > 0 and not co[base + kex]:
                            kex -= 1
                        k = ss
                        while k <= se:
                            i = 3 * (k - 1)
                            if k > kex and dec.decode(st, i):
                                break  # EOB
                            while True:
                                c = co[base + k]
                                if c:
                                    if dec.decode(st, i + 2):
                                        co[base + k] = _int16(c + (m1 if c < 0 else p1))
                                    break
                                if dec.decode(st, i + 1):
                                    co[base + k] = m1 if dec.decode(fixed, 0) else p1
                                    break
                                i += 3
                                k += 1
                                if k > se:
                                    raise Overflow
                            k += 1
        except Overflow:
            pass  # libjpeg warns and decodes nothing more until the next restart
