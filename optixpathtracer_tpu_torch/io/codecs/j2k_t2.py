"""JPEG 2000 tier 2: the partition of a tile-component into resolutions,
sub-bands, precincts and code-blocks (B.5-B.7, anchored on the canvas
origin), the packet order of each progression and of POC (B.12), and the
packet headers (B.10): tag trees, inclusion, zero bit-planes, the number of
passes, Lblock and the segment lengths under each code-block style, with
SOP / EPH, as OpenJPEG 2.5 reads them. What it gathers, each code-block's
bytes and (length, passes) segments, is what tier 1 decodes."""
from __future__ import annotations

from ._common import DecodeError

LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
_BROKEN = "broken data stream when reading image file"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ceil_pow2(a: int, n: int) -> int:
    return -((-a) >> n)


class Bits:
    """OpenJPEG's opj_bio reader: MSB first, 7 bits after a 0xFF byte;
    past the end it reads zeros."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.start, self.bp, self.end = data, start, start, end
        self.buf = 0
        self.ct = 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0

    def numbytes(self) -> int:
        return self.bp - self.start


class TagTree:
    """B.10.2: leaves w x h, each level halving (rounded up) to one root."""

    def __init__(self, w: int, h: int):
        self.parent = []
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            pw, ph = sizes[-1]
            sizes.append(((pw + 1) // 2, (ph + 1) // 2))
        base = 0
        for lvl, (lw, lh) in enumerate(sizes):
            nxt = base + lw * lh
            for j in range(lh):
                for i in range(lw):
                    if lvl + 1 < len(sizes):
                        pw = sizes[lvl + 1][0]
                        self.parent.append(nxt + (j // 2) * pw + i // 2)
                    else:
                        self.parent.append(-1)
            base = nxt
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bits: Bits, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


class Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs", "data", "newpasses", "included")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.numlenbits = 0
        self.segs = []  # [length, passes, maxpasses, newlength, newpasses]
        self.data = bytearray()
        self.newpasses = 0
        self.included = False


class Band:
    def __init__(self, bandno, x0, y0, x1, y1):
        self.bandno = bandno
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.precincts = []  # per precinct: (cw, ch, cblks, incltree, imsbtree)
        self.numbps = 0
        self.stepsize = 0.0

    def empty(self) -> bool:
        return self.x1 - self.x0 == 0 or self.y1 - self.y0 == 0


class Resolution:
    def __init__(self, x0, y0, x1, y1, pdx, pdy, pw, ph):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy, self.pw, self.ph = pdx, pdy, pw, ph
        self.bands = []


def build_resolutions(tcx0, tcy0, tcx1, tcy1, tccp) -> list:
    """opj_tcd_init_tile's resolutions, bands, precincts and code-blocks of
    one tile-component."""
    numres = tccp.numres
    out = []
    for resno in range(numres):
        lvl = numres - 1 - resno
        rx0, ry0, rx1, ry1 = (ceil_pow2(v, lvl) for v in (tcx0, tcy0, tcx1, tcy1))
        pdx, pdy = tccp.prcw[resno], tccp.prch[resno]
        tlpx, tlpy = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brpx, brpy = ceil_pow2(rx1, pdx) << pdx, ceil_pow2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brpx - tlpx) >> pdx
        ph = 0 if ry0 == ry1 else (brpy - tlpy) >> pdy
        res = Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph)
        if resno == 0:
            tlcbgx, tlcbgy, cbgw, cbgh = tlpx, tlpy, pdx, pdy
            bands = [(0, rx0, ry0, rx1, ry1)]
        else:
            tlcbgx, tlcbgy, cbgw, cbgh = ceil_pow2(tlpx, 1), ceil_pow2(tlpy, 1), pdx - 1, pdy - 1
            bands = []
            for bandno in (1, 2, 3):
                xb, yb = bandno & 1, bandno >> 1
                bands.append((bandno, ceil_pow2(tcx0 - (xb << lvl), lvl + 1), ceil_pow2(tcy0 - (yb << lvl), lvl + 1),
                              ceil_pow2(tcx1 - (xb << lvl), lvl + 1), ceil_pow2(tcy1 - (yb << lvl), lvl + 1)))
        cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
        for bandno, bx0, by0, bx1, by1 in bands:
            band = Band(bandno, bx0, by0, bx1, by1)
            for precno in range(pw * ph):
                cx0 = tlcbgx + (precno % pw) * (1 << cbgw)
                cy0 = tlcbgy + (precno // pw) * (1 << cbgh)
                px0, py0 = max(cx0, bx0), max(cy0, by0)
                px1, py1 = min(cx0 + (1 << cbgw), bx1), min(cy0 + (1 << cbgh), by1)
                tlx, tly = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                cw = max(0, ((ceil_pow2(px1, cbw) << cbw) - tlx) >> cbw)
                ch = max(0, ((ceil_pow2(py1, cbh) << cbh) - tly) >> cbh)
                cblks = []
                for j in range(ch):
                    for i in range(cw):
                        x0, y0 = tlx + (i << cbw), tly + (j << cbh)
                        cblks.append(Cblk(max(x0, px0), max(y0, py0), min(x0 + (1 << cbw), px1),
                                          min(y0 + (1 << cbh), py1)))
                trees = (TagTree(cw, ch), TagTree(cw, ch)) if cw * ch else (None, None)
                band.precincts.append((cw, ch, cblks) + trees)
            res.bands.append(band)
        out.append(res)
    return out


def _pos_steps(comps: list) -> tuple[int, int]:
    """The canvas steps of OpenJPEG's position walk: the smallest precinct
    of any resolution of the components, in canvas units."""
    dx = dy = 0
    for comp in comps:
        for resno, res in enumerate(comp.res):
            lvl = comp.numres - 1 - resno
            if res.pdx + lvl < 32:
                v = comp.dx << (res.pdx + lvl)
                dx = v if not dx else min(dx, v)
            if res.pdy + lvl < 32:
                v = comp.dy << (res.pdy + lvl)
                dy = v if not dy else min(dy, v)
    return dx, dy


def _prec_at(comp, resno, x, y, tile):
    """The precinct of (comp, resno) that starts at canvas (x, y) in
    OpenJPEG's position walk (opj_pi_next_rpcl / pcrl / cprl), or None."""
    tx0, ty0, tx1, ty1 = tile
    res = comp.res[resno]
    lvl = comp.numres - 1 - resno
    trx0, try0 = ceil_div(tx0, comp.dx << lvl), ceil_div(ty0, comp.dy << lvl)
    trx1, try1 = ceil_div(tx1, comp.dx << lvl), ceil_div(ty1, comp.dy << lvl)
    rpx, rpy = res.pdx + lvl, res.pdy + lvl
    if rpx >= 31 or rpy >= 31:
        return None
    if not (y % (comp.dy << rpy) == 0 or (y == ty0 and (try0 << lvl) % (1 << rpy))):
        return None
    if not (x % (comp.dx << rpx) == 0 or (x == tx0 and (trx0 << lvl) % (1 << rpx))):
        return None
    if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
        return None
    prci = (ceil_div(x, comp.dx << lvl) >> res.pdx) - (trx0 >> res.pdx)
    prcj = (ceil_div(y, comp.dy << lvl) >> res.pdy) - (try0 >> res.pdy)
    return prci + prcj * res.pw


def packet_order(comps: list, tile: tuple, numlayers: int, prg: int, pocs: list) -> list:
    """The (layer, resno, compno, precno) of every packet of the tile, in
    OpenJPEG's order: one progression, or one for each POC entry with the
    packets an earlier entry sent skipped."""
    maxres = max(c.numres for c in comps)
    if pocs:
        runs = [(p["prg"], p["resno0"], p["compno0"], min(p["layno1"], numlayers), p["resno1"],
                 min(p["compno1"], len(comps))) for p in pocs]
    else:
        runs = [(prg, 0, 0, numlayers, maxres, len(comps))]
    seen = set()
    order = []

    def emit(key):
        if key not in seen:
            seen.add(key)
            order.append(key)

    tx0, ty0, tx1, ty1 = tile
    for prog, r0, c0, l1, r1, c1 in runs:
        cs = range(c0, c1)
        if prog in (LRCP, RLCP):
            for a in range(l1) if prog == LRCP else range(r0, r1):
                for b in range(r0, r1) if prog == LRCP else range(l1):
                    lay, resno = (a, b) if prog == LRCP else (b, a)
                    for compno in cs:
                        comp = comps[compno]
                        if resno >= comp.numres:
                            continue
                        res = comp.res[resno]
                        for precno in range(res.pw * res.ph):
                            emit((lay, resno, compno, precno))
            continue
        if prog == CPRL:
            for compno in cs:
                comp = comps[compno]
                dx, dy = _pos_steps([comp])
                if not dx or not dy:
                    continue
                y = ty0
                while y < ty1:
                    x = tx0
                    while x < tx1:
                        for resno in range(r0, min(r1, comp.numres)):
                            precno = _prec_at(comp, resno, x, y, tile)
                            if precno is not None:
                                for lay in range(l1):
                                    emit((lay, resno, compno, precno))
                        x += dx - x % dx
                    y += dy - y % dy
            continue
        dx, dy = _pos_steps(comps)
        if not dx or not dy:
            continue
        if prog == RPCL:
            for resno in range(r0, r1):
                y = ty0
                while y < ty1:
                    x = tx0
                    while x < tx1:
                        for compno in cs:
                            comp = comps[compno]
                            if resno >= comp.numres:
                                continue
                            precno = _prec_at(comp, resno, x, y, tile)
                            if precno is not None:
                                for lay in range(l1):
                                    emit((lay, resno, compno, precno))
                        x += dx - x % dx
                    y += dy - y % dy
        else:  # PCRL
            y = ty0
            while y < ty1:
                x = tx0
                while x < tx1:
                    for compno in cs:
                        comp = comps[compno]
                        for resno in range(r0, min(r1, comp.numres)):
                            precno = _prec_at(comp, resno, x, y, tile)
                            if precno is not None:
                                for lay in range(l1):
                                    emit((lay, resno, compno, precno))
                    x += dx - x % dx
                y += dy - y % dy
    return order


def _numpasses(bits: Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


def _new_seg(cblk: Cblk, cblksty: int, first: bool) -> list:
    if cblksty & 4:  # TERMALL
        maxp = 1
    elif cblksty & 1:  # BYPASS
        maxp = 10 if first else (2 if cblk.segs[-1][2] in (1, 10) else 1)
    else:
        maxp = 109
    seg = [0, 0, maxp, 0, 0]
    cblk.segs.append(seg)
    return seg


class HeaderSource:
    """Where packet headers come from: the tile's own bytes, or the bytes
    PPM / PPT gathered for it."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0


def read_packet(data: bytes, pos: int, end: int, hdr: HeaderSource | None, comp, resno: int, precno: int,
                layno: int, cblksty: int, sop: bool, eph: bool, spans: list | None = None) -> int:
    """One packet from data[pos:end] (its header from `hdr` under PPM /
    PPT): the code-blocks' new passes and bytes appended. -> the position
    after it. A segment that runs past the data raises, as OpenJPEG's
    strict reader does. `spans` gets the packet's (start, header start,
    header end, end) in the tile's bytes."""
    res = comp.res[resno]
    start = pos
    if sop:
        if end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
            pos += 6
    if hdr is None:
        hsrc, hstart, hend = data, pos, end
    else:
        hsrc, hstart, hend = hdr.data, hdr.pos, len(hdr.data)
    bits = Bits(hsrc, hstart, hend)
    bands = [b for b in res.bands if not b.empty()]
    present = bits.bit()
    if present:
        for band in bands:
            cw, ch, cblks, incl, imsb = band.precincts[precno]
            for cblkno, cblk in enumerate(cblks):
                if not cblk.segs:
                    included = incl.decode(bits, cblkno, layno + 1)
                else:
                    included = bits.bit()
                if not included:
                    cblk.newpasses = 0
                    continue
                if not cblk.segs:
                    i = 0
                    while not imsb.decode(bits, cblkno, i):
                        i += 1
                    cblk.numbps = band.numbps + 1 - i
                    cblk.numlenbits = 3
                n = _numpasses(bits)
                cblk.newpasses = n
                while bits.bit():
                    cblk.numlenbits += 1
                if not cblk.segs:
                    seg = _new_seg(cblk, cblksty, True)
                else:
                    seg = cblk.segs[-1]
                    if seg[1] == seg[2]:
                        seg = _new_seg(cblk, cblksty, False)
                first = len(cblk.segs) - 1
                k = first
                while True:
                    s = cblk.segs[k]
                    s[4] = min(s[2] - s[1], n)
                    nbits = cblk.numlenbits + (s[4].bit_length() - 1)
                    if nbits > 32:
                        raise DecodeError(_BROKEN)
                    s[3] = bits.read(nbits)
                    n -= s[4]
                    if n <= 0:
                        break
                    _new_seg(cblk, cblksty, False)
                    k += 1
                cblk.included = first  # the first segment this packet adds to
    bits.inalign()
    hpos = hstart + bits.numbytes()
    if eph:  # a missing SOP is let pass, a missing EPH is not
        if hend - hpos < 2 or hsrc[hpos] != 0xFF or hsrc[hpos + 1] != 0x92:
            raise DecodeError(_BROKEN)
        hpos += 2
    if hdr is None:
        pos = hpos
    else:
        hdr.pos = hpos
    if not present:
        if spans is not None:
            spans.append((start, hstart, hpos, pos))
        return pos
    body = pos
    for band in bands:
        for cblk in band.precincts[precno][2]:
            if not cblk.newpasses:
                continue
            k = cblk.included
            n = cblk.newpasses
            while n > 0:
                s = cblk.segs[k]
                if pos + s[3] > end:
                    raise DecodeError(_BROKEN)
                cblk.data += data[pos:pos + s[3]]
                pos += s[3]
                s[0] += s[3]
                s[1] += s[4]
                n -= s[4]
                k += 1
            cblk.newpasses = 0
    if spans is not None:
        spans.append((start, hstart, hpos if hdr is None else body, pos))
    return pos
