"""JPEG 2000 codestreams (ITU-T T.800 annex A), decoded as OpenJPEG 2.5
decodes them for PIL: every tile, all layers, full resolution.

The main header and the tile-part headers: SOC, SIZ (image and tile
offsets, XRsiz / YRsiz, precision and sign), COD / COC (progression,
layers, MCT, levels, code-block size and style, precincts, SOP / EPH),
QCD / QCC (none, derived or expounded, guard bits), RGN, POC, PPM / PPT,
the markers read past (TLM, PLM, PLT, CRG, COM, CAP, CPF), SOT / SOD with
tile-parts in any order of tiles, and EOC. Precedence is the standard's:
tile COC, tile COD, main COC, main COD (QCC / QCD likewise). Tier 2 is
j2k_t2.py, tier 1 j2k_t1.py, the transforms j2k_dwt.py.

OpenJPEG reads strictly for PIL: a stream that ends before EOC, a tile-part
longer than the bytes left, a code-block segment past its packet's data,
a marker it does not know where a marker must be, all fail the decode, and
PIL reports "broken data stream when reading image file". `Codestream`
keeps what the header says; `decode_tiles` yields each tile's components."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import j2k_dwt, j2k_t1, j2k_t2
from ._common import DecodeError, unported

BROKEN = "broken data stream when reading image file"


# the markers OpenJPEG knows, by where they may stand: the main header (SOT
# ends it), a tile-part header, and those that stand in neither
_MAIN = {0xFF90, 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF55, 0xFF57, 0xFF60, 0xFF63, 0xFF64, 0xFF74,
         0xFF78, 0xFF50, 0xFF59, 0xFF75, 0xFF77}
_TILE = {0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF58, 0xFF61, 0xFF64, 0xFF74, 0xFF75, 0xFF77}
_ELSEWHERE = {0xFF51, 0xFF58, 0xFF61, 0xFF91}


def broken() -> DecodeError:
    return DecodeError(BROKEN)


@dataclass
class Comp:
    prec: int
    sgnd: bool
    dx: int
    dy: int


@dataclass
class Coding:
    """One component's coding style (COD / COC) and quantisation."""
    numres: int = 6
    cblkw: int = 6
    cblkh: int = 6
    cblksty: int = 0
    qmfbid: int = 0
    prcw: list = field(default_factory=lambda: [15] * 33)
    prch: list = field(default_factory=lambda: [15] * 33)
    qntsty: int = 0
    numgbits: int = 0
    steps: list = field(default_factory=list)  # (expn, mant) per band
    roishift: int = 0


@dataclass
class Tile:
    index: int
    cod: dict | None = None
    coc: dict = field(default_factory=dict)
    qcd: tuple | None = None
    qcc: dict = field(default_factory=dict)
    rgn: dict = field(default_factory=dict)
    pocs: list = field(default_factory=list)
    ppt: dict = field(default_factory=dict)
    parts: list = field(default_factory=list)  # tile-part bodies, in the order they came
    nparts: int = 0


class Codestream:
    """The header of a codestream and its tile-parts, read as OpenJPEG reads
    them; `data[start:]` begins with SOC."""

    def __init__(self, data: bytes, start: int = 0):
        self.data = data
        if data[start:start + 4] != b"\xff\x4f\xff\x51":
            raise broken()
        pos = start + 2
        self.cod = None
        self.coc, self.qcc, self.rgn = {}, {}, {}
        self.qcd = None
        self.pocs = []
        self.ppm = {}
        self.tiles: dict[int, Tile] = {}
        self.order: list[int] = []  # tiles in the order their last tile-part came
        pos = self._segment(pos)  # SIZ
        while True:
            marker, pos = self._marker(pos)
            if marker < 0xFF00:
                raise broken()
            while marker not in _MAIN and marker not in _ELSEWHERE:  # opj_j2k_read_unk: on to a known marker
                marker, pos = self._marker(pos)
            if marker in _ELSEWHERE:
                raise broken()  # a marker that has no place in the main header
            if marker == 0xFF90:
                break
            pos = self._segment(pos - 2)
        self.ppm_source = self._merge_ppm() if self.ppm else None
        while True:  # at SOT
            pos = self._tile_part(pos - 2)
            marker, pos = self._marker(pos)
            if marker == 0xFFD9:
                break
            if marker != 0xFF90:
                raise broken()

    def _merge_ppm(self) -> j2k_t2.HeaderSource:
        """opj_j2k_merge_ppm: the PPM segments in Zppm order, each tile-part's
        Nppm read where a segment has all four of its bytes, the headers
        kept back to back; tiles take them in turn as they decode."""
        left = 0
        out = []
        for z in sorted(self.ppm):
            seg = self.ppm[z]
            at = min(left, len(seg))
            left -= at
            out.append(seg[:at])
            while at < len(seg):
                if len(seg) - at < 4:
                    raise broken()
                n = int.from_bytes(seg[at:at + 4], "big")
                take = min(n, len(seg) - at - 4)
                out.append(seg[at + 4:at + 4 + take])
                left = n - take
                at += 4 + take
        if left:
            raise broken()
        return j2k_t2.HeaderSource(b"".join(out))

    # -- helpers -------------------------------------------------------
    def _marker(self, pos: int) -> tuple[int, int]:
        if pos + 2 > len(self.data):
            raise broken()
        return int.from_bytes(self.data[pos:pos + 2], "big"), pos + 2

    def _body(self, pos: int) -> tuple[bytes, int]:
        """The segment whose length field is at pos -> (its body, the end)."""
        d = self.data
        if pos + 2 > len(d):
            raise broken()
        n = int.from_bytes(d[pos:pos + 2], "big")
        if n < 2 or pos + n > len(d):
            raise broken()
        return d[pos + 2:pos + n], pos + n

    def _comp_index(self, body: bytes, at: int) -> tuple[int, int]:
        if self.ncomp < 257:
            return body[at], at + 1
        return int.from_bytes(body[at:at + 2], "big"), at + 2

    def _segment(self, pos: int, tile: Tile | None = None) -> int:
        """The marker segment at pos (its marker included) -> the end."""
        marker, pos = self._marker(pos)
        body, end = self._body(pos)
        try:
            self._apply(marker, body, tile)
        except IndexError as e:
            raise broken() from e
        return end

    def _apply(self, marker: int, body: bytes, tile: Tile | None) -> None:
        if marker == 0xFF51:
            self._siz(body)
        elif marker in (0xFF52, 0xFF53):
            self._cod(marker, body, tile)
        elif marker in (0xFF5C, 0xFF5D):
            self._qcd(marker, body, tile)
        elif marker == 0xFF5E:
            c, at = self._comp_index(body, 0)
            if c >= self.ncomp or body[at] != 0:
                raise broken()
            (self.rgn if tile is None else tile.rgn)[c] = body[at + 1]
        elif marker == 0xFF5F:
            self._poc(body, tile)
        elif marker == 0xFF60:
            self.ppm[body[0]] = body[1:]
        elif marker == 0xFF61:
            tile.ppt[body[0]] = body[1:]
        elif marker in (0xFF55, 0xFF57, 0xFF58, 0xFF63, 0xFF64, 0xFF50, 0xFF59, 0xFF74, 0xFF75, 0xFF77, 0xFF78):
            pass  # TLM, PLM, PLT, CRG, COM, CAP, CPF, MCT, MCC, MCO, CBD: nothing the decode needs
        else:
            raise broken()

    def _siz(self, b: bytes) -> None:
        (self.rsiz, self.xsiz, self.ysiz, self.xosiz, self.yosiz, self.xtsiz, self.ytsiz, self.xtosiz,
         self.ytosiz) = [int.from_bytes(b[0:2], "big")] + [int.from_bytes(b[2 + 4 * i:6 + 4 * i], "big")
                                                         for i in range(8)]
        self.ncomp = int.from_bytes(b[34:36], "big")
        if len(b) != 36 + 3 * self.ncomp or not self.ncomp or self.ncomp > 16384:
            raise broken()
        if (self.xosiz >= self.xsiz or self.yosiz >= self.ysiz or not self.xtsiz or not self.ytsiz
                or self.xtosiz > self.xosiz or self.ytosiz > self.yosiz
                or self.xtosiz + self.xtsiz <= self.xosiz or self.ytosiz + self.ytsiz <= self.yosiz):
            raise broken()
        self.comps = []
        for c in range(self.ncomp):
            s, dx, dy = b[36 + 3 * c:39 + 3 * c]
            prec = (s & 0x7F) + 1
            if not dx or not dy or prec > 31:
                raise broken()
            self.comps.append(Comp(prec, bool(s & 0x80), dx, dy))
        self.tw = j2k_t2.ceil_div(self.xsiz - self.xtosiz, self.xtsiz)
        self.th = j2k_t2.ceil_div(self.ysiz - self.ytosiz, self.ytsiz)
        if self.tw * self.th > 65535:
            raise broken()  # more tiles than the standard allows

    def _spcod(self, b: bytes, at: int, prt: bool) -> dict:
        levels, cbw, cbh, sty, qmf = b[at:at + 5]
        if levels > 32 or cbw + 2 > 10 or cbh + 2 > 10 or cbw + cbh + 4 > 12 or qmf > 1 or sty & 0x80:
            raise broken()  # (0x80: mixed HT code-blocks, which OpenJPEG refuses)
        if sty & 0x40:
            raise unported("JPEG2000 of HTJ2K code-blocks (Part 15)")
        numres = levels + 1
        at += 5
        if prt:
            pp = b[at:at + numres]
            if len(pp) < numres:
                raise broken()
            prcw, prch = [p & 15 for p in pp], [p >> 4 for p in pp]
        else:
            prcw, prch = [15] * numres, [15] * numres
        return dict(numres=numres, cblkw=cbw + 2, cblkh=cbh + 2, cblksty=sty, qmfbid=qmf, prcw=prcw, prch=prch)

    def _cod(self, marker: int, b: bytes, tile: Tile | None) -> None:
        if marker == 0xFF52:
            scod, prg = b[0], b[1]
            layers, mctv = int.from_bytes(b[2:4], "big"), b[4]
            if scod & ~7 or prg > 4 or not layers or mctv > 1:
                raise broken()
            cod = dict(csty=scod, prg=prg, layers=layers, mct=mctv, spcod=self._spcod(b, 5, bool(scod & 1)))
            if tile is None:
                self.cod = cod
            else:
                tile.cod = cod
        else:
            c, at = self._comp_index(b, 0)
            if c >= self.ncomp:
                raise broken()
            spcoc = self._spcod(b, at + 1, bool(b[at] & 1))
            (self.coc if tile is None else tile.coc)[c] = spcoc

    def _qcd(self, marker: int, b: bytes, tile: Tile | None) -> None:
        at = 0
        if marker == 0xFF5D:
            c, at = self._comp_index(b, 0)
            if c >= self.ncomp:
                raise broken()
        sq = b[at]
        qntsty, gbits = sq & 0x1F, sq >> 5
        rest = b[at + 1:]
        if qntsty == 0:  # no quantisation: an exponent a band
            steps = [(v >> 3, 0) for v in rest[:97]]
        elif qntsty == 1:  # scalar derived: one step, the rest by level
            if len(rest) != 2:
                raise broken()
            v = int.from_bytes(rest, "big")
            e0, m0 = v >> 11, v & 0x7FF
            steps = [(e0, m0)] + [(max(e0 - (k - 1) // 3, 0), m0) for k in range(1, 97)]
        else:  # scalar expounded, as OpenJPEG takes every other style
            if len(rest) % 2:
                raise broken()
            steps = [(int.from_bytes(rest[i:i + 2], "big") >> 11, int.from_bytes(rest[i:i + 2], "big") & 0x7FF)
                     for i in range(0, min(len(rest), 2 * 97), 2)]
        q = (qntsty, gbits, steps)
        if marker == 0xFF5C:
            if tile is None:
                self.qcd = q
            else:
                tile.qcd = q
        else:
            (self.qcc if tile is None else tile.qcc)[c] = q

    def _poc(self, b: bytes, tile: Tile | None) -> None:
        w = 1 if self.ncomp < 257 else 2
        step = 5 + 2 * w
        if len(b) % step:
            raise broken()
        out = self.pocs if tile is None else tile.pocs
        for i in range(0, len(b), step):
            e = b[i:i + step]
            r0 = e[0]
            c0 = int.from_bytes(e[1:1 + w], "big")
            l1 = int.from_bytes(e[1 + w:3 + w], "big")
            r1 = e[3 + w]
            c1 = int.from_bytes(e[4 + w:4 + 2 * w], "big")
            prg = e[4 + 2 * w]
            if prg > 4:
                raise broken()
            out.append(dict(resno0=r0, compno0=c0, layno1=l1, resno1=r1, compno1=c1, prg=prg))

    def _tile_part(self, pos: int) -> int:
        d = self.data
        marker, p = self._marker(pos)
        body, hend = self._body(p)
        if marker != 0xFF90 or len(body) != 8:
            raise broken()
        isot = int.from_bytes(body[0:2], "big")
        psot = int.from_bytes(body[2:6], "big")
        tpsot, tnsot = body[6], body[7]
        if isot >= self.tw * self.th:
            raise broken()
        tile = self.tiles.get(isot)
        if tile is None:
            tile = self.tiles[isot] = Tile(isot)
        if tile.nparts and tpsot >= tile.nparts or tpsot != len(tile.parts):
            raise broken()  # OpenJPEG takes a tile's tile-parts in the order of their index only
        if tnsot:
            if tpsot >= tnsot:
                raise broken()
            tile.nparts = tnsot
        if psot and psot < 14:
            raise broken()
        q = hend
        while True:
            marker, q2 = self._marker(q)
            if marker == 0xFF93:
                break
            if marker in _TILE:
                q = self._segment(q, tile)
            elif marker in _MAIN or marker in _ELSEWHERE:
                raise broken()  # a marker that has no place in a tile-part header
            else:
                q = self._body(q2)[1]  # a marker OpenJPEG does not know: its segment is read past
            if psot and q > pos + psot:
                raise broken()
        sod = q2
        if psot == 0:  # the last tile-part: it runs to EOC
            end = len(d) - 2
        else:
            end = pos + psot
            if end > len(d) or end < sod:
                raise broken()
        tile.parts.append(d[sod:end])
        if isot in self.order:
            self.order.remove(isot)
        self.order.append(isot)
        return end

    # -- coding parameters of a tile ------------------------------------
    def coding(self, tile: Tile) -> tuple[dict, list]:
        cod = tile.cod or self.cod
        if cod is None:
            raise broken()
        qcd = tile.qcd or self.qcd
        out = []
        for c in range(self.ncomp):
            sp = tile.coc.get(c) or (cod["spcod"] if tile.cod else self.coc.get(c) or cod["spcod"])
            q = tile.qcc.get(c) or (tile.qcd if tile.qcd else self.qcc.get(c) or qcd)
            if q is None:
                raise broken()
            k = Coding(**sp)
            k.qntsty, k.numgbits, k.steps = q
            k.roishift = tile.rgn.get(c, self.rgn.get(c, 0))
            k.steps = list(k.steps) + [(0, 0)] * (97 - len(k.steps))  # OpenJPEG leaves the rest at zero
            out.append(k)
        return cod, out

    def tile_box(self, index: int) -> tuple[int, int, int, int]:
        p, q = index % self.tw, index // self.tw
        return (max(self.xtosiz + p * self.xtsiz, self.xosiz), max(self.ytosiz + q * self.ytsiz, self.yosiz),
                min(self.xtosiz + (p + 1) * self.xtsiz, self.xsiz), min(self.ytosiz + (q + 1) * self.ytsiz, self.ysiz))


class TileComp:
    """A tile-component for tier 2."""

    def __init__(self, box, comp: Comp, coding: Coding):
        self.dx, self.dy = comp.dx, comp.dy
        self.numres = coding.numres
        self.box = tuple(j2k_t2.ceil_div(v, d) for v, d in zip(box, (comp.dx, comp.dy, comp.dx, comp.dy)))
        self.res = j2k_t2.build_resolutions(*self.box, coding)


def decode_tile(cs: Codestream, tile: Tile) -> tuple[tuple, list]:
    """-> (the tile's canvas box, each component's samples as int64 arrays
    of the tile-component's size, level-shifted and clamped)."""
    cod, codings = cs.coding(tile)
    box = cs.tile_box(tile.index)
    tcs = [TileComp(box, comp, k) for comp, k in zip(cs.comps, codings)]
    for tc, comp, k in zip(tcs, cs.comps, codings):
        for resno, res in enumerate(tc.res):
            for band in res.bands:
                e, m = k.steps[0 if resno == 0 else 3 * (resno - 1) + band.bandno]
                band.numbps = e + k.numgbits - 1
                band.stepsize = j2k_dwt.band_stepsize(comp.prec, band.bandno, k.qmfbid, e, m)
    data = b"".join(tile.parts)
    if tile.ppt:
        hdr = j2k_t2.HeaderSource(b"".join(tile.ppt[z] for z in sorted(tile.ppt)))
    elif cs.ppm_source is not None:
        hdr = cs.ppm_source
    else:
        hdr = None
    order = j2k_t2.packet_order(tcs, box, cod["layers"], cod["prg"], tile.pocs or cs.pocs)
    pos = 0
    sop, eph = bool(cod["csty"] & 2), bool(cod["csty"] & 4)
    for lay, resno, compno, precno in order:
        pos = j2k_t2.read_packet(data, pos, len(data), hdr, tcs[compno], resno, precno, lay,
                                 codings[compno].cblksty, sop, eph)
    out = []
    for tc, comp, k in zip(tcs, cs.comps, codings):
        out.append(_reconstruct(tc, comp, k))
    if cod["mct"] and len(out) >= 3:
        if not (out[0].shape == out[1].shape == out[2].shape):
            raise broken()
        j2k_dwt.mct(out, codings[0].qmfbid == 1)
    return box, [j2k_dwt.level_shift(o, comp.prec, comp.sgnd, k.qmfbid == 1)
                 for o, comp, k in zip(out, cs.comps, codings)]


def _reconstruct(tc: TileComp, comp: Comp, k: Coding) -> np.ndarray:
    x0, y0, x1, y1 = tc.box
    rev = k.qmfbid == 1
    buf = np.zeros((y1 - y0, x1 - x0), np.int32 if rev else np.float32)
    for resno, res in enumerate(tc.res):
        for band in res.bands:
            offx = offy = 0
            if band.bandno & 1:
                prev = tc.res[resno - 1]
                offx = prev.x1 - prev.x0
            if band.bandno & 2:
                prev = tc.res[resno - 1]
                offy = prev.y1 - prev.y0
            for prec in band.precincts:
                for cb in prec[2]:
                    if not cb.segs:
                        continue
                    w, h = cb.x1 - cb.x0, cb.y1 - cb.y0
                    if w <= 0 or h <= 0:
                        continue
                    try:
                        vals = j2k_t1.decode_cblk(bytes(cb.data), [(s[0], s[1]) for s in cb.segs], w, h, band.bandno,
                                                  cb.numbps, k.roishift, k.cblksty)
                    except ValueError as e:
                        raise broken() from e
                    bx, by = cb.x0 - band.x0 + offx, cb.y0 - band.y0 + offy
                    buf[by:by + h, bx:bx + w] = j2k_dwt.place(vals, k.roishift, k.qmfbid, band.stepsize)
    return j2k_dwt.idwt(buf, [(r.x0, r.y0, r.x1, r.y1) for r in tc.res], rev)


def decode_tiles(cs: Codestream):
    """Each tile as OpenJPEG hands it to PIL: (canvas box, components)."""
    for index in cs.order:
        yield decode_tile(cs, cs.tiles[index])
