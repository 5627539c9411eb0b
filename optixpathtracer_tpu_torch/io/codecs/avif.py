"""AVIF, as PIL 12 reads it through libavif 1.3: the HEIF / ISOBMFF
container, the primary item's AV1 still (4:2:0, 4:2:2, 4:4:4 or 4:0:0; 8,
10 or 12 bits) through codecs/av1_obu.py and the native tile decoder, then
libavif's YUV -> RGB (codecs/avif_yuv.py).

The container: `ftyp` (libavif's brand rules: the file is AVIF when the
major or a compatible brand is `avif` or `avis`; otherwise PIL's plugin
refuses it and the search goes on), `meta` with `hdlr` (pict), `pitm`,
`iinf` / `infe` (versions 2 and 3), `iloc` (versions 0-2, construction
methods 0 and 1 through `idat`, several extents), `iref` (auxl / thmb /
dimg), `iprp` / `ipco` / `ipma` (the essential bits: libavif skips an
item with an essential property it does not parse, so the port fails a
primary item with one as PIL does), `ispe`, `pixi`,
`av1C`, `colr` (nclx gives the matrix and range; an ICC profile is kept
out of the pixels, as PIL keeps it), and `irot` / `imir` / `clap`, which
PIL leaves to the EXIF orientation it reports: the pixels stay as coded
(libavif refuses them, and `a1op` / `lsel`, unless marked essential, and
`a1lx` marked so; so does the port, as no format, and so it does a `meta`
whose handler is not `pict` and an av01 item without `ispe` or `av1C`).

PIL's failures are kept: no `avif` / `avis` brand -> NotThisFormat (PIL's
plugin raises SyntaxError and `Image.open` goes on to
UnidentifiedImageError); a primary item that is missing or not `av01` ->
"Failed to decode image: Missing or empty image item"; cut or corrupt data
-> "Failed to decode frame 0: ...". The port keeps its own
`DecodeError` (ValueError + OSError) for the last two where PIL raises
RuntimeError and SyntaxError (ROADMAP C.14). A `grid` item and image
sequences raise NotImplementedError naming the variant and ROADMAP A.1
(AVIF step 5).

Alpha: an av01 item with an `auxl` reference to the primary item and the
alpha URN in its `auxC` is decoded with the same decoder (libaom writes it
as a full-range monochrome still, with the colour's coding tools: libavif
hands aom's film grain, quantizer matrix and delta q options to both items,
and dav1d applies the alpha's grain) and its Y plane is the alpha. PIL's
`convert("RGB")` drops alpha, so straight alpha leaves the colour as it
decodes; with a `prem` reference from the colour item to the alpha item
(PIL's `alpha_premultiplied=True`) libavif un-premultiplies the colour by
the alpha before PIL sees it, and so does the port (avif_yuv.unpremultiply).
libavif ignores an alpha item without data (but fails on one cut short),
as the port does, fails on an alpha item of another bit depth than the
colour's ("Decoding of alpha plane failed"), as the port does, brings a
10- or 12-bit alpha to 8 bits before it un-premultiplies
(avif_yuv.alpha8), and scales
an alpha plane of another size than the colour's to it: with straight
alpha that changes nothing PIL returns; premultiplied, it raises A.1, as
does a premultiplied alpha in limited range."""
from __future__ import annotations

import numpy as np

from . import av1_obu
from ._common import DecodeError, NotThisFormat, u16be, u32be
from .avif_yuv import alpha8, to_rgb, unpremultiply

MISSING_ITEM = "Failed to decode image: Missing or empty image item"
TRUNCATED = "Failed to decode frame 0: Truncated data"
ALPHA_FAILED = "Failed to decode frame 0: Decoding of alpha plane failed"
BMFF_FAILED = "Failed to decode frame 0: BMFF parsing failed"
TRANSFORMS = (b"clap", b"irot", b"imir")
MUST_BE_ESSENTIAL = TRANSFORMS + (b"a1op", b"lsel")
# the properties libavif 1.3 parses; any other marked essential makes it skip the item
KNOWN_PROPERTIES = MUST_BE_ESSENTIAL + (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"pixi", b"a1lx", b"clli")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of each box in data[pos:end]."""
    while pos + 8 <= end:
        size, kind = u32be(data, pos), data[pos + 4:pos + 8]
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise DecodeError(TRUNCATED)
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise DecodeError(TRUNCATED)
        yield kind, pos + head, pos + size
        pos += size


def _uint(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise DecodeError(TRUNCATED)
    return int.from_bytes(data[pos:pos + n], "big") if n else 0


def brands(data: bytes) -> tuple[bytes, list[bytes]]:
    """The ftyp box's major and compatible brands."""
    for kind, s, e in _boxes(data, 0, min(len(data), 1 << 20)):
        if kind == b"ftyp":
            return data[s:s + 4], [data[i:i + 4] for i in range(s + 8, e - 3, 4)]
        break
    raise NotThisFormat("no ftyp box")


class _Meta:
    def __init__(self):
        self.primary = None
        self.items = {}      # id -> type
        self.locs = {}       # id -> (construction method, base offset, [(offset, length)])
        self.props = []      # ipco children: (type, start, end)
        self.assoc = {}      # id -> [(property index (1-based), essential)]
        self.refs = []       # (type, from id, [to ids])
        self.idat = None
        self.handler = None


def _parse_meta(data: bytes, s: int, e: int) -> _Meta:
    m = _Meta()
    for kind, bs, be in _boxes(data, s + 4, e):  # meta is a full box
        if kind == b"hdlr":
            m.handler = data[bs + 8:bs + 12]
        elif kind == b"pitm":
            m.primary = _uint(data, bs + 4, 2 if data[bs] == 0 else 4)
        elif kind == b"iinf":
            n_size = 2 if data[bs] == 0 else 4
            at = bs + 4 + n_size
            for ik, is_, ie in _boxes(data, at, be):
                if ik != b"infe":
                    continue
                version = data[is_]
                if version < 2:
                    continue
                id_size = 2 if version == 2 else 4
                item_id = _uint(data, is_ + 4, id_size)
                item_type = data[is_ + 4 + id_size + 2:is_ + 4 + id_size + 6]
                m.items[item_id] = item_type
        elif kind == b"iloc":
            _parse_iloc(data, bs, be, m)
        elif kind == b"iprp":
            for pk, ps, pe in _boxes(data, bs, be):
                if pk == b"ipco":
                    m.props = list(_boxes(data, ps, pe))
                elif pk == b"ipma":
                    version, flags = data[ps], _uint(data, ps + 1, 3)
                    count = _uint(data, ps + 4, 4)
                    at = ps + 8
                    for _ in range(count):
                        n = 2 if version < 1 else 4
                        item_id = _uint(data, at, n)
                        at += n
                        k = _uint(data, at, 1)
                        at += 1
                        idx = []
                        for _ in range(k):
                            if flags & 1:
                                v = _uint(data, at, 2)
                                idx.append((v & 0x7FFF, v >> 15))
                                at += 2
                            else:
                                v = _uint(data, at, 1)
                                idx.append((v & 0x7F, v >> 7))
                                at += 1
                        m.assoc.setdefault(item_id, []).extend(idx)
        elif kind == b"iref":
            id_size = 2 if data[bs] == 0 else 4
            for rk, rs, re_ in _boxes(data, bs + 4, be):
                frm = _uint(data, rs, id_size)
                n = _uint(data, rs + id_size, 2)
                to = [_uint(data, rs + id_size + 2 + i * id_size, id_size) for i in range(n)]
                m.refs.append((rk, frm, to))
        elif kind == b"idat":
            m.idat = (bs, be)
    return m


def _parse_iloc(data: bytes, s: int, e: int, m: _Meta) -> None:
    version = data[s]
    a, b = data[s + 4], data[s + 5]
    off_size, len_size, base_size = a >> 4, a & 15, b >> 4
    idx_size = b & 15 if version in (1, 2) else 0
    at = s + 6
    n_size = 2 if version < 2 else 4
    count = _uint(data, at, n_size)
    at += n_size
    for _ in range(count):
        item_id = _uint(data, at, n_size)
        at += n_size
        method = 0
        if version in (1, 2):
            method = _uint(data, at, 2) & 15
            at += 2
        at += 2  # data_reference_index
        base = _uint(data, at, base_size)
        at += base_size
        n_ext = _uint(data, at, 2)
        at += 2
        extents = []
        for _ in range(n_ext):
            at += idx_size
            off = _uint(data, at, off_size)
            at += off_size
            ln = _uint(data, at, len_size)
            at += len_size
            extents.append((off, ln))
        m.locs[item_id] = (method, base, extents)


def _item_data(data: bytes, m: _Meta, item_id: int) -> bytes:
    if item_id not in m.locs:
        raise DecodeError(MISSING_ITEM)
    method, base, extents = m.locs[item_id]
    if method == 0:
        src, lo, hi = data, 0, len(data)
    elif method == 1 and m.idat is not None:
        src, lo, hi = data, m.idat[0], m.idat[1]
    else:
        raise DecodeError(MISSING_ITEM)
    out = bytearray()
    for off, ln in extents:
        start = lo + base + off  # an extent of length 0 is empty, as libavif reads it
        if start > hi:
            raise DecodeError(BMFF_FAILED)
        if start + ln > hi:
            raise DecodeError(TRUNCATED)
        out += src[start:start + ln]
    if not out:
        raise DecodeError(MISSING_ITEM)
    return bytes(out)


def _nclx(data: bytes, m: _Meta, item_id: int):
    """(matrix_coefficients, full range) of the item's nclx colr, which
    libavif takes over the AV1 sequence header's; None without one."""
    for i, _ in m.assoc.get(item_id, []):
        if 1 <= i <= len(m.props):
            kind, s, e = m.props[i - 1]
            if kind == b"colr" and data[s:s + 4] == b"nclx" and e - s >= 11:
                return u16be(data, s + 8), data[s + 10] >> 7
    return None


def parse(data: bytes):
    """An AVIF file -> (the primary item's AV1 OBUs, (matrix, full range) of
    its nclx colr or None)."""
    obus, colour, _, _ = _parse(data)
    return obus, colour


def _alpha_item(meta: _Meta, data: bytes):
    """The id of the primary item's alpha item, or None."""
    for rk, frm, to in meta.refs:
        if rk == b"auxl" and meta.primary in to and meta.items.get(frm) == b"av01":
            for i, _ in meta.assoc.get(frm, []):
                if 1 <= i <= len(meta.props):
                    pk, ps, pe = meta.props[i - 1]
                    if pk == b"auxC" and data[ps + 4:pe].rstrip(b"\0") in ALPHA_URNS:
                        return frm
    return None


def _parse(data: bytes):
    """-> (primary OBUs, its nclx colour or None, the alpha item's OBUs or
    None, premultiplied)."""
    major, compat = brands(data)
    if b"avif" not in [major] + compat and b"avis" not in [major] + compat:
        raise NotThisFormat("no avif / avis brand")
    meta = None
    has_moov = False
    for kind, s, e in _boxes(data, 0, len(data)):
        if kind == b"meta":
            meta = _parse_meta(data, s, e)
        elif kind == b"moov":
            has_moov = True
    if meta is None:
        if has_moov:
            raise av1_obu.unsupported("image sequences")
        raise DecodeError(MISSING_ITEM)
    if meta.primary is None or meta.primary not in meta.items:
        raise DecodeError(MISSING_ITEM)
    kind = meta.items[meta.primary]
    if kind == b"grid":
        raise av1_obu.unsupported("grid images")
    if kind != b"av01":
        raise DecodeError(MISSING_ITEM)
    if meta.handler != b"pict":
        raise NotThisFormat("no pict handler")  # libavif's parse fails, PIL identifies no image
    props = [meta.props[i - 1][0] for i, _ in meta.assoc.get(meta.primary, []) if 1 <= i <= len(meta.props)]
    if b"ispe" not in props or b"av1C" not in props:
        raise NotThisFormat("av01 item without ispe / av1C")  # as libavif's parse
    for i, essential in (a for assoc in meta.assoc.values() for a in assoc):
        kind = meta.props[i - 1][0] if 1 <= i <= len(meta.props) else None
        # libavif's parse refuses these unless marked essential, and a1lx
        # marked so; PIL then identifies no image
        if kind in MUST_BE_ESSENTIAL and not essential:
            raise NotThisFormat(f"non-essential {kind!r} property")
        if kind == b"a1lx" and essential:
            raise NotThisFormat("essential a1lx property")
    for i, essential in meta.assoc.get(meta.primary, []):
        if essential and 1 <= i <= len(meta.props) and meta.props[i - 1][0] not in KNOWN_PROPERTIES:
            raise DecodeError(MISSING_ITEM)  # libavif skips an item whose essential property it does not know
    obus = _item_data(data, meta, meta.primary)
    alpha, premultiplied = _alpha_item(meta, data), False
    if alpha is not None:
        try:
            alpha_obus = _item_data(data, meta, alpha)
        except DecodeError as e:
            if str(e) != MISSING_ITEM:
                raise
            alpha_obus = None  # libavif decodes the colour alone
        premultiplied = any(rk == b"prem" and frm == meta.primary and alpha in to for rk, frm, to in meta.refs)
        alpha = alpha_obus
    return obus, _nclx(data, meta, meta.primary), alpha, premultiplied


def _decode(obus: bytes, colour):
    """-> (Y, U, V, the sequence header, (matrix, full range)): the colour
    of the nclx colr, else of the sequence header."""
    y, u, v, seq = av1_obu.decode(obus)
    return y, u, v, seq, colour if colour is not None else (seq["color"][2], seq["color_range"])


def _decode_alpha(obus: bytes):
    """The alpha item's OBUs -> (its Y plane, its sequence header)."""
    try:
        alpha, _, _, seq = av1_obu.decode(obus)
    except DecodeError as e:
        raise DecodeError(ALPHA_FAILED) from e
    return alpha, seq


def planes(data: bytes):
    """An AVIF file -> (Y, U, V (None for 4:0:0), the sequence header,
    (matrix, full range))."""
    return _decode(*parse(data))


def alpha_plane(data: bytes):
    """An AVIF file -> (its alpha plane or None, premultiplied)."""
    _, _, obus, premultiplied = _parse(data)
    return (None, False) if obus is None else (_decode_alpha(obus)[0], premultiplied)


def rgb8(data: bytes) -> np.ndarray:
    obus, colour, alpha_obus, premultiplied = _parse(data)
    y, u, v, seq, (matrix, full) = _decode(obus, colour)
    depth, ss = seq["bit_depth"], None if u is None else seq["ss"]
    rgb = to_rgb(y, u, v, ss, matrix, full, rgba=alpha_obus is not None, depth=depth)
    if alpha_obus is not None:
        alpha, aseq = _decode_alpha(alpha_obus)  # decoded also when straight: it fails as libavif fails
        if aseq["bit_depth"] != depth:
            raise DecodeError(ALPHA_FAILED)
        if premultiplied:
            if alpha.shape != y.shape:
                raise av1_obu.unsupported("premultiplied alpha of another size than the colour (libavif scales it)")
            if not aseq["color_range"]:
                raise av1_obu.unsupported("limited-range premultiplied alpha")
            rgb = unpremultiply(rgb, alpha8(alpha, aseq["bit_depth"], ss))
    return rgb
