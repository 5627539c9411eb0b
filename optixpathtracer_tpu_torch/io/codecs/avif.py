"""AVIF, as PIL 12 reads it through libavif 1.3: the HEIF / ISOBMFF
container, the primary item's AV1 still (4:2:0, 4:2:2, 4:4:4 or 4:0:0; 8,
10 or 12 bits) or grid of such stills, or an image sequence's first AV1
track's first sample, through codecs/av1_obu.py and the native tile
decoder, scaled to its item's size where libavif scales it
(codecs/avif_scale.py), then libavif's YUV -> RGB (codecs/avif_yuv.py,
which hands the matrices libyuv does not take to codecs/avif_reformat.py).

The container: `ftyp` (libavif's brand rules: the file is AVIF when the
major or a compatible brand is `avif` or `avis`; otherwise PIL's plugin
refuses it and the search goes on), `meta` with `hdlr` (pict), `pitm`,
`iinf` / `infe` (versions 2 and 3), `iloc` (versions 0-2, construction
methods 0 and 1 through `idat`, several extents), `iref` (auxl / thmb /
dimg / prem), `iprp` / `ipco` / `ipma` (the essential bits: libavif skips
an item with an essential property it does not parse, so the port fails a
primary item with one as PIL does), `ispe`, `pixi`, `av1C`, `colr` (nclx
gives the matrix, range and colour primaries; an ICC profile is kept out
of the pixels, as PIL keeps it), and `irot` / `imir` / `clap`, which PIL
leaves to the EXIF orientation it reports: the pixels stay as coded
(libavif refuses them, and `a1op` / `lsel`, unless marked essential, and
`a1lx` marked so; so does the port, as no format, and so it does a `meta`
whose handler is not `pict` and an image item without `ispe`, or an av01
one without `av1C`). An AV1 frame of another size than its item's `ispe`
is scaled to it, as libavif scales it (each grid cell to its own).

Sources, as libavif's AVIF_DECODER_SOURCE_AUTO picks them: an `avis`
major brand reads the tracks, an `avif` one the primary item, any other
the tracks where the `moov` has some; a brand `avif` wants a `meta` and
`avis` a `moov` (else libavif's parse fails and PIL identifies no image).
The track is the first with an id, a chunk and an `av01` sample
description that is no other's auxiliary (none: no image to PIL either);
its sample 0 (`stsz`, `stco` / `co64`) is decoded as a still of its
`tkhd` size, with the sample entry's nclx `colr`; an alpha track is the
one auxiliary (`auxl`) to it, premultiplied where the colour track's
`tref` has `prem`.

Grids: a `grid` primary item's ImageGrid (version 0, rows and columns,
16- or 32-bit output size) lays its `dimg` cells (av01 items, in the
reference's order) out row-major; the planes are cropped to the output
size and converted once, so that the chroma upsampling crosses the cells'
edges as libavif's does; the colour is the grid item's nclx, else the
first cell's sequence header. libavif's refusals are kept, with PIL's
messages: at parse ("Failed to decode image: Invalid image grid") a cell
count other than rows x columns, a repeated or dangling reference, a cell
that is not av01 or has an essential property libavif does not know, a
first cell without av1C, another ImageGrid version, trailing bytes, an
output size of 0, above 32768 or above 16384 x 16384; once the cells are
decoded ("Failed to decode frame 0: Invalid image grid") cells of another
size, depth, layout, range or colour than the first's, cells that do not
cover the output or leave a row or column of it out, cells under 64 x 64
or of an odd size (or an odd output size) where chroma is subsampled. PIL
sizes the image by the grid's `ispe` and reads libavif's buffer at that
size, which the port does too.

PIL's failures are kept: no `avif` / `avis` brand -> NotThisFormat (PIL's
plugin raises SyntaxError and `Image.open` goes on to
UnidentifiedImageError); a primary item that is missing or neither `av01`
nor `grid` -> "Failed to decode image: Missing or empty image item"; cut
or corrupt data -> "Failed to decode frame 0: ...". The port keeps its own
`DecodeError` (ValueError + OSError) for the last two where PIL raises
RuntimeError and SyntaxError (ROADMAP C.14). What the port does not
decode yet, the inter tools of AVIF steps 8 and 9, raises
NotImplementedError naming the tool and ROADMAP A.1 (codecs/av1_obu.py).

Alpha: an av01 (or grid) item with an `auxl` reference to the primary item
and the alpha URN in its `auxC` is decoded with the same decoder (libaom
writes it as a full-range monochrome still, with the colour's coding
tools: libavif hands aom's film grain, quantizer matrix and delta q
options to both items, and dav1d applies the alpha's grain) and its Y
plane is the alpha; an alpha grid is laid out as the colour's, of its own
geometry, and must come to the colour's output size. PIL's
`convert("RGB")` drops alpha, so straight alpha leaves the colour as it
decodes; with a `prem` reference from the colour item to the alpha item
(PIL's `alpha_premultiplied=True`) libavif un-premultiplies the colour by
the alpha before PIL sees it, and so does the port (avif_yuv.to_rgb).
libavif ignores an alpha item without data (but fails on one cut short),
as the port does, fails on an alpha item of another bit depth than the
colour's ("Decoding of alpha plane failed"), as the port does, brings a
limited-range alpha to full range and a 10- or 12-bit alpha to 8 bits
before it un-premultiplies (avif_yuv.alpha_bytes), scales an alpha frame
of another size than its ispe to it, and fails an alpha whose ispe is not
the colour's ("Decoding of alpha plane failed"; a grid's "Invalid image
grid"), straight or premultiplied, as the port does."""
from __future__ import annotations

import numpy as np

from . import av1_obu
from ._common import DecodeError, NotThisFormat, u16be, u32be
from .avif_scale import scale
from .avif_yuv import alpha_bytes, to_rgb

MISSING_ITEM = "Failed to decode image: Missing or empty image item"
INVALID_GRID = "Failed to decode image: Invalid image grid"  # libavif's parse refuses the grid
GRID_FAILED = "Failed to decode frame 0: Invalid image grid"  # its cells cannot be laid out
DIMENSION_LIMIT, SIZE_LIMIT = 32768, 16384 * 16384  # libavif's default limits on a grid's output
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
    """(matrix_coefficients, full range, colour primaries) of the item's
    nclx colr, which libavif takes over the AV1 sequence header's; None
    without one."""
    for i, _ in m.assoc.get(item_id, []):
        if 1 <= i <= len(m.props):
            kind, s, e = m.props[i - 1]
            if kind == b"colr" and data[s:s + 4] == b"nclx" and e - s >= 11:
                return u16be(data, s + 8), data[s + 10] >> 7, u16be(data, s + 4)
    return None


def _props_of(meta: _Meta, item_id: int) -> list:
    """(type, start, end, essential) of each property of the item."""
    return [(*meta.props[i - 1], essential) for i, essential in meta.assoc.get(item_id, [])
            if 1 <= i <= len(meta.props)]


def _ispe(data: bytes, meta: _Meta, item_id: int):
    """(width, height) of the item's ispe, or None."""
    for kind, s, e, _ in _props_of(meta, item_id):
        if kind == b"ispe" and e - s >= 12:
            return u32be(data, s + 4), u32be(data, s + 8)
    return None


class _Image:
    """An image item: one av01 item (`cells` its OBUs alone), or a grid of
    rows x cols av01 cells laid out row-major and cropped to the output
    (width, height); `ispe` the item's own (width, height) and `cell_ispe`
    each cell's."""

    def __init__(self, cells: list, ispe, cell_ispe: list, grid=None):
        self.cells, self.ispe, self.cell_ispe, self.grid = cells, ispe, cell_ispe, grid


def _image_grid(payload: bytes):
    """An ImageGrid payload (HEIF 6.6.2.3) -> (rows, cols, width, height),
    as libavif 1.3 parses and bounds it."""
    if len(payload) < 4 or payload[0] != 0:
        raise DecodeError(INVALID_GRID)
    rows, cols, n = payload[2] + 1, payload[3] + 1, 4 if payload[1] & 1 else 2
    if len(payload) != 4 + 2 * n:
        raise DecodeError(INVALID_GRID)
    width, height = _uint(payload, 4, n), _uint(payload, 4 + n, n)
    if not width or not height or width > DIMENSION_LIMIT or height > DIMENSION_LIMIT or width * height > SIZE_LIMIT:
        raise DecodeError(INVALID_GRID)
    return rows, cols, width, height


def _image_item(data: bytes, meta: _Meta, item_id: int) -> _Image:
    """The item's OBUs, and for a grid its cells' in their `dimg` order,
    with libavif's refusals of a grid it cannot lay out."""
    if meta.items.get(item_id) != b"grid":
        return _Image([_item_data(data, meta, item_id)], _ispe(data, meta, item_id), [_ispe(data, meta, item_id)])
    geometry = _image_grid(_item_data(data, meta, item_id))
    cells = [c for rk, frm, to in meta.refs if rk == b"dimg" and frm == item_id for c in to]
    rows, cols = geometry[:2]
    if len(cells) != rows * cols or len(set(cells)) != len(cells) or any(meta.items.get(c) != b"av01" for c in cells):
        raise DecodeError(INVALID_GRID)
    for c in cells:
        props = _props_of(meta, c)
        if any(essential and kind not in KNOWN_PROPERTIES for kind, _, _, essential in props):
            raise DecodeError(INVALID_GRID)  # libavif decodes no grid with a cell it cannot
        if not any(kind == b"ispe" for kind, _, _, _ in props):
            raise NotThisFormat("av01 item without ispe")
    if not any(kind == b"av1C" for kind, _, _, _ in _props_of(meta, cells[0])):
        raise DecodeError(INVALID_GRID)  # the grid adopts its first cell's av1C
    return _Image([_item_data(data, meta, c) for c in cells], _ispe(data, meta, item_id),
                  [_ispe(data, meta, c) for c in cells], geometry)


def parse(data: bytes):
    """An AVIF file -> (the primary item's AV1 OBUs (a grid's first cell's),
    (matrix, full range, colour primaries) of its nclx colr or None)."""
    image, colour, _, _ = _read(data)
    return image.cells[0], colour


def _alpha_item(meta: _Meta, data: bytes):
    """The id of the primary item's alpha item, or None."""
    for rk, frm, to in meta.refs:
        if rk == b"auxl" and meta.primary in to and meta.items.get(frm) in (b"av01", b"grid"):
            for i, _ in meta.assoc.get(frm, []):
                if 1 <= i <= len(meta.props):
                    pk, ps, pe = meta.props[i - 1]
                    if pk == b"auxC" and data[ps + 4:pe].rstrip(b"\0") in ALPHA_URNS:
                        return frm
    return None


def _parse(data: bytes):
    """-> (primary OBUs (a grid's first cell's), its nclx colour or None,
    the alpha item's OBUs (its first cell's) or None, premultiplied)."""
    image, colour, alpha, premultiplied = _read(data)
    return image.cells[0], colour, None if alpha is None else alpha.cells[0], premultiplied


def _read(data: bytes):
    """-> (the primary _Image, its nclx colour or None, the alpha _Image or
    None, premultiplied): the primary item's, or the first AV1 track's
    first sample where libavif reads the tracks."""
    major, compat = brands(data)
    if b"avif" not in [major] + compat and b"avis" not in [major] + compat:
        raise NotThisFormat("no avif / avis brand")
    meta, moov = None, None
    for kind, s, e in _boxes(data, 0, len(data)):
        if kind == b"meta":
            meta = _parse_meta(data, s, e)
        elif kind == b"moov":
            moov = (s, e)
    # libavif's parse wants a meta where a brand says avif and a moov where
    # one says avis (PIL then identifies no image)
    if (meta is None and b"avif" in [major] + compat) or (moov is None and b"avis" in [major] + compat):
        raise NotThisFormat("no meta / moov box for the brands")
    tracks = [] if moov is None else _tracks(data, *moov)
    # AVIF_DECODER_SOURCE_AUTO: the major brand decides, else any track
    if major == b"avis" or (major != b"avif" and tracks):
        return _from_tracks(data, tracks)
    if meta is None:
        raise DecodeError(MISSING_ITEM)
    if meta.primary is None or meta.primary not in meta.items:
        raise DecodeError(MISSING_ITEM)
    kind = meta.items[meta.primary]
    if kind not in (b"av01", b"grid"):
        raise DecodeError(MISSING_ITEM)
    if meta.handler != b"pict":
        raise NotThisFormat("no pict handler")  # libavif's parse fails, PIL identifies no image
    props = [p[0] for p in _props_of(meta, meta.primary)]
    if b"ispe" not in props or (kind == b"av01" and b"av1C" not in props):
        raise NotThisFormat("image item without ispe / av1C")  # as libavif's parse
    for i, essential in (a for assoc in meta.assoc.values() for a in assoc):
        kind = meta.props[i - 1][0] if 1 <= i <= len(meta.props) else None
        # libavif's parse refuses these unless marked essential, and a1lx
        # marked so; PIL then identifies no image
        if kind in MUST_BE_ESSENTIAL and not essential:
            raise NotThisFormat(f"non-essential {kind!r} property")
        if kind == b"a1lx" and essential:
            raise NotThisFormat("essential a1lx property")
    if any(essential and kind not in KNOWN_PROPERTIES for kind, _, _, essential in _props_of(meta, meta.primary)):
        raise DecodeError(MISSING_ITEM)  # libavif skips an item whose essential property it does not know
    image = _image_item(data, meta, meta.primary)
    alpha, premultiplied = _alpha_item(meta, data), False
    if alpha is not None:
        premultiplied = any(rk == b"prem" and frm == meta.primary and alpha in to for rk, frm, to in meta.refs)
        try:
            alpha = _image_item(data, meta, alpha)
        except DecodeError as e:
            if str(e) != MISSING_ITEM:
                raise
            alpha = None  # libavif decodes the colour alone
    return image, _nclx(data, meta, meta.primary), alpha, premultiplied


class _Track:
    def __init__(self):
        self.id, self.size, self.refs, self.handler = 0, (0, 0), {}, None
        self.entry = None     # (type, the sample entry's child boxes) of the first sample description
        self.first = None     # (offset, size) of sample 0, or None without a chunk


def _tracks(data: bytes, s: int, e: int) -> list:
    """The `trak` boxes of a `moov`, as far as libavif reads them for sample
    0: tkhd (id, width, height), tref, the media handler, the first sample
    description, and sample 0's place from stsz, stsc and stco / co64."""
    out = []
    for kind, ts, te in _boxes(data, s, e):
        if kind != b"trak":
            continue
        t, sizes, chunks = _Track(), None, []
        stack = [(ts, te)]
        while stack:
            for bk, bs, be in _boxes(data, *stack.pop()):
                if bk in (b"mdia", b"minf", b"stbl"):
                    stack.append((bs, be))
                elif bk == b"tkhd":
                    at = bs + (20 if data[bs] == 1 else 12)
                    t.id = _uint(data, at, 4)
                    at += 68 if data[bs] == 1 else 64  # to width
                    t.size = (_uint(data, at, 4) >> 16, _uint(data, at + 4, 4) >> 16)
                elif bk == b"tref":
                    for rk, rs, re_ in _boxes(data, bs, be):
                        t.refs[rk] = [_uint(data, i, 4) for i in range(rs, re_ - 3, 4)]
                elif bk == b"hdlr":
                    t.handler = data[bs + 8:bs + 12]
                elif bk == b"stsd" and t.entry is None:
                    for ek, es, ee in _boxes(data, bs + 8, be):
                        t.entry = (ek, list(_boxes(data, es + 78, ee)) if ee - es >= 78 else [])
                        break
                elif bk == b"stsz":
                    fixed, count = _uint(data, bs + 4, 4), _uint(data, bs + 8, 4)
                    sizes = fixed if fixed or not count else _uint(data, bs + 12, 4)
                elif bk in (b"stco", b"co64"):
                    width = 4 if bk == b"stco" else 8
                    chunks = [_uint(data, bs + 8 + i * width, width) for i in range(min(_uint(data, bs + 4, 4), 1))]
        if chunks and sizes is not None:
            t.first = (chunks[0], sizes)
        out.append(t)
    return out


def _from_tracks(data: bytes, tracks: list):
    """libavif's track source: the first track with an id, a chunk and an
    av01 sample description that is no other track's auxiliary, and the
    alpha track auxiliary to it; each one's sample 0 decoded as a still,
    sized by its tkhd."""
    colour = next((t for t in tracks if t.id and t.first and t.entry and t.entry[0] == b"av01"
                   and not t.refs.get(b"auxl")), None)
    if colour is None:
        raise NotThisFormat("no AV1 colour track")  # libavif's parse fails, PIL identifies no image
    alpha = next((t for t in tracks if t.id and t.first and t.entry and t.entry[0] == b"av01"
                  and colour.id in t.refs.get(b"auxl", [])), None)

    def sample(t: _Track) -> _Image:
        offset, size = t.first
        if offset + size > len(data):
            raise DecodeError(TRUNCATED)
        return _Image([data[offset:offset + size]], t.size, [t.size])
    nclx = None
    for kind, s, e in colour.entry[1]:
        if kind == b"colr" and data[s:s + 4] == b"nclx" and e - s >= 11:
            nclx = u16be(data, s + 8), data[s + 10] >> 7, u16be(data, s + 4)
    premultiplied = alpha is not None and alpha.id in colour.refs.get(b"prem", [])  # a prem tref to the alpha
    return sample(colour), nclx, None if alpha is None else sample(alpha), premultiplied


def _frame(obus: bytes, ispe, alpha: bool = False):
    """One av01 item's planes and sequence header, a frame of another size
    than the item's ispe (or track's tkhd) scaled to it as libavif scales
    it (avif_scale); an alpha item's limited range brought to full first,
    as libavif brings it."""
    y, u, v, seq = av1_obu.decode(obus)
    if alpha and not seq["color_range"]:
        y = _alpha_limited_to_full(y, seq["bit_depth"])
    if ispe is not None and (y.shape[1], y.shape[0]) != tuple(ispe):
        y, u, v = scale(y, u, v, None if u is None else seq["ss"], *ispe)
    return y, u, v, seq


def _alpha_limited_to_full(a: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY on each alpha sample: ((v - 16) * 255 +
    109) / 219 at 8 bits (64 / 940 at 10, 256 / 3760 at 12), clamped (C's
    truncation and a floor part only below 0, which the clamp takes)."""
    lo, span, top = 16 << (depth - 8), 219 << (depth - 8), (1 << depth) - 1
    v = ((a.astype(np.int64) - lo) * top + span // 2) // span
    return np.clip(v, 0, top).astype(a.dtype)


def _layout(seq: dict):
    return "mono" if seq["mono"] else tuple(seq["ss"])


def _assemble(image: _Image, frames: list):
    """A grid's cells' planes laid out row-major and cropped to the output
    size, with libavif's refusals of cells it cannot lay out."""
    rows, cols, width, height = image.grid
    y0, _, _, seq = frames[0]
    ch, cw = y0.shape
    same = (cw, ch, seq["bit_depth"], _layout(seq), seq["color_range"], seq["color"])
    if any((y.shape[1], y.shape[0], s["bit_depth"], _layout(s), s["color_range"], s["color"]) != same
           for y, _, _, s in frames):
        raise DecodeError(GRID_FAILED)  # mismatched cells
    if cw * cols < width or ch * rows < height or cw * (cols - 1) >= width or ch * (rows - 1) >= height:
        raise DecodeError(GRID_FAILED)  # cells that do not cover the output, or a row or column left out
    sx, sy = (0, 0) if seq["mono"] else seq["ss"]
    if cw < 64 or ch < 64 or (sx and (width | cw) & 1) or (sy and (height | ch) & 1):
        raise DecodeError(GRID_FAILED)  # MIAF 7.3.11.4.2: cells of 64 and more, even where chroma is subsampled

    def tile(k: int, shrink: tuple):
        planes = [f[k] for f in frames]
        if planes[0] is None:
            return None
        full = np.concatenate([np.concatenate(planes[r * cols:(r + 1) * cols], 1) for r in range(rows)], 0)
        return full[:(height + shrink[1]) >> shrink[1], :(width + shrink[0]) >> shrink[0]]
    return tile(0, (0, 0)), tile(1, (sx, sy)), tile(2, (sx, sy)), seq


def _decode_image(image: _Image):
    """An _Image -> (Y, U, V (None for 4:0:0), the (first cell's) sequence
    header)."""
    frames = [_frame(obus, ispe) for obus, ispe in zip(image.cells, image.cell_ispe)]
    return frames[0] if image.grid is None else _assemble(image, frames)


def _colour(colour, seq: dict):
    """(matrix, full range, colour primaries): the nclx colr's, else the
    sequence header's."""
    return colour if colour is not None else (seq["color"][2], seq["color_range"], seq["color"][0])


def _decode_alpha(image: _Image):
    """The alpha _Image -> (its Y plane (a grid's assembled), scaled to its
    ispe and in full range, its sequence header)."""
    try:
        frames = [_frame(obus, ispe, alpha=True) for obus, ispe in zip(image.cells, image.cell_ispe)]
    except DecodeError as e:
        raise DecodeError(ALPHA_FAILED) from e
    alpha, _, _, seq = frames[0] if image.grid is None else _assemble(image, frames)
    return alpha, seq


def planes(data: bytes):
    """An AVIF file -> (Y, U, V (None for 4:0:0), the sequence header,
    (matrix, full range, colour primaries)); a grid's planes assembled."""
    image, colour, _, _ = _read(data)
    y, u, v, seq = _decode_image(image)
    return y, u, v, seq, _colour(colour, seq)


def alpha_plane(data: bytes):
    """An AVIF file -> (its alpha plane or None, premultiplied)."""
    _, _, alpha, premultiplied = _read(data)
    return (None, False) if alpha is None else (_decode_alpha(alpha)[0], premultiplied)


def rgb8(data: bytes) -> np.ndarray:
    image, colour, alpha_image, premultiplied = _read(data)
    y, u, v, seq = _decode_image(image)
    matrix, full, primaries = _colour(colour, seq)
    depth, ss = seq["bit_depth"], None if u is None else seq["ss"]
    alpha = None
    if alpha_image is not None:
        alpha, aseq = _decode_alpha(alpha_image)  # decoded also when straight: it fails as libavif fails
        if aseq["bit_depth"] != depth:
            raise DecodeError(ALPHA_FAILED)
        if alpha.shape != y.shape:  # each scaled to its own ispe, which must then agree
            raise DecodeError(GRID_FAILED if alpha_image.grid is not None else ALPHA_FAILED)
    rgb = to_rgb(y, u, v, ss, matrix, full, rgba=alpha is not None, depth=depth, primaries=primaries,
                 alpha=alpha if premultiplied else None)
    if image.grid is not None and image.ispe != (rgb.shape[1], rgb.shape[0]):
        rgb = _as_pil_sized(rgb, None if alpha is None else alpha_bytes(alpha, depth, ss, matrix, primaries),
                            image.ispe)
    return rgb


def _as_pil_sized(rgb: np.ndarray, alpha, size) -> np.ndarray:
    """PIL sizes the image by the grid's ispe and reads libavif's RGB(A)
    buffer, of the grid's output size, at that size: rows of another width
    run on into the next; a buffer too short for it is cut data."""
    width, height = size
    px = rgb if alpha is None else np.concatenate([rgb, alpha[..., None]], -1)
    flat = px.reshape(-1)
    n = width * height * px.shape[-1]
    if n > flat.size:
        raise DecodeError("image file is truncated")
    return flat[:n].reshape(height, width, px.shape[-1])[..., :3]
