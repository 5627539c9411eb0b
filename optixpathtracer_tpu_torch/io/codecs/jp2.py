"""JPEG 2000 files as PIL 12 reads them through OpenJPEG 2.5: a raw
codestream (FF 4F FF 51: .j2k, .j2c, .jpc) or a JP2 / JPX file (the jP
signature box: .jp2, .jpf, .jpx), decoded by j2k.py and then handed on as
PIL's Jpeg2KDecode.c hands OpenJPEG's tiles to its image.

PIL's side (Jpeg2KImagePlugin): the mode of a raw codestream is L (I;16
above 8 bits), LA, RGB or RGBA by its component count, the size
Xsiz - XOsiz by Ysiz - YOsiz; in a JP2 file the ihdr box gives both, colr
enumcs 12 on four components makes CMYK, and a pclr box of at most 8-bit
entries on L / LA makes P / PA, its colours kept once each in the order
they first come (ImagePalette.getcolor). OpenJPEG reads the boxes as it
does (the signature, ftyp second, jp2h with ihdr, the first colr of method
1 for the colour space, pclr / cmap / cdef checked and otherwise left
alone on PIL's tile-by-tile path), and a colour space it does not name
(no colr, an ICC profile, an enumcs other than 12, 16, 17, 18, 24) is
refused, as are more than four components.

Jpeg2KDecode.c then picks an unpacker by (mode, colour space, components):
each sample is offset (half the range of a signed component, half the step
of the shift when narrowing), shifted to 8 bits (16 for I;16) and kept to
its low bits, read from OpenJPEG's tile buffer at the component's
subsampled place; sYCC is turned to RGB by PIL's fixed-point YCbCr table.
convert("RGB") follows: grey and I;16 (clamped) spread, P through the
palette, CMYK through PIL's cmyk2rgb, alpha dropped."""
from __future__ import annotations

import numpy as np

from . import j2k
from ._common import DecodeError, NotThisFormat, cmyk_rgb, grey_rgb, pil_palette

SIG_J2K = b"\xff\x4f\xff\x51"
SIG_JP2 = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
GRAY, SRGB, SYCC, EYCC, CMYK = "gray", "srgb", "sycc", "eycc", "cmyk"
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}
UNSPECIFIED = "unspecified"
_MAX_PIXELS = 89478485  # PIL's Image.MAX_IMAGE_PIXELS
# (mode, colour space, components) -> PIL's unpacker, and whether it takes
# subsampled components
_UNPACKERS = {
    ("L", GRAY, 1): ("gray_l", False), ("P", SRGB, 1): ("gray_l", False), ("PA", SRGB, 2): ("graya_la", False),
    ("I;16", GRAY, 1): ("gray_i", False), ("LA", GRAY, 2): ("graya_la", False),
    ("RGB", GRAY, 1): ("gray_rgb", False), ("RGB", GRAY, 2): ("gray_rgb", False),
    ("RGB", SRGB, 3): ("rgb", True), ("RGB", SYCC, 3): ("ycc", True), ("RGB", SRGB, 4): ("rgb", True),
    ("RGB", SYCC, 4): ("ycc", True), ("RGBA", GRAY, 1): ("gray_rgb", False), ("RGBA", GRAY, 2): ("graya_la", False),
    ("RGBA", SRGB, 3): ("rgb", True), ("RGBA", SYCC, 3): ("ycc", True), ("RGBA", GRAY, 4): ("rgb", True),
    ("RGBA", SRGB, 4): ("rgb", True),
    ("RGBA", SYCC, 4): ("ycc", True), ("CMYK", CMYK, 4): ("rgb", True)}


def _u(b: bytes, at: int, n: int) -> int:
    return int.from_bytes(b[at:at + n], "big")


def _pil_codestream(data: bytes) -> tuple[tuple[int, int], str]:
    """PIL's _parse_codestream: the size and mode from SIZ."""
    siz = data[4:]
    if len(siz) < 38:
        raise NotThisFormat("short SIZ")
    xsiz, ysiz, xosiz, yosiz = (_u(siz, 4 + 4 * i, 4) for i in range(4))
    csiz = _u(siz, 36, 2)
    if csiz == 1:
        if len(siz) < 39:
            raise NotThisFormat("short SIZ")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise NotThisFormat("unable to determine J2K image mode")
    return (xsiz - xosiz, ysiz - yosiz), mode


def _boxes(data: bytes, pos: int, end: int | None, strict: bool):
    """(type, body start, body end) of each box from pos; PIL's BoxReader
    (strict=False: a bad header is PIL's SyntaxError) or OpenJPEG's."""
    while pos < (len(data) if end is None else end):
        if pos + 8 > len(data):
            if strict:
                raise j2k.broken()
            raise NotThisFormat("short box header")
        lbox, tbox = _u(data, pos, 4), data[pos + 4:pos + 8]
        hlen = 8
        if lbox == 1:
            if pos + 16 > len(data):
                raise j2k.broken() if strict else NotThisFormat("short box header")
            lbox, hlen = _u(data, pos + 8, 8), 16
        elif lbox == 0 and strict:
            lbox = len(data) - pos
        if lbox < hlen or (end is not None and pos + lbox > end):
            raise j2k.broken() if strict else NotThisFormat("Invalid header length")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


def _pil_jp2(data: bytes):
    """PIL's _parse_jp2_header -> (size, mode, palette colours or None)."""
    header = None
    for tbox, s, e in _boxes(data, 12, None, False):
        if tbox == b"jp2h":
            if e > len(data):
                raise NotThisFormat("Not enough data in header")
            header = (s, e)
            break
    if header is None:
        raise NotThisFormat("no jp2h box")
    size = mode = None
    nc = None
    palette = None
    for tbox, s, e in _boxes(data, header[0], header[1], False):
        body = data[s:e]
        if tbox == b"ihdr":
            if len(body) < 11:
                raise NotThisFormat("Not enough data in header")
            height, width, nc, bpc = _u(body, 0, 4), _u(body, 4, 4), _u(body, 8, 2), body[10]
            size = (width, height)
            mode = "I;16" if nc == 1 and (bpc & 0x7F) > 8 else {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            if len(body) < 7:
                raise NotThisFormat("Not enough data in header")
            if body[0] == 1 and _u(body, 3, 4) == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = _u(body, 0, 2), body[2] if len(body) > 2 else 0
            depths = body[3:3 + npc]
            if len(body) < 3 or len(depths) < npc:
                raise NotThisFormat("Not enough data in header")
            if max(depths, default=0) <= 8:
                if npc not in (3, 4):
                    raise DecodeError("JPEG 2000 palette of neither 3 nor 4 columns: PIL cannot hold it")
                entries = body[3 + npc:3 + npc + ne * npc]
                if len(entries) < ne * npc:
                    raise NotThisFormat("Not enough data in header")
                colours = {}
                for i in range(ne):
                    colours.setdefault(entries[i * npc:i * npc + npc], len(colours))
                if len(colours) > 256:
                    raise DecodeError("cannot allocate more than 256 colors")
                palette = np.frombuffer(b"".join(colours), np.uint8).reshape(-1, npc)[:, :3]
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise NotThisFormat("Malformed JP2 header")
    return size, mode, palette


def _opj_jp2(data: bytes) -> tuple[int, str | None]:
    """OpenJPEG's JP2 header reading -> (the codestream's offset, the colour
    space the first colr box names)."""
    state = 0  # 1 signature, 2 ftyp, 3 jp2h
    space = UNSPECIFIED
    for tbox, s, e in _boxes(data, 0, None, True):
        body = data[s:e]
        if tbox == b"jP  ":
            if state != 0 or body != b"\x0d\x0a\x87\x0a":
                raise j2k.broken()
            state = 1
        elif state == 0:
            raise j2k.broken()
        elif tbox == b"ftyp":
            if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                raise j2k.broken()
            state = 2
        elif state == 1:
            raise j2k.broken()
        elif tbox == b"jp2h":
            space = _opj_jp2h(body)
            state = 3
        elif tbox == b"jp2c":
            if state != 3:
                raise j2k.broken()
            return s, space
        elif tbox in (b"ihdr", b"colr", b"pclr", b"cmap", b"cdef", b"bpcc"):
            raise j2k.broken()  # a jp2h box outside jp2h
    raise j2k.broken()


def _opj_jp2h(h: bytes):
    have_ihdr = False
    have_colr = have_pclr = have_cmap = have_cdef = False
    space = UNSPECIFIED
    for tbox, s, e in _boxes(h, 0, len(h), True):
        b = h[s:e]
        if tbox == b"ihdr":
            if len(b) != 14:
                raise j2k.broken()
            if not have_ihdr:
                hh, ww, nc = _u(b, 0, 4), _u(b, 4, 4), _u(b, 8, 2)
                if not hh or not ww or not nc or nc > 16384:
                    raise j2k.broken()
            have_ihdr = True
        elif tbox == b"colr":
            if have_colr:
                continue
            if len(b) < 3:
                raise j2k.broken()
            if b[0] == 1:
                if len(b) < 7:
                    raise j2k.broken()
                space = _ENUMCS.get(_u(b, 3, 4), UNSPECIFIED)
                have_colr = True
            elif b[0] == 2:
                have_colr = True
        elif tbox == b"pclr":
            if have_pclr or len(b) < 3:
                raise j2k.broken()
            ne, npc = _u(b, 0, 2), b[2]
            if not ne or ne > 1024 or not npc or len(b) < 3 + npc:
                raise j2k.broken()
            need = 3 + npc + ne * sum(((d & 0x7F) + 1 + 7) >> 3 for d in b[3:3 + npc])
            if len(b) < need:
                raise j2k.broken()
            have_pclr = True
        elif tbox == b"cmap":
            if not have_pclr or have_cmap or len(b) % 4:
                raise j2k.broken()
            have_cmap = True
        elif tbox == b"cdef":
            if have_cdef or len(b) < 2 or not _u(b, 0, 2) or len(b) < 2 + 6 * _u(b, 0, 2):
                raise j2k.broken()
            have_cdef = True
    if not have_ihdr:
        raise j2k.broken()
    return space


def _read(buf: np.ndarray, offs: np.ndarray, csiz: int) -> np.ndarray:
    """Little-endian csiz-byte words of `buf` at byte offsets `offs`."""
    v = np.zeros(offs.shape, np.int64)
    for k in range(csiz):
        v |= buf[offs + k].astype(np.int64) << (8 * k)
    return v


def _shifted(word: np.ndarray, prec: int, sgnd: bool, bits: int) -> np.ndarray:
    """PIL's j2ku_shift(offset + word, bits - prec), in unsigned 32 bits,
    kept to `bits` bits."""
    shift = bits - prec
    offset = (1 << (prec - 1) if sgnd else 0) + (1 << (-shift - 1) if shift < 0 else 0)
    x = (word + offset) & 0xFFFFFFFF
    x = x >> -shift if shift < 0 else (x << shift) & 0xFFFFFFFF
    return x & ((1 << bits) - 1)


def _csiz(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _tile_buffer(comps, cs: j2k.Codestream, w: int, h: int) -> np.ndarray:
    """OpenJPEG's tile buffer (each component's samples in turn, csiz bytes
    each), zero past its end up to the size PIL clears."""
    parts = []
    for c, comp in zip(comps, cs.comps):
        n = _csiz(comp.prec)
        parts.append((c.astype(np.int64) & ((1 << (8 * n)) - 1)).astype(f"<u{n}").view(np.uint8).ravel())
    raw = np.concatenate(parts)
    size = max(len(raw), w * h * sum(_csiz(c.prec) for c in cs.comps))
    return np.concatenate([raw, np.zeros(size - len(raw), np.uint8)])


def _unpack(kind: str, buf: np.ndarray, cs: j2k.Codestream, w: int, h: int, bits: int) -> np.ndarray:
    """(h, w, k) samples as PIL's unpacker leaves them in the image."""
    comps = cs.comps
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        c = comps[0]
        v = _shifted(_read(buf, _csiz(c.prec) * (yy * w + xx), _csiz(c.prec)), c.prec, c.sgnd, bits)
        return v[..., None]
    if kind == "graya_la":
        c, a = comps[0], comps[1]
        n0, n1 = _csiz(c.prec), _csiz(a.prec)
        g = _shifted(_read(buf, n0 * (yy * w + xx), n0), c.prec, c.sgnd, 8)
        al = _shifted(_read(buf, n0 * w * h + n1 * (yy * w + xx), n1), a.prec, a.sgnd, 8)
        return np.stack([g, al], -1)
    out = []
    base = 0
    for c in comps:
        n = _csiz(c.prec)
        wd = w // c.dx
        offs = base + n * ((yy // c.dy) * wd + xx // c.dx)
        out.append(_shifted(_read(buf, offs, n), c.prec, c.sgnd, 8))
        base += n * wd * (h // c.dy)
    return np.stack(out, -1)


def rgb8(data: bytes) -> np.ndarray:
    """A JPEG 2000 codestream or JP2 / JPX file -> (H, W, 3) uint8, what
    PIL's `Image.open(...).convert("RGB")` gives."""
    if data.startswith(SIG_J2K):
        (width, height), mode = _pil_codestream(data)
        palette = None
        start, space = 0, UNSPECIFIED
    elif data.startswith(SIG_JP2):
        (width, height), mode, palette = _pil_jp2(data)
        start, space = _opj_jp2(data)
    else:
        raise NotThisFormat("not a JPEG 2000 file")
    if width <= 0 or height <= 0:
        raise NotThisFormat("not identified by this driver")
    if width * height > 2 * _MAX_PIXELS:  # PIL's DecompressionBombError, before any decode
        raise DecodeError(f"Image size ({width * height} pixels) exceeds limit of {2 * _MAX_PIXELS} pixels, "
                          "could be decompression bomb DOS attack.")
    cs = j2k.Codestream(data, start)
    if data.startswith(SIG_JP2):
        if (width, height) != (cs.xsiz - cs.xosiz, cs.ysiz - cs.yosiz):
            raise j2k.broken()  # an ihdr whose size is not the codestream's
    n = len(cs.comps)
    if n < 1 or n > 4:
        raise j2k.broken()
    first_sub = next((i for i, c in enumerate(cs.comps) if c.dx != 1 or c.dy != 1), -1)
    if space == UNSPECIFIED:  # PIL's guess: sYCC where the second or third component is the first subsampled
        space = GRAY if n <= 2 else SYCC if first_sub in (1, 2) else SRGB
    unpacker = _UNPACKERS.get((mode, space, n))
    if unpacker is None or (first_sub >= 0 and not unpacker[1]):
        raise j2k.broken()
    kind = unpacker[0]
    bits = 16 if kind == "gray_i" else 8
    img = np.zeros((height, width, 4), np.uint16)
    x0, y0 = cs.xosiz, cs.yosiz
    for (tx0, ty0, tx1, ty1), comps in j2k.decode_tiles(cs):
        if tx0 >= tx1 or ty0 >= ty1 or tx0 < x0 or ty0 < y0 or tx1 - x0 > width or ty1 - y0 > height:
            raise j2k.broken()
        w, h = tx1 - tx0, ty1 - ty0
        px = _unpack(kind, _tile_buffer(comps, cs, w, h), cs, w, h, bits)
        img[ty0 - y0:ty1 - y0, tx0 - x0:tx1 - x0, :px.shape[-1]] = px
    return _to_rgb(img, mode, kind, palette)


def _to_rgb(img: np.ndarray, mode: str, kind: str, palette) -> np.ndarray:
    if kind == "ycc":
        from .im import ycbcr_rgb

        img = img.copy()
        img[..., :3] = ycbcr_rgb(img[..., :3].astype(np.uint8))
    if mode in ("L", "LA", "RGB", "RGBA") and kind in ("gray_l", "graya_la", "gray_rgb"):
        return grey_rgb(img[..., 0])
    if mode == "I;16":
        return grey_rgb(np.minimum(img[..., 0], 255))
    if mode in ("P", "PA"):
        return pil_palette(palette)[img[..., 0]]
    if mode == "CMYK":
        return cmyk_rgb(img[..., :4].astype(np.uint8))
    return img[..., :3].astype(np.uint8)
