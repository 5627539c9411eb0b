"""The port's image codecs: every format is told by its bytes, in the order
PIL's `Image.open` tries its plugins, and decoded to what PIL's
`convert("RGB")` gives, bit for bit.

`rgb8(data)` walks `FORMATS` in PIL's order (the plugins PIL loads first,
BMP, DIB, GIF, JPEG, PPM, PNG, then the rest in the order it registers
them). A format whose `accept` takes the first bytes gets the data; a
decoder that finds its header is not its format raises `NotThisFormat` and
the walk goes on, as PIL goes on after a plugin's SyntaxError (TGA has no
magic number and is told this way). Every format PIL reads has a
decoder; the variants a decoder does not port yet (AVIF step 4: film
grain, quantizer matrices, grids, ...; the corners in ROADMAP A.1) raise
NotImplementedError naming the variant and ROADMAP A.1; bytes that no
format takes raise
`UnidentifiedImageError`, an OSError as PIL's own is. The formats PIL
opens but cannot decode here (EPS without Ghostscript, WMF off Windows,
the BUFR / GRIB / HDF5 stubs, MPEG) raise `DecodeError` with PIL's
reason. Every decoder is host code over `bytes` and numpy: no image
library."""
from __future__ import annotations

import importlib
import re
import struct
import zlib

import numpy as np

from ._common import DecodeError, NotThisFormat, UnidentifiedImageError

__all__ = ["DecodeError", "UnidentifiedImageError", "FORMATS", "rgb8"]


def _codec(module: str, func: str = "rgb8"):
    """The decoder `func` of codecs/`module`, imported at its first call."""
    def call(data: bytes) -> np.ndarray:
        return getattr(importlib.import_module(f".{module}", __package__), func)(data)
    return call


def _image(func: str):
    """A decoder of io/image.py (PNG, JPEG), imported at its first call."""
    def call(data: bytes) -> np.ndarray:
        return getattr(importlib.import_module("..image", __package__), func)(data)
    return call


def _fails(reason: str):
    """A format PIL opens and cannot decode: its decode raises PIL's reason."""
    def call(data: bytes) -> np.ndarray:
        raise DecodeError(reason)
    return call


def _starts(*magics: bytes):
    return lambda p: p.startswith(magics)


def _u32le(p: bytes) -> int:
    return int.from_bytes(p[:4], "little") if len(p) >= 4 else -1


def _u32be(p: bytes, at: int = 0) -> int:
    return int.from_bytes(p[at:at + 4], "big") if len(p) >= at + 4 else -1


def _u16le(p: bytes, at: int) -> int:
    return int.from_bytes(p[at:at + 2], "little") if len(p) >= at + 2 else -1


def _avif(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _im(data: bytes) -> bool:
    """ImImagePlugin: a text header of "key: value" lines naming its size."""
    return b"\n" in data[:100] and re.match(rb"[A-Za-z][^:\n]*:", data) is not None \
        and b"Image size" in data[:1024]


def _imt(data: bytes) -> bool:
    head = data[:1024]
    return b"\n" in data[:100] and b"width" in head and b"height" in head and b"\x0c" in head


def _spider(data: bytes) -> bool:
    """SpiderImagePlugin.isSpiderHeader on either byte order, a 2-D image."""
    if len(data) < 108:
        return False
    for order in (">", "<"):
        h = (99.0,) + struct.unpack(order + "27f", data[:108])
        if not all(np.isfinite(h[i]) and float(h[i]).is_integer() for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        if int(h[5]) in (1, 3, -11, -12, -21, -22) and int(h[22]) == int(h[13]) * int(h[23]) != 0:
            return int(h[5]) == 1
    return False


def _gbr(p: bytes) -> bool:
    """GbrImagePlugin's header checks: a GIMP brush of size > 0, depth 1 or 4."""
    if len(p) < 20:
        return False
    size, version, w, h, depth = (_u32be(p, 4 * i) for i in range(5))
    return size >= 20 and version in (1, 2) and w and h and depth in (1, 4) and (
        version == 1 or p[20:24] == b"GIMP")


def _fli(p: bytes) -> bool:
    """FliImagePlugin's header checks: the magic and the zero fields."""
    return (len(p) >= 128 and _u16le(p, 4) in (0xAF11, 0xAF12) and _u16le(p, 14) in (0, 3)
            and p[20:22] == bytes(2) and p[42:80] == bytes(38) and p[88:128] == bytes(40))


def _tiff_accept(p: bytes) -> bool:
    return p.startswith((b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                         b"II\x2b\x00"))


def _webp_accept(p: bytes) -> bool:
    return p.startswith(b"RIFF") and p[8:12] == b"WEBP" and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")


# (PIL's format name, accept(data), decoder), in the order PIL's
# Image.open tries them. An accept may hold the header checks its plugin
# makes before it takes the file, so that the search goes on where PIL's
# does.
FORMATS = [
    ("BMP", _starts(b"BM"), _codec("bmp")),
    ("DIB", lambda p: _u32le(p) in (12, 40, 52, 56, 64, 108, 124), _codec("bmp", "dib_rgb8")),
    ("GIF", _starts(b"GIF87a", b"GIF89a"), _codec("gif")),
    ("JPEG", _starts(b"\xff\xd8\xff"), _image("rgb8_from_jpeg")),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy", _codec("pnm")),
    ("PNG", _starts(b"\x89PNG\r\n\x1a\n"), _image("rgb8_from_png")),
    ("AVIF", _avif, _codec("avif")),
    ("BLP", _starts(b"BLP1", b"BLP2"), _codec("blp")),
    ("BUFR", _starts(b"BUFR", b"ZCZC"), _fails("cannot find loader for this BUFR file")),
    ("CUR", _starts(b"\0\0\2\0"), _codec("ico", "cur_rgb8")),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), _codec("pcx")),
    ("DCX", lambda p: _u32le(p) == 0x3ADE68B1, _codec("pcx", "dcx_rgb8")),
    ("DDS", _starts(b"DDS "), _codec("dds")),
    ("EPS", lambda p: p.startswith(b"%!PS") or _u32le(p) == 0xC6D3D0C5,
     _fails("Unable to locate Ghostscript on paths")),
    ("FITS", _starts(b"SIMPLE"), _codec("fits")),
    ("FLI", _fli, _codec("fli")),
    ("FTEX", _starts(b"FTEX"), _codec("ftex")),
    ("GBR", _gbr, _codec("gbr")),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _fails("cannot find loader for this GRIB file")),
    ("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), _fails("cannot find loader for this HDF5 file")),
    ("JPEG2000", _starts(b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"), _codec("jp2")),
    ("ICNS", _starts(b"icns"), _codec("icns")),
    ("ICO", _starts(b"\0\0\1\0"), _codec("ico")),
    ("IM", _im, _codec("im")),
    ("IMT", _imt, _codec("imt")),
    ("IPTC", lambda p: len(p) >= 2 and p[0] == 0x1C and p[1] in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240), _codec("iptc")),
    ("MCIDAS", _starts(b"\x00\x00\x00\x00\x00\x00\x00\x04"), _codec("mcidas")),
    ("MPEG", _starts(b"\x00\x00\x01\xb3"), _fails("cannot load this image")),
    ("TIFF", _tiff_accept, _codec("tiff")),
    ("MSP", _starts(b"DanM", b"LinS"), _codec("msp")),
    ("PCD", lambda p: p[2048:2052] == b"PCD_", _codec("pcd")),
    ("PIXAR", _starts(b"\200\350\000\000"), _codec("pixar")),
    ("PSD", _starts(b"8BPS"), _codec("psd")),
    ("QOI", _starts(b"qoif"), _codec("qoi")),
    ("SGI", lambda p: len(p) >= 2 and p[0] == 1 and p[1] == 0xDA, _codec("sgi")),
    ("SPIDER", _spider, _codec("spider")),
    ("SUN", lambda p: _u32be(p) == 0x59A66A95, _codec("sun")),
    ("TGA", lambda p: True, _codec("tga")),
    ("WEBP", _webp_accept, _codec("webp")),
    ("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), _fails("cannot find loader for this WMF file")),
    ("XBM", lambda p: p[:16].lstrip().startswith(b"#define"), _codec("xbm")),
    ("XPM", _starts(b"/* XPM */"), _codec("xpm")),
    ("XVTHUMB", _starts(b"P7 332"), _codec("xvthumb")),
]


def rgb8(data: bytes) -> np.ndarray:
    """Encoded image bytes of any format the port reads -> (H, W, 3) uint8,
    what PIL's `Image.open(...).convert("RGB")` gives."""
    data = bytes(data)
    for name, accept, decode in FORMATS:
        if not accept(data):
            continue
        try:
            return decode(data)
        except NotThisFormat:
            continue
        except (IndexError, struct.error, zlib.error) as e:  # data that ends or breaks inside a field
            raise DecodeError(f"corrupt {name} image: {e!r}") from e
    raise UnidentifiedImageError("cannot identify image file")
