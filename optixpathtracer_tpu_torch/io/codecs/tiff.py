"""TIFF, the first page, as PIL's TiffImagePlugin (and libtiff beneath it,
for every compression but none) reads it.

Classic and BigTIFF, II and MM byte order; strips and tiles; planar
configuration 1 and 2; compression 1 (none), 5 (LZW), 8 / 32946
(Deflate), 32773 (PackBits) and 7 (JPEG: each strip or tile a JPEG stream
after the JPEGTables, decoded by io/image.py's decoder); predictor 2
(horizontal differencing, 8/16/32 bits; like PIL, ignored on uncompressed
data); FillOrder 2 (each byte's bits reversed before decoding).
Photometric 0 and 1 (1, 2, 4, 8 bits, inverted where white is zero; 16 and
32-bit integers and 32-bit floats clamped into 0-255 as PIL converts its
modes I;16, I and F), 2 (8 or 16 bits, extra samples dropped, associated
alpha divided out as PIL's RGBa unpacker does), 3 (palettes of 1-8 bits,
the colour map's high bytes), 5 (CMYK, 8 or 16 bits) and 6 under JPEG
(YCbCr converted to RGB by libjpeg). The pixel layouts are PIL's OPEN_INFO
table; what it lacks is no format PIL reads, and decodes nowhere."""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import lzw
from ._common import DecodeError, NotThisFormat, cmyk_rgb, grey_rgb, packbits, unpack_bits, unported

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "s", 8: "h", 9: "i", 10: "ii", 11: "f",
          12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_SIZES = {"B": 1, "s": 1, "H": 2, "I": 4, "II": 8, "b": 1, "h": 2, "i": 4, "ii": 8, "f": 4, "d": 8, "Q": 8,
          "q": 8}
_OPEN_INFO: dict = {}  # (order, photometric, sample format, fill order, bits, extra samples) -> raw mode


def _register(orders, photo, fmt, fills, bps, extra, raw):
    for order in orders:
        for fill, r in zip(fills, raw if isinstance(raw, tuple) else (raw,)):
            _OPEN_INFO[(order, photo, fmt, fill, bps, extra)] = r


# PIL's OPEN_INFO table, the raw modes it unpacks each layout with
for _p, _inv in ((0, "I"), (1, "")):
    _register("<>", _p, (1,), (1, 2), (1,), (), (f"1;{_inv}" if _inv else "1", f"1;{_inv}R"))
    for _b in (2, 4):
        _register("<>", _p, (1,), (1, 2), (_b,), (), (f"L;{_b}{_inv}", f"L;{_b}{_inv}R"))
_register("<>", 0, (1,), (1, 2), (8,), (), ("L;I", "L;IR"))
_register("<>", 1, (1,), (1, 2), (8,), (), ("L", "L;R"))
_register("<>", 1, (2,), (1,), (8,), (), "L")
_register("<", 1, (1,), (1,), (12,), (), "I;12")
_register("<", 0, (1,), (1,), (16,), (), "I;16")
_register("<", 1, (1,), (1, 2), (16,), (), ("I;16", "I;16R"))
_register(">", 1, (1,), (1,), (16,), (), "I;16B")
_register("<>", 1, (2,), (1,), (16,), (), "I;16S")
_register("<>", 0, (3,), (1,), (32,), (), "F")
_register("<", 1, (1,), (1,), (32,), (), "I;32N")
_register("<>", 1, (2,), (1,), (32,), (), "I;32S")
_register("<>", 1, (3,), (1,), (32,), (), "F")
_register("<>", 1, (1,), (1,), (8, 8), (2,), "LA")
_register("<>", 2, (1,), (1, 2), (8, 8, 8), (), ("RGB", "RGB;R"))
for _ex, _raw in (((), "RGBA"), ((0,), "RGBX"), ((0, 0), "RGBXX"), ((0, 0, 0), "RGBXXX"), ((1,), "RGBa"),
                  ((1, 0), "RGBaX"), ((1, 0, 0), "RGBaXX"), ((2,), "RGBA"), ((2, 0), "RGBAX"),
                  ((2, 0, 0), "RGBAXX"), ((999,), "RGBA")):
    _register("<>", 2, (1,), (1,), (8,) * max(4, 3 + len(_ex)), _ex, _raw)
for _n, _ex, _raw in ((3, (), "RGB;16"), (4, (), "RGBA;16"), (4, (0,), "RGBX;16"), (4, (1,), "RGBa;16"),
                      (4, (2,), "RGBA;16")):
    _register("<>", 2, (1,), (1,), (16,) * _n, _ex, _raw)
for _b in (1, 2, 4, 8):
    _register("<>", 3, (1,), (1, 2), (_b,), (), (f"P;{_b}" if _b < 8 else "P", f"P;{_b}R" if _b < 8 else "P;R"))
_register("<>", 3, (1,), (1,), (8, 8), (0,), "PX")
_register("<>", 3, (1,), (1,), (8, 8), (2,), "PA")
for _ex, _raw in (((), "CMYK"), ((0,), "CMYKX"), ((0, 0), "CMYKXX")):
    _register("<>", 5, (1,), (1,), (8,) * (4 + len(_ex)), _ex, _raw)
_register("<>", 5, (1,), (1,), (16,) * 4, (), "CMYK;16")
_register("<>", 6, (1,), (1,), (8,), (), "L")
_register("<>", 6, (1,), (1,), (8, 8, 8), (), "RGBX")
_register("<>", 8, (1,), (1,), (8, 8, 8), (), "LAB")

_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _ifd(data: bytes) -> tuple[str, dict]:
    """The first IFD: (byte order, {tag: tuple of values})."""
    order = "<" if data[:2] == b"II" else ">"
    version = struct.unpack(order + "H", data[2:4])[0]
    big = version == 43
    if big and order == ">":
        raise NotThisFormat("big-endian BigTIFF, which PIL does not read")
    if big:
        pos = struct.unpack(order + "Q", data[8:16])[0]
        count = struct.unpack(order + "Q", data[pos:pos + 8])[0]
        pos += 8
        entry, inline = 20, 8
    else:
        pos = struct.unpack(order + "I", data[4:8])[0]
        if pos + 2 > len(data):
            raise DecodeError("TIFF IFD past the end of the data")
        count = struct.unpack(order + "H", data[pos:pos + 2])[0]
        pos += 2
        entry, inline = 12, 4
    tags = {}
    for i in range(count):
        e = data[pos + i * entry:pos + (i + 1) * entry]
        if len(e) < entry:
            raise DecodeError("truncated TIFF IFD")
        if big:
            tag, typ, n = struct.unpack(order + "HHQ", e[:12])
        else:
            tag, typ, n = struct.unpack(order + "HHI", e[:8])
        if typ not in _TYPES:
            continue
        code = _TYPES[typ]
        size = _SIZES[code] * n
        if size <= inline:
            raw = e[entry - inline:entry - inline + size]
        else:
            off = struct.unpack(order + ("Q" if big else "I"), e[entry - inline:])[0]
            raw = data[off:off + size]
            if len(raw) < size:
                continue  # PIL drops a tag whose data is past the end
        if code == "s":
            tags[tag] = (raw,)
        elif code in ("II", "ii"):
            v = struct.unpack(order + code[0] * (2 * n), raw)
            tags[tag] = tuple(a / b if b else float("nan") for a, b in zip(v[::2], v[1::2]))
        else:
            tags[tag] = struct.unpack(order + code * n, raw)
    return order, tags


def _undo_predictor(buf: np.ndarray, rows: int, row_bytes: int, spp: int, bps: int, order: str) -> np.ndarray:
    """Horizontal differencing (predictor 2) undone along each row, per
    sample, in the sample's own width."""
    if bps not in (8, 16, 32):
        raise DecodeError(f"TIFF predictor 2 on {bps}-bit samples")
    dt = np.dtype({8: "u1", 16: "u2", 32: "u4"}[bps]).newbyteorder(order)
    n = row_bytes // (bps // 8)
    v = buf[:rows * row_bytes].view(dt).reshape(rows, n // spp, spp)
    out = np.cumsum(v, axis=1, dtype=dt.newbyteorder("="))
    return out.astype(dt).reshape(-1).view(np.uint8)


def _jpeg(tables: bytes | None, chunk: bytes, ycc: bool) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF: the JPEGTables' segments,
    then the chunk's; YCbCr converted to RGB (photometric 6, libtiff's
    JPEGCOLORMODE_RGB, as PIL asks), any other photometric left as it is."""
    from ..image import decode_jpeg

    if tables and chunk.startswith(b"\xff\xd8") and tables.startswith(b"\xff\xd8"):
        chunk = tables[:-2] + chunk[2:]
    if not ycc:  # libtiff takes no subsampled components but YCbCr's
        pos = 2
        while pos + 4 <= len(chunk) and chunk[pos] == 0xFF:
            marker, length = chunk[pos + 1], int.from_bytes(chunk[pos + 2:pos + 4], "big")
            if marker in (0xC0, 0xC1, 0xC2):
                n = chunk[pos + 9] if pos + 9 < len(chunk) else 0
                if any(chunk[pos + 11 + 3 * c] != 0x11 for c in range(n) if pos + 11 + 3 * c < len(chunk)):
                    raise DecodeError("JPEG TIFF with subsampled components: libtiff fails it")
                break
            pos += 2 + length
    return decode_jpeg(chunk, "ycc" if ycc else "raw")


def rgb8(data: bytes) -> np.ndarray:
    try:
        order, tags = _ifd(data)
    except struct.error as e:
        raise NotThisFormat("TIFF IFD") from e

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    width, height = one(256), one(257)
    if width is None or height is None:
        raise DecodeError("TIFF without dimensions")
    compression = one(259, 1)
    photo = one(262, 0)
    planar = one(284, 1)
    fill = one(266, 1)
    predictor = one(317, 1)
    if one(274, 1) != 1:
        raise unported("TIFF with an orientation")
    if compression not in (1, 5, 7, 8, 32946, 32773):
        if compression in (2, 3, 4, 6, 32771, 34712, 34887, 34925, 50000, 50001):
            raise unported(f"TIFF compression {compression}")
        raise DecodeError(f"TIFF compression {compression}")
    extra = tuple(tags.get(338, ()))
    spp = one(277, 1)
    bps_t = tuple(tags.get(258, (1,)))
    if spp < len(bps_t):
        bps_t = bps_t[:spp]
    elif spp > len(bps_t) and len(bps_t) == 1:
        bps_t = bps_t * spp
    if len(bps_t) != spp:
        raise NotThisFormat("unknown data organization")
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    raw = _OPEN_INFO.get((order, photo, fmt, fill, bps_t, extra))
    if raw is None:
        raise NotThisFormat("unknown pixel mode")
    if fill == 2:  # the bits of each byte are reversed before decoding: the plain mode then
        raw = raw[:-1].rstrip(";")
    if raw in ("I;12", "LAB"):
        raise unported(f"TIFF of PIL's raw mode {raw}")
    if photo == 6 and not (compression == 7 and planar == 1):
        raise unported("YCbCr TIFF without JPEG compression")
    bps = bps_t[0]
    if fill == 2 and compression != 1 and 324 in tags:
        raise DecodeError("tiled, compressed TIFF with fill order 2: PIL's libtiff decoder fails it")
    if compression not in (5, 8, 32946):
        predictor = 1  # libtiff applies it to LZW and Deflate only; PIL's raw decoder never
    if predictor not in (1, 2):
        raise unported(f"TIFF predictor {predictor}")
    if planar == 2 and spp > 1:
        # PIL gives each plane one letter of the raw mode: X (and, on
        # uncompressed data, a) has no unpacker, and 16-bit uncompressed
        # planes are read as if their samples were bytes
        if compression == 1 and ("X" in raw or "a" in raw) or "X" in raw and 324 not in tags:
            raise DecodeError(f"TIFF planes of raw mode {raw}: PIL has no unpacker for them")
        if compression == 1 and bps == 16:
            if 324 in tags:
                raise unported("tiled 16-bit planar uncompressed TIFF")
            bps = 8

    # ---- the strips or tiles of each plane into full rows of bytes --------
    planes = spp if planar == 2 else 1
    per_plane = 1 if planar == 2 else spp
    row_bytes = (width * per_plane * bps + 7) // 8
    raws = [np.zeros((height, row_bytes), np.uint8) for _ in range(planes)]
    if 324 in tags:
        tw, th = one(322), one(323)
        offsets, counts = tags[324], tags.get(325, ())
        across, down = -(-width // tw), -(-height // th)
        chunk_rows, chunk_bytes = th, (tw * per_plane * bps + 7) // 8
    elif 273 in tags:
        rps = min(one(278, height), height) or height
        offsets, counts = tags[273], tags.get(279, ())
        across, down = 1, -(-height // rps)
        tw, th = width, rps
        chunk_rows, chunk_bytes = rps, row_bytes
    else:
        raise NotThisFormat("unknown data organization")
    tables = one(347)
    jpeg_px = np.zeros((height, width, 3), np.uint8) if compression == 7 else None
    for i, off in enumerate(offsets[:planes * across * down]):
        plane, k = divmod(i, across * down)
        ty, tx = divmod(k, across)
        y0, x0 = ty * th, tx * tw
        if y0 >= height:
            continue
        n = counts[i] if i < len(counts) else len(data) - off
        src = data[off:off + n]
        if fill == 2:
            src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
        rows = min(chunk_rows, height - y0) if 273 in tags else chunk_rows
        need_bytes = rows * chunk_bytes
        if compression == 7:
            tile = _jpeg(tables, src, photo == 6)
            h_, w_ = min(th, height - y0, tile.shape[0]), min(tw, width - x0, tile.shape[1])
            if tile.shape[-1] == 1:
                tile = np.repeat(tile, 3, -1)
            jpeg_px[y0:y0 + h_, x0:x0 + w_] = tile[:h_, :w_, :3]
            continue
        if compression == 1:
            buf = src
        elif compression == 32773:
            buf = packbits(src, 0, need_bytes)[0]
        elif compression == 5:
            if src[:2] == b"\x00\x01":
                raise unported("old-style (LSB-first) TIFF LZW")
            buf = lzw.tiff_decode(src, need_bytes)
        else:
            try:
                buf = zlib.decompressobj().decompress(src, need_bytes)
            except zlib.error as e:
                raise DecodeError(f"corrupt TIFF Deflate data: {e}") from e
        if len(buf) < need_bytes:
            if compression == 1:
                raise DecodeError("truncated TIFF image data")
            buf = buf + bytes(need_bytes - len(buf))  # libtiff leaves the rest of a short strip zero
        arr = np.frombuffer(buf, np.uint8, need_bytes).copy()
        if predictor == 2:
            arr = _undo_predictor(arr, rows, chunk_bytes, per_plane, bps, order)
        arr = arr.reshape(rows, chunk_bytes)
        r = min(rows, height - y0)
        xb = x0 * per_plane * bps // 8
        c = min(chunk_bytes, row_bytes - xb)
        raws[plane][y0:y0 + r, xb:xb + c] = arr[:r, :c]
    if compression == 7:
        if raw not in ("RGB", "RGBX", "L"):
            raise unported(f"JPEG TIFF of PIL's raw mode {raw}")
        return jpeg_px

    # ---- samples -> RGB, by PIL's raw mode ------------------------------------
    if bps < 8:  # one sample a pixel: "1", "L;2", "L;4", "P;1" ... with I: white is zero
        vals = unpack_bits(raws[0], width, bps).astype(np.int64)
        if raw.startswith("P"):
            return _palette(tags)[vals]
        grey = vals * (255 // ((1 << bps) - 1))
        return grey_rgb(255 - grey if photo == 0 else grey)
    kind = {1: "u", 2: "i", 3: "f"}[fmt[0]]
    if raw == "I;32N":
        kind = "i"  # PIL's mode I is signed
    elif bps == 8:
        kind = "u"  # signed bytes unpack as grey all the same
    swapped = compression != 1 and order == ">" and bps in (16, 32) and (kind == "f" or kind == "i")
    # libtiff hands PIL native (little-endian) samples, which PIL unpacks
    # with these modes' big-endian unpackers all the same
    dt = np.dtype(f"{kind}{bps // 8}").newbyteorder("<" if swapped else order)
    if planes == 1:
        s = raws[0].view(dt).reshape(height, width, spp)
    else:
        s = np.stack([p.view(dt).reshape(height, width) for p in raws], -1)
    if raw == "F":  # clipped into 0-255, truncated, NaN black: PIL's F -> L
        with np.errstate(invalid="ignore"):
            g = np.where(s[..., 0] <= 0, 0, np.where(s[..., 0] >= 255, 255, s[..., 0]))
        return grey_rgb(np.nan_to_num(g, nan=0).astype(np.int64).astype(np.uint8))
    if raw.startswith("I;") or raw in ("L", "L;I", "LA"):  # grey; 16 and 32 bits clamp, as modes I;16 / I
        g = s[..., 0].astype(np.int64)
        return grey_rgb(np.clip(255 - g if raw == "L;I" else g, 0, 255).astype(np.uint8))
    if bps == 16:
        s = s >> 8  # PIL keeps each 16-bit sample's high byte
    s = s.astype(np.int64)
    if raw.startswith("P"):
        return _palette(tags)[s[..., 0]]
    if raw.startswith("CMYK"):
        return cmyk_rgb(s[..., :4])
    rgb = s[..., :3]
    if raw.startswith("RGBa"):  # associated alpha: PIL's RGBa unpacker divides it out
        a = s[..., 3:4]
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, np.clip(rgb * 255 // np.maximum(a, 1), 0, 255)))
    return rgb.astype(np.uint8)


def _palette(tags: dict) -> np.ndarray:
    """The colour map (all red, then green, then blue, 16 bits each) as PIL
    takes it: each value // 256; entries past it black."""
    cmap = tags.get(320)
    if cmap is None:
        raise DecodeError("palette TIFF without a colour map")
    n = len(cmap) // 3
    pal = np.zeros((256, 3), np.uint8)
    cols = (np.array(cmap[:3 * n], np.int64).reshape(3, n).T // 256).astype(np.uint8)
    pal[:min(n, 256)] = cols[:256]
    return pal
