"""TIFF, the first page, as PIL's TiffImagePlugin (and libtiff beneath it,
for every compression but none) reads it.

Classic and BigTIFF, II and MM byte order; strips and tiles; planar
configuration 1 and 2; compression 1 (none), 5 (LZW, and the old LSB-first
codes), 8 / 32946 (Deflate), 32773 (PackBits), 34925 (LZMA), 50000 (ZSTD:
codecs/zstd.py), 2 / 32771 / 3 / 4 (CCITT: codecs/ccitt.py), 32809
(ThunderScan), 7 (JPEG: each strip or tile a JPEG stream after the
JPEGTables, decoded by io/image.py's decoder) and 6 (old-style JPEG,
through JPEGInterchangeFormat or built from the table tags); predictor 2
(horizontal differencing, 8/16/32 bits) and 3 (libtiff's floating-point
predictor), like PIL ignored on uncompressed data; FillOrder 2 (each
byte's bits reversed before decoding); Orientation 2-8 applied last, as
PIL's exif_transpose does. Photometric 0 and 1 (1, 2, 4, 8 and 12 bits,
inverted where white is zero; 16 and 32-bit integers and 32-bit floats
clamped into 0-255 as PIL converts its modes I;16, I and F), 2 (8 or 16
bits, extra samples dropped, associated alpha divided out as PIL's RGBa
unpacker does), 3 (palettes of 1-8 bits, the colour map's high bytes), 5
(CMYK, 8 or 16 bits), 6 (YCbCr: under JPEG converted by libjpeg, else by
libtiff's RGBA reader, TIFFYCbCrtoRGB, or read raw where PIL reads it
raw) and 8 (CIELAB, through LittleCMS's transform: codecs/lab.py). The
pixel layouts are PIL's OPEN_INFO table; what it lacks is no format PIL
reads, and decodes nowhere."""
from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from . import ccitt, lzw, zstd
from ._common import (DecodeError, NotThisFormat, cmyk_rgb, float_l, grey_rgb, packbits, raw_rows, unpack_bits,
                      unported)

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

# PIL's COMPRESSION_INFO: a code outside it is no TIFF PIL opens
_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677, 34925, 50000, 50001)
_CCITT = (2, 3, 4, 32771)
_PREDICTED = (5, 8, 32946, 34925, 50000)
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


def _inflate(src: bytes, compression: int, n: int) -> bytes:
    """A strip or tile of one of the byte codings -> about `n` bytes (fewer
    where the data ends early)."""
    if compression == 32773:
        return packbits(src, 0, n)[0]
    if compression == 5:
        if len(src) >= 2 and src[0] == 0 and src[1] & 1:  # libtiff's test for the old, LSB-first codes
            return lzw.tiff_old_decode(src, n)
        return lzw.tiff_decode(src, n)
    if compression == 34925:
        try:
            return lzma.LZMADecompressor().decompress(src, n)
        except lzma.LZMAError as e:
            raise DecodeError(f"corrupt TIFF LZMA data: {e}") from e
    if compression == 50000:
        return zstd.decompress(src, n)
    try:
        return zlib.decompressobj().decompress(src, n)
    except zlib.error as e:
        raise DecodeError(f"corrupt TIFF Deflate data: {e}") from e


def _undo_float_predictor(buf: np.ndarray, rows: int, row_bytes: int, spp: int, bps: int) -> np.ndarray:
    """libtiff's floating-point predictor (3) undone: each row's bytes
    summed `spp` apart, then its byte planes (most significant first)
    put back into native (little-endian) samples."""
    b = buf[:rows * row_bytes].reshape(rows, row_bytes)
    acc = np.empty_like(b)
    for k in range(spp):  # the running sum of each sample's interleaved bytes
        acc[:, k::spp] = np.cumsum(b[:, k::spp], axis=1, dtype=np.uint8)
    nb = bps // 8
    wc = row_bytes // nb
    planes = acc[:, :wc * nb].reshape(rows, nb, wc)
    return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).reshape(-1)


def _planar_tiles16(data: bytes, offsets, width: int, height: int, tw: int, th: int, planes: int):
    """Tiled, uncompressed, planar 16-bit samples as PIL's raw decoder reads
    them: each plane's letter of the raw mode unpacks one byte a pixel; a
    tile inside the image steps `tw` bytes a row (half a row of its
    samples), one at the right edge 2 * `tw`."""
    across, down = -(-width // tw), -(-height // th)
    raws = [np.zeros((height, width), np.uint8) for _ in range(planes)]
    for i, off in enumerate(offsets[:planes * across * down]):
        plane, k = divmod(i, across * down)
        ty, tx = divmod(k, across)
        y0, x0 = ty * th, tx * tw
        rw, rh = min(tw, width - x0), min(th, height - y0)
        stride = 2 * tw if x0 + tw > width else rw
        raws[plane][y0:y0 + rh, x0:x0 + rw] = raw_rows(data, off, rh, rw, stride, "TIFF")
    return raws


def _thunderscan(src: bytes, width: int, rows: int) -> bytes:
    """ThunderScan 4-bit (libtiff's ThunderDecode): runs of the last pixel,
    2- and 3-bit deltas from it, raw pixels; each row starts from 0 and
    must come out exactly `width` pixels long."""
    two, three = (0, 1, None, -1), (0, 1, 2, 3, None, -3, -2, -1)
    pos, out = 0, []
    for _ in range(rows):
        last, px = 0, []
        while pos < len(src) and len(px) < width:
            n = src[pos]
            pos += 1
            code = n & 0xC0
            if code == 0x00:
                px += [last] * (n & 0x3F)
            elif code == 0x40:
                for d in (two[(n >> 4) & 3], two[(n >> 2) & 3], two[n & 3]):
                    if d is not None:
                        last = (last + d) & 0xF
                        px.append(last)
            elif code == 0x80:
                for d in (three[(n >> 3) & 7], three[n & 7]):
                    if d is not None:
                        last = (last + d) & 0xF
                        px.append(last)
            else:
                last = n & 0xF
                px.append(last)
        if len(px) != width:
            raise DecodeError(f"ThunderDecode: {'Not enough' if len(px) < width else 'Too much'} data")
        row = np.array(px + [0] * (width % 2), np.uint8).reshape(-1, 2)
        out.append((row[:, 0] << 4 | row[:, 1]).tobytes())
    return b"".join(out)


def _ycbcr_tables(luma, ref):
    """libtiff's TIFFYCbCrToRGBInit: float32 coefficients into 16.16
    fixed point, the reference black and white scaling each code."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)

    def fix(x):
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    def clampf(x, lo, hi):
        return lo if x < lo else hi if x > hi else x

    f1 = f32(2) - f32(2) * lr
    d1 = fix(clampf(f1, f32(0), f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clampf(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clampf(f3, f32(0), f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clampf(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        rb, rw = f32(rb), f32(rw)
        return f32(f32(c - int(rb)) * f32(cr)) / (rw - rb if rw - rb != 0 else f32(1))

    cr_r, cb_b, cr_g, cb_g, y_tab = [], [], [], [], []
    for i in range(256):
        x = i - 128
        cr = int(clampf(code2v(x, f32(ref[4]) - f32(128), f32(ref[5]) - f32(128), 127), f32(-4096), f32(4096)))
        cb = int(clampf(code2v(x, f32(ref[2]) - f32(128), f32(ref[3]) - f32(128), 127), f32(-4096), f32(4096)))
        cr_r.append((d1 * cr + 32768) >> 16)
        cb_b.append((d3 * cb + 32768) >> 16)
        cr_g.append(d2 * cr)
        cb_g.append(d4 * cb + 32768)
        y_tab.append(int(clampf(code2v(x + 128, ref[0], ref[1], 255), f32(-4096), f32(4096))))
    return tuple(np.array(t, np.int64) for t in (y_tab, cr_r, cb_b, cr_g, cb_g))


def _ycbcr(data, tags, offsets, counts, compression, width, height, tw, th, across, down, tiled, planes):
    """YCbCr without JPEG, as libtiff's TIFFRGBAImage hands it to PIL: each
    strip or tile of data units (h * v luma samples, then Cb and Cr) decoded,
    each pixel converted with its unit's chroma (TIFFYCbCrtoRGB); in
    separate planes (no subsampling only) each pixel from its three planes."""
    hs, vs = (tuple(tags.get(530, (2, 2))) + (2, 2))[:2]
    if (hs, vs) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)) or planes and (hs, vs) != (1, 1):
        raise DecodeError(f"YCbCr subsampling {hs}x{vs}, which libtiff's RGBA reader does not take here")
    if planes:  # three planes of plain samples: one unit a pixel, read across the planes' strips or tiles
        hs = vs = 1
    luma = tags.get(529, (0.299, 0.587, 0.114))
    ref = tags.get(532, (0, 255, 128, 255, 128, 255))
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(luma, ref)
    out = np.zeros((height, width, 3), np.uint8)
    unit = 1 if planes else hs * vs + 2
    per_plane = [np.zeros((height, width), np.int64) for _ in range(3)] if planes else None
    for i, off in enumerate(offsets[:(3 if planes else 1) * across * down]):
        plane, k = divmod(i, across * down)
        ty, tx = divmod(k, across)
        y0, x0 = ty * th, tx * tw
        if y0 >= height:
            break
        rows, cols = min(th, height - y0), min(tw, width - x0)
        bw, bh = -(-(tw if tiled else width) // hs), -(-rows // vs)
        n = bw * bh * unit
        if compression in _CCITT or compression == 32809:
            raise DecodeError("YCbCr TIFF of a 1- or 4-bit coding")
        buf = _inflate(data[off:off + (counts[i] if i < len(counts) else len(data) - off)], compression, n)
        # libtiff reads a strip's rows times its scanline size, a sampling row's bytes over v rounded
        # down: for 4x4 blocks an odd count of them leaves the last unit's last bytes unread (zero)
        got = min(n, bh * vs * (bw * unit // vs))
        buf = np.frombuffer(buf[:got].ljust(n, b"\0"), np.uint8).reshape(bh, bw, unit).astype(np.int64)
        if planes:
            per_plane[plane][y0:y0 + rows, x0:x0 + cols] = buf[:rows, :cols, 0]
            continue
        yy = buf[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3).reshape(bh * vs, bw * hs)
        cb = np.repeat(np.repeat(buf[..., hs * vs], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(buf[..., hs * vs + 1], vs, 0), hs, 1)
        yv = y_tab[yy]
        rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
        out[y0:y0 + rows, x0:x0 + cols] = np.clip(rgb, 0, 255)[:rows, :cols]
    if planes:
        yv, cb, cr = y_tab[per_plane[0]], per_plane[1], per_plane[2]
        out[:] = np.clip(np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1), 0, 255)
    return out


def _ojpeg(data: bytes, tags: dict, width: int, height: int, spp: int, order: str) -> np.ndarray:
    """Old-style JPEG (compression 6) as libtiff's OJPEG codec and RGBA
    reader give it to PIL: the stream at JPEGInterchangeFormat (its scan
    from the strips where the stream stops before one), its components
    decoded without upsampling or colour conversion (libjpeg's raw data),
    each chroma sample spread over its block, then TIFFYCbCrtoRGB; one
    sample is its one component, grey, whatever the photometric tag says
    (PIL reads compression 6 as YCbCr)."""
    from ..image import _component_plane, read_jpeg

    strips = [data[o:o + n] for o, n in zip(tags.get(273, ()), tags.get(279, ()))]
    start = tags.get(513, (None,))[0]
    if start is None:
        if len(strips) > 1 and order == ">":  # libtiff decodes the inner strips of these unlike this stream
            raise unported("old-style JPEG TIFF of table tags over several strips in big-endian order")
        stream = _ojpeg_from_tables(data, tags, width, height, strips, spp)
    else:
        length = tags.get(514, (0,))[0]
        stream = data[start:start + length] if length else data[start:]
        if b"\xff\xda" not in stream:
            stream = stream + b"".join(strips)
    frame = read_jpeg(stream)[0]
    if frame.progressive or frame.arithmetic or frame.lossless:
        raise DecodeError("old-style JPEG TIFF of a frame libtiff's OJPEG does not take (SOF0 / SOF1 only)")
    if len(frame.ids) != spp:
        raise DecodeError("old-style JPEG TIFF whose stream's components are not its samples: libtiff refuses it")
    if spp == 1:
        h, w = min(height, frame.height), min(width, frame.width)
        out = np.zeros((height, width), np.uint8)
        out[:h, :w] = np.clip(_component_plane(frame, 0), 0, 255)[:h, :w]
        return grey_rgb(out)
    planes = []
    for c in range(3):
        p = _component_plane(frame, c)
        p = np.repeat(np.repeat(p, frame.vmax // frame.v[c], 0), frame.hmax // frame.h[c], 1)
        planes.append(np.clip(p, 0, 255).astype(np.int64))
    h, w = min(height, frame.height), min(width, frame.width)
    y, cb, cr = (p[:h, :w] for p in planes)
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(tags.get(529, (0.299, 0.587, 0.114)),
                                                  tags.get(532, (0, 255, 128, 255, 128, 255)))
    yv = y_tab[y]
    out = np.zeros((height, width, 3), np.uint8)
    out[:h, :w] = np.clip(np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1), 0, 255)
    return out


def _ojpeg_from_tables(data: bytes, tags: dict, width: int, height: int, strips: list, spp: int) -> bytes:
    """The JPEG stream libtiff's OJPEG builds from TIFF 6.0's table tags:
    each component's quantisation table (JPEGQTables, 64 bytes in zigzag
    order) and DC / AC Huffman tables (16 counts, then the values), a
    baseline frame of luma at the YCbCrSubsampling factors and 1x1 chroma
    (one component for one sample), the restart interval, then the strips'
    entropy-coded data; over more than one strip each strip is a restart
    interval of its MCUs (an RST marker between strips)."""
    if tags.get(512, (1,))[0] != 1:
        raise DecodeError("old-style JPEG TIFF of a lossless process: libtiff refuses it")

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    def huff(off: int) -> bytes:
        counts = data[off:off + 16]
        return counts + data[off + 16:off + 16 + sum(counts)]

    try:
        q, dc, ac = (tags[t] for t in (519, 520, 521))
    except KeyError as e:
        raise DecodeError("old-style JPEG TIFF without its tables") from e
    hs, vs = (tuple(tags.get(530, (2, 2))) + (2, 2))[:2] if spp == 3 else (1, 1)
    out = b"\xff\xd8"
    for c in range(spp):
        out += seg(0xDB, bytes([c]) + data[q[c]:q[c] + 64])
        out += seg(0xC4, bytes([c]) + huff(dc[c])) + seg(0xC4, bytes([0x10 | c]) + huff(ac[c]))
    comps = b"".join(bytes([c + 1, (hs << 4 | vs) if c == 0 else 0x11, c]) for c in range(spp))
    out += seg(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([spp]) + comps)
    if tags.get(515, (0,))[0]:
        out += seg(0xDD, tags[515][0].to_bytes(2, "big"))
    elif len(strips) > 1:
        rps = min(tags.get(278, (height,))[0], height)
        out += seg(0xDD, (-(-width // (8 * hs)) * (rps // (8 * vs))).to_bytes(2, "big"))
    out += seg(0xDA, bytes([spp]) + b"".join(bytes([c + 1, c << 4 | c]) for c in range(spp)) + bytes([0, 63, 0]))
    body = b"".join(strip + (bytes([0xFF, 0xD0 | i % 8]) if i + 1 < len(strips) else b"")
                    for i, strip in enumerate(strips))
    return out + body + b"\xff\xd9"


_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: np.rot90(a, 1)}


def _orient(rgb: np.ndarray, orientation) -> np.ndarray:
    """PIL's exif_transpose after the load: orientation 2-8 flips or turns
    the image (5-8 swap its sides); any other value leaves it."""
    f = _ORIENT.get(orientation)
    return rgb if f is None else np.ascontiguousarray(f(rgb))


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
    return decode_jpeg(chunk, "ycc" if ycc else "raw", (1, 2, 3, 4))


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
    if compression not in _COMPRESSIONS:  # PIL's KeyError: no TIFF, and no other format takes it
        raise NotThisFormat(f"TIFF compression {compression}, which PIL does not know")
    if compression in (34676, 34677):
        raise DecodeError("SGILog TIFF: PIL has no mode for LogLuv")
    if compression == 50001:
        raise DecodeError("WEBP compression support is not configured")
    if compression == 6:  # PIL takes old-style JPEG for YCbCr, three samples unless told otherwise
        photo = 6
    extra = tuple(tags.get(338, ()))
    spp = one(277, 3 if compression == 6 and photo in (2, 6) else 1)
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
    if compression == 6:
        if spp == 1 and one(262, 0) in (2, 6):
            raise DecodeError("old-style JPEG TIFF of one sample under an RGB or YCbCr photometric: libtiff "
                              "refuses its directory (PIL: decoder error -2)")
        if raw not in ("RGBX", "L"):
            raise DecodeError(f"old-style JPEG TIFF of PIL's raw mode {raw}: libtiff's OJPEG fails it")
        return _orient(_ojpeg(data, tags, width, height, 3 if raw == "RGBX" else 1, order), one(274, 1))
    ycbcr = photo == 6 and compression not in (1, 7) and raw == "RGBX"  # libtiff's RGBA reader converts it
    if photo == 6 and compression == 7 and planar != 1:
        raise DecodeError("YCbCr JPEG TIFF in separate planes: libtiff converts YCbCr to RGB on contiguous "
                          "samples only (PIL: decoder error -2)")
    bps = bps_t[0]
    if fill == 2 and compression not in (1, 2, 3, 4, 32771) and 324 in tags:
        raise DecodeError("tiled, compressed TIFF with fill order 2: PIL's libtiff decoder fails it")
    if compression in _CCITT and bps != 1:
        raise DecodeError("Fax3SetupState: Bits/sample must be 1 for Group 3/4 encoding/decoding")
    if compression not in _PREDICTED:
        predictor = 1  # libtiff applies it to LZW, Deflate, LZMA and ZSTD only; PIL's raw decoder never
    if predictor == 3 and (fmt != (3,) or bps not in (16, 24, 32, 64)):
        raise DecodeError("floating-point TIFF predictor on samples that are not IEEE floats")
    if predictor not in (1, 2, 3):
        raise DecodeError(f"TIFF predictor {predictor}, which libtiff does not take")
    tiles16 = False
    if planar == 2 and spp > 1:
        # PIL gives each plane one letter of the raw mode: X (and, on
        # uncompressed data, a) has no unpacker, and 16-bit uncompressed
        # planes are read as if their samples were bytes
        used = raw[:spp]  # the letters the planes take
        if compression == 1 and ("X" in used or "a" in used) or "X" in used and 324 not in tags:
            raise DecodeError(f"TIFF planes of raw mode {raw}: PIL has no unpacker for them")
        if compression == 1 and bps == 16:
            tiles16 = 324 in tags
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
    if ycbcr:  # libtiff's RGBA reader leaves the raster upright; PIL turns it by the tag afterwards
        return _orient(_ycbcr(data, tags, offsets, counts, compression, width, height, tw, th, across, down,
                              324 in tags, planar == 2), one(274, 1))
    if photo == 6 and compression == 1 and raw == "RGBX" and planar == 1:
        # PIL's own raw decoder: four bytes a pixel from each strip's or
        # tile's offset on, whatever the subsampling and the byte counts say;
        # a tile at the right edge steps three bytes a pixel of its width
        out = np.zeros((height, width, 3), np.uint8)
        for i, off in enumerate(offsets[:across * down]):
            ty, tx = divmod(i, across)
            y0, x0 = ty * th, tx * tw
            rows, cols = min(th, height - y0), min(tw, width - x0)
            stride = 3 * tw if x0 + tw > width else 4 * cols
            if stride < 4 * cols:
                raise DecodeError("TIFF tile whose row stride is shorter than its row: PIL's raw decoder refuses it")
            px = raw_rows(data, off, rows, 4 * cols, stride, "TIFF").reshape(rows, cols, 4)
            out[y0:y0 + rows, x0:x0 + cols] = px[..., :3]
        return _orient(out, one(274, 1))
    if tiles16:
        raws = _planar_tiles16(data, offsets, width, height, tw, th, planes)
        offsets = ()
    jpeg_px = None
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
            if planar == 2 and spp > 1:  # one stream a plane, each of one component
                if tile.shape[-1] != 1:
                    raise DecodeError("JPEG TIFF plane whose stream is not one component")
                if jpeg_px is None:
                    jpeg_px = np.zeros((height, width, spp), np.uint8)
                jpeg_px[y0:y0 + h_, x0:x0 + w_, plane] = tile[:h_, :w_, 0]
                continue
            if jpeg_px is None:
                jpeg_px = np.zeros((height, width, tile.shape[-1]), np.uint8)
            if tile.shape[-1] != jpeg_px.shape[-1]:
                raise DecodeError("JPEG TIFF whose streams differ in their components")
            jpeg_px[y0:y0 + h_, x0:x0 + w_] = tile[:h_, :w_]
            continue
        if compression == 1:
            buf = src
        elif compression in _CCITT:
            buf = ccitt.decode(src, compression, tw, rows, one(292, 0))
        elif compression == 32809:
            buf = _thunderscan(src, tw, rows)
        else:
            buf = _inflate(src, compression, need_bytes)
        if len(buf) < need_bytes:
            if compression == 1:
                raise DecodeError("truncated TIFF image data")
            buf = buf + bytes(need_bytes - len(buf))  # libtiff leaves the rest of a short strip zero
        arr = np.frombuffer(buf, np.uint8, need_bytes).copy()
        if predictor == 2:
            arr = _undo_predictor(arr, rows, chunk_bytes, per_plane, bps, order)
        elif predictor == 3:
            arr = _undo_float_predictor(arr, rows, chunk_bytes, per_plane, bps)
        arr = arr.reshape(rows, chunk_bytes)
        r = min(rows, height - y0)
        xb = x0 * per_plane * bps // 8
        c = min(chunk_bytes, row_bytes - xb)
        raws[plane][y0:y0 + r, xb:xb + c] = arr[:r, :c]
    if compression == 7:
        if bps != 8:
            raise DecodeError(f"JPEG TIFF of {bps}-bit samples: libtiff's JPEG codec refuses them "
                              "(PIL: decoder error -2)")
        if jpeg_px is None:
            raise DecodeError("JPEG TIFF without strips")
        if raw not in ("RGB", "RGBX", "RGBA", "L", "LA", "CMYK"):  # libtiff's bytes, then PIL's unpacker (L;I, P)
            if jpeg_px.shape[-1] != spp:
                raise DecodeError("JPEG TIFF whose streams' components are not its samples")
            rows = [np.ascontiguousarray(jpeg_px[..., i] if planar == 2 else jpeg_px.reshape(height, -1))
                    for i in range(planes)]
            return _orient(_rgb(rows, tags, raw, photo, fmt, bps, spp, planes, width, height, order, 1, 1),
                           one(274, 1))
        if raw == "CMYK":
            if jpeg_px.shape[-1] != 4:
                raise DecodeError("CMYK JPEG TIFF whose streams are not four components")
            return _orient(cmyk_rgb(jpeg_px), one(274, 1))
        px = np.repeat(jpeg_px[..., :1], 3, -1) if raw in ("L", "LA") else jpeg_px[..., :3]
        return _orient(np.ascontiguousarray(px), one(274, 1))
    return _orient(_rgb(raws, tags, raw, photo, fmt, bps, spp, planes, width, height, order, compression, predictor),
                   one(274, 1))


def _rgb(raws, tags, raw, photo, fmt, bps, spp, planes, width, height, order, compression, predictor):
    """The rows of bytes of each plane -> (H, W, 3), by PIL's raw mode."""
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
    if raw == "I;12":  # two samples in three bytes, most significant first, then as I;16
        b = raws[0][:, :(width * 12 + 7) // 8].astype(np.int64)
        b = np.pad(b, ((0, 0), (0, (-b.shape[1]) % 3)))
        t = b.reshape(height, -1, 3)
        v = np.stack([t[..., 0] << 4 | t[..., 1] >> 4, (t[..., 1] & 0xF) << 8 | t[..., 2]], -1).reshape(height, -1)
        return grey_rgb(np.minimum(v[:, :width], 255).astype(np.uint8))
    swapped = compression != 1 and order == ">" and bps in (16, 32) and (kind == "f" or kind == "i")
    # libtiff hands PIL native (little-endian) samples, which PIL unpacks
    # with these modes' big-endian unpackers all the same; the float
    # predictor's samples are native already, and read as the file's order
    swapped = swapped and predictor != 3
    dt = np.dtype(f"{kind}{bps // 8}").newbyteorder("<" if swapped else order)
    if planes == 1:
        s = raws[0].view(dt).reshape(height, width, spp)
    else:
        s = np.stack([p.view(dt).reshape(height, width) for p in raws], -1)
    if raw == "F":  # clipped into 0-255, truncated, NaN black: PIL's F -> L
        return grey_rgb(float_l(s[..., 0]))
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
    if raw == "LAB":  # PIL's LAB unpacker flips a* and b*'s sign bits: signed in the file, offset in PIL
        from .lab import lab_rgb

        return lab_rgb(s[..., :3].astype(np.uint8) ^ np.array([0, 128, 128], np.uint8))
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
