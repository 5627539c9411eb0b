"""Image IO: PNG read-write, JPEG read (and the viewer's JPEG write), the
Radiance .hdr loader and PFM (port of optixpathtracer_tpu/io/image.py).

The reference decodes and encodes images through PIL. The port has its own
codecs written with `zlib`, `struct` and numpy, so it needs no image
library. `rgb8_from_bytes` (and `read_rgb8` / `load_image` on a file) tells
the format by its bytes, in PIL's order (io/codecs), and gives the uint8
values PIL's `Image.open(...).convert("RGB")` gives. This module holds the
two formats glTF allows:

- PNG, the whole format: colour types 0 (grey), 2 (RGB), 3 (palette),
  4 (grey + alpha) and 6 (RGBA), every bit depth (1, 2, 4, 8, 16), all five
  scanline filters, Adam7 interlacing. Grey is replicated (1-4 bit grey
  scaled to 0-255), palettes are looked up, alpha is dropped, 16-bit
  samples keep their high byte except 16-bit grey, which PIL opens as mode
  I;16 and clamps to 255.
- JPEG: Huffman or arithmetic coding (codecs/jpeg_arith.py), baseline,
  extended sequential and progressive, and 8-bit lossless
  (codecs/jpeg_lossless.py); grey, three components (YCbCr, or RGB by the
  Adobe / component-id rules) or four (CMYK, or YCCK under an Adobe
  marker, read inverted and converted as PIL converts CMYK); any integral
  sampling factors, restart intervals, any size. Decoded with libjpeg's
  integer pipeline (see `decode_jpeg`), bit for bit what PIL
  (libjpeg-turbo) gives.

The other formats are io/codecs' modules. What PIL cannot read raises an
OSError (12-bit and hierarchical JPEG, bytes of no format); what PIL reads
and the port does not raises NotImplementedError naming ROADMAP A.1. The
Radiance RGBE and PFM code is the reference's numpy.

`encode_jpeg` is the port's own baseline JPEG encoder (the reference's
viewer encodes with PIL): JFIF, the Annex K quantisation tables scaled by
quality with the IJG formula, 4:2:0 chroma, the standard Huffman tables.
The colour transform, DCT and quantisation are tensor ops on the frame's
own device; the entropy coding is vectorised numpy. The tables, the zigzag
order and the canonical Huffman codes live here once, for the encoder and
the decoder.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from . import codecs
from .codecs import jpeg_arith, jpeg_lossless
from .codecs._common import DecodeError, NotThisFormat, cmyk_rgb

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _chunks(data: bytes):
    """(type, body) of each PNG chunk after the signature, up to IEND."""
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise DecodeError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length  # length, type, body, CRC
    raise DecodeError("PNG without IEND")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Paeth filter in place (PNG spec 9.4)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pa = abs(b - c)
        pb = abs(a - c)
        pc = abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 scanlines with every row's filter undone."""
    if len(raw) < height * (stride + 1):
        raise DecodeError("PNG image data too short")
    out = np.zeros((height + 1, stride), np.uint8)  # row 0: the zero prior line
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        prior = out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum mod 256 of each byte lane
            out[y + 1] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y + 1] = line + prior
        elif kind == 3:  # Average of left and up, left from the decoded row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        elif kind == 4:
            cur = bytearray(line.tobytes())
            _paeth_row(cur, prior.tobytes(), bpp)
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise DecodeError(f"unknown PNG filter type {kind}")
    return out[1:]


# Adam7 passes: (x0, y0, dx, dy) of each pass's pixel grid (PNG spec 8.2)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _png_samples(rows: np.ndarray, width: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines (h, stride) uint8 -> (h, width, ch) samples:
    uint8 for depths 1-8 (unscaled values), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, ch)
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        return vals.reshape(h, -1)[:, :width * ch].reshape(h, width, ch).astype(np.uint8)
    return rows.reshape(h, width, ch)


def decode_png(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None, int]:
    """PNG bytes -> (samples (H, W, C), colour type, palette (256, 3) uint8
    or None, bit depth). Samples are uint8 for depths 1-8 (values as
    stored: palette indices, unscaled grey), uint16 for 16; Adam7
    interlacing is undone."""
    if data.startswith(_JPEG_MAGIC):
        raise DecodeError("a JPEG image, not a PNG: decode it with rgb8_from_bytes")
    if not data.startswith(_PNG_MAGIC):
        raise DecodeError("not a PNG image")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            entries = np.frombuffer(body, np.uint8).reshape(-1, 3)
            palette = np.zeros((256, 3), np.uint8)  # indices past the table read black
            palette[: len(entries)] = entries[:256]
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise DecodeError("PNG without IHDR")
    width, height, depth, color, _compression, _filter, interlace = header
    if color not in _CHANNELS:
        raise DecodeError(f"invalid PNG colour type {color}")
    if depth not in _PNG_DEPTHS[color]:
        raise DecodeError(f"invalid PNG bit depth {depth} for colour type {color}")
    if interlace not in (0, 1):
        raise DecodeError(f"invalid PNG interlace method {interlace}")
    if color == 3 and palette is None:
        raise DecodeError("palette PNG without PLTE")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)  # the filters' byte distance
    raw = zlib.decompress(b"".join(idat))
    dtype = np.uint16 if depth == 16 else np.uint8
    if not interlace:
        rows = _unfilter(raw, height, (width * ch * depth + 7) // 8, bpp)
        return _png_samples(rows, width, ch, depth), color, palette, depth
    out = np.zeros((height, width, ch), dtype)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no scanlines, not even filter bytes
        stride = (pw * ch * depth + 7) // 8
        rows = _unfilter(raw[pos:], ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _png_samples(rows, pw, ch, depth)
    return out, color, palette, depth


def rgb8_from_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's convert("RGB") gives it: grey
    of 1, 2 and 4 bits scaled to 0-255, 16-bit RGB(A) and grey + alpha
    keeping the high byte, 16-bit grey (PIL's mode I;16) clamped to 255,
    palettes looked up, alpha dropped."""
    px, color, palette, depth = decode_png(data)
    if color == 3:
        return palette[px[..., 0]]
    if depth == 16:
        if color == 0:
            px = np.minimum(px, 255)
        else:
            px = px >> 8
        px = px.astype(np.uint8)
    elif depth < 8:  # grey: 0..2^depth-1 onto 0..255, as PIL's unpackers do
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def rgb8_from_bytes(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8, what PIL's
    `Image.open(...).convert("RGB")` gives, for every format the port
    reads (io/codecs: the format told by its bytes in PIL's order). A format
    PIL reads and the port does not raises NotImplementedError naming
    ROADMAP A.1; bytes PIL cannot read raise an OSError: `codecs.
    UnidentifiedImageError` where no format takes them, `codecs.DecodeError`
    where the format's data does not decode."""
    return codecs.rgb8(data)


def read_rgb8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return rgb8_from_bytes(f.read())


def load_image(path: str, flip_y: bool = True) -> np.ndarray:
    """8-bit image -> (H, W, 3) float32 in [0,1]. flip_y matches the
    reference's texture convention (Model.cpp:116-125 mirrors stb rows)."""
    img = read_rgb8(path).astype(np.float32) / 255.0
    return img[::-1] if flip_y else img


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes
    (filter 0 on every row)."""
    if arr.ndim == 2:
        arr = arr[..., None]
    color = {1: 0, 3: 2, 4: 6}[arr.shape[-1]]
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3|4) uint8 or float in [0,1] -> PNG."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))


# ---- baseline JPEG encoding --------------------------------------------------

# ITU-T T.81 Annex K.1: the example quantisation tables, natural (row-major) order
JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int32)
JPEG_CHROMA_Q = np.full(64, 99, np.int32)
JPEG_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _zigzag() -> np.ndarray:
    """Natural index of each zigzag position (T.81 Figure 5)."""
    order = sorted(((y, x) for y in range(8) for x in range(8)),
                   key=lambda p: (p[0] + p[1], p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([y * 8 + x for y, x in order], np.int64)


JPEG_ZIGZAG = _zigzag()


def _ac_values(head: list[int]) -> list[int]:
    """A standard AC table's symbols: `head`, then every (run, size) symbol
    with size 1-10 not yet listed, by run then size (T.81 Table K.5/K.6)."""
    return head + [r << 4 | z for r in range(16) for z in range(1, 11) if r << 4 | z not in head]


# T.81 Annex K.3: (code counts per length 1-16, symbols) of the standard tables
JPEG_HUFFMAN = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
        0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
        0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
        0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
        0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
        0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
        0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
        0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
        0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
        0xE9, 0xEA, 0xF1])),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
        0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
        0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
        0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
        0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
        0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
        0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
        0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
        0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2])),
}


def jpeg_quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantisation tables in natural order for a quality of
    1-100, scaled as the IJG library does (baseline: at most 255)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int32)
                 for t in (JPEG_LUMA_Q, JPEG_CHROMA_Q))


def _huffman_codes(bits: list[int], vals: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0-255 of a canonical Huffman table."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]], length[vals[k]] = c, n_bits
            c += 1
            k += 1
        c <<= 1
    return code, length


# (code, length) per symbol of the DC and the AC tables, each stacked (luma, chroma)
_CODES = tuple(tuple(np.stack(v) for v in zip(*(_huffman_codes(*JPEG_HUFFMAN[f"{kind}_{c}"])
                                                for c in ("luma", "chroma"))))
               for kind in ("dc", "ac"))


def _dct_matrix(device) -> torch.Tensor:
    """The orthonormal 8-point DCT-II: D @ X @ D.T is T.81's FDCT."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.cos((2 * x + 1) * u * np.pi / 16) * np.where(u == 0, np.sqrt(1 / 8), 0.5)
    return torch.as_tensor(d, dtype=torch.float32, device=device)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) plane, both multiples of 8 -> (H/8, W/8, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def _bit_size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0): the JPEG magnitude category."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _scan_bits(coefs: np.ndarray, comp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(value, bit length) of every code word of the scan, in order: per
    block its DC difference, each nonzero AC coefficient (preceded by one
    ZRL per 16 zeros of its run) and an EOB unless coefficient 63 is
    nonzero. comp[b] is block b's component: 0 takes the luma tables."""
    (dc_code, dc_len), (ac_code, ac_len) = _CODES
    n_blocks = coefs.shape[0]
    tb = (comp > 0).astype(np.int64)
    dc = coefs[:, 0].astype(np.int64)
    diff = np.empty(n_blocks, np.int64)
    for c in np.unique(comp):
        m = comp == c
        diff[m] = np.diff(dc[m], prepend=0)
    ds = _bit_size(diff)
    dc_val = dc_code[tb, ds] << ds | np.where(diff >= 0, diff, diff + (1 << ds) - 1)
    # nonzero AC coefficients, block by block in zigzag order
    ac = coefs[:, 1:]
    bi, ki = np.nonzero(ac)
    k = ki + 1
    first = np.ones(len(k), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    n_zrl = run >> 4
    v = ac[bi, ki].astype(np.int64)
    s = _bit_size(v)
    sym = (run & 15) << 4 | s
    tbi = tb[bi]
    ac_val = ac_code[tbi, sym] << s | np.where(v >= 0, v, v + (1 << s) - 1)
    last = np.ones(len(k), bool)
    last[:-1] = first[1:]
    last_k = np.zeros(n_blocks, np.int64)
    last_k[bi[last]] = k[last]
    eob = last_k < 63
    per_nz = n_zrl + 1
    nz_items = np.bincount(bi, weights=per_nz, minlength=n_blocks).astype(np.int64)
    n_items = 1 + nz_items + eob
    start = np.cumsum(n_items) - n_items
    vals = np.empty(int(n_items.sum()), np.int64)
    lens = np.empty_like(vals)
    vals[start], lens[start] = dc_val, dc_len[tb, ds] + ds
    before = np.cumsum(nz_items) - nz_items  # nonzero items of earlier blocks
    pos = start[bi] + np.cumsum(per_nz) - before[bi]
    vals[pos], lens[pos] = ac_val, ac_len[tbi, sym] + s
    if n_zrl.any():
        owner = np.repeat(np.arange(len(k)), n_zrl)
        j = np.arange(len(owner)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        zpos = pos[owner] - n_zrl[owner] + j
        vals[zpos], lens[zpos] = ac_code[tbi[owner], 0xF0], ac_len[tbi[owner], 0xF0]
    eb = np.flatnonzero(eob)
    epos = start[eb] + n_items[eb] - 1
    vals[epos], lens[epos] = ac_code[tb[eb], 0x00], ac_len[tb[eb], 0x00]
    return vals, lens


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate code words (each under 64 bits) MSB first, pad the last
    byte with 1 bits and stuff a 0x00 after every 0xFF."""
    ends = np.cumsum(lens)
    total = int(ends[-1])
    offs = ends - lens
    word = offs >> 6
    end = (offs & 63) + lens
    v = vals.astype(np.uint64)
    straddle = end > 64
    hi = (v << np.where(straddle, 0, 64 - end).astype(np.uint64)) >> np.where(
        straddle, end - 64, 0).astype(np.uint64)
    lo = v << np.where(straddle, 128 - end, 0).astype(np.uint64)
    n_words = (total + 63) >> 6
    words = np.zeros(n_words + 1, np.uint64)
    starts = np.flatnonzero(np.concatenate([[True], word[1:] != word[:-1]]))
    words[word[starts]] = np.bitwise_or.reduceat(hi, starts)
    words[word[straddle] + 1] |= lo[straddle]
    data = words[:n_words].astype(">u8").view(np.uint8)[: (total + 7) >> 3].copy()
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def encode_jpeg(image, quality: int = 85) -> bytes:
    """(H, W) grey or (H, W, 3 | 4) RGB(A) image -> baseline JPEG bytes.

    `image` is a numpy array or a tensor on any device: uint8, or float in
    [0, 1] converted as the viewer's `publish` converts it (clipped, times
    255, truncated); alpha is dropped. The colour transform (JFIF YCbCr),
    the 2x2 chroma average (4:2:0), the DCT and the quantisation run as
    tensor ops where the image lives; edges are replicated to whole MCUs."""
    t = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
    if t.dtype != torch.uint8:
        t = (torch.clamp(t.to(torch.float32), 0.0, 1.0) * 255.0).to(torch.uint8)
    if t.dim() == 3 and t.shape[-1] == 1:
        t = t[..., 0]
    h, w = t.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG cannot hold a {w}x{h} image")
    grey = t.dim() == 2
    x = t.to(torch.float32)
    mcu = 8 if grey else 16
    pad = (0, -w % mcu, 0, -h % mcu)
    dct = _dct_matrix(t.device)
    luma_q, chroma_q = jpeg_quant_tables(quality)

    def quantise(plane, q_table):
        b = _blocks(plane - 128.0)
        f = dct @ b @ dct.T
        q = torch.as_tensor(q_table.reshape(8, 8), dtype=torch.float32, device=t.device)
        z = torch.round(f / q).to(torch.int32).reshape(*f.shape[:2], 64)
        z = z[..., torch.as_tensor(JPEG_ZIGZAG, device=t.device)]
        z[..., 1:] = z[..., 1:].clamp(-1023, 1023)  # baseline AC magnitudes: 10 bits
        return z

    if grey:
        y = torch.nn.functional.pad(x[None, None], pad, mode="replicate")[0, 0]
        coefs = quantise(y, luma_q).reshape(-1, 64)
        comp = np.zeros(coefs.shape[0], np.int64)
        comps = [(1, 0x11, 0)]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        ycc = torch.stack([
            0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0])
        ycc = torch.nn.functional.pad(ycc[None], pad, mode="replicate")[0]
        hp, wp = ycc.shape[1:]
        chroma = ycc[1:].reshape(2, hp // 2, 2, wp // 2, 2).mean((2, 4))
        yb = quantise(ycc[0], luma_q)  # (2 my, 2 mx, 64)
        my, mx = hp // 16, wp // 16
        yb = yb.reshape(my, 2, mx, 2, 64).permute(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
        cb, cr = (quantise(c, chroma_q).reshape(my * mx, 1, 64) for c in chroma)
        coefs = torch.cat([yb, cb, cr], dim=1).reshape(-1, 64)
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.int64), my * mx)
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    data = _pack_bits(*_scan_bits(coefs.cpu().numpy(), comp))

    tables = [luma_q] if grey else [luma_q, chroma_q]
    dqt = b"".join(bytes([i]) + q[JPEG_ZIGZAG].astype(np.uint8).tobytes() for i, q in enumerate(tables))
    names = [("dc_luma", 0x00), ("ac_luma", 0x10)]
    if not grey:
        names += [("dc_chroma", 0x01), ("ac_chroma", 0x11)]
    dht = b"".join(bytes([tc_th]) + bytes(JPEG_HUFFMAN[n][0]) + bytes(JPEG_HUFFMAN[n][1])
                   for n, tc_th in names)
    sof = struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(
        bytes([cid, hv, tq]) for cid, hv, tq in comps)
    sos = bytes([len(comps)]) + b"".join(
        bytes([cid, 0x00 if tq == 0 else 0x11]) for cid, _, tq in comps) + bytes([0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDA, sos) + data + b"\xff\xd9")


# ---- JPEG decoding -------------------------------------------------------------
#
# libjpeg's integer pipeline (what PIL links: libjpeg-turbo), so the pixels
# equal PIL's: the ISLOW IDCT (jidctint.c), "fancy" triangle upsampling of
# the chroma (jdsample.c) and the fixed-point YCbCr -> RGB tables
# (jdcolor.c). The entropy decoding is sequential host Python over 64-bit
# windows of the scan's bytes; dequantisation, IDCT, upsampling and the
# colour transform are numpy over every block at once.

# SOF marker -> (progressive, arithmetic, lossless); the hierarchical ones
# (C5-C7, CD-CF) and arithmetic lossless (CB) libjpeg-turbo does not decode
_JPEG_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False), 0xC2: (True, False, False),
             0xC3: (False, False, True), 0xC9: (False, True, False), 0xCA: (True, True, False)}
_JPEG_UNSUPPORTED_SOF = {0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
                         0xCB: "arithmetic-coded lossless", 0xCD: "hierarchical",
                         0xCE: "hierarchical", 0xCF: "hierarchical"}


def _huffman_lut(bits: bytes, vals: bytes) -> list[int]:
    """16-bit peek -> (code length << 8 | symbol), 0 where no code starts."""
    if sum(bits) != len(vals) or len(vals) > 256:
        raise DecodeError("corrupt JPEG Huffman table")
    code, length = _huffman_codes(list(bits), list(vals))
    lut = np.zeros(1 << 16, np.int64)
    for sym in vals:
        n = int(length[sym])
        c = int(code[sym])
        if c >> n:
            raise DecodeError("corrupt JPEG Huffman table")
        lut[c << (16 - n):(c + 1) << (16 - n)] = n << 8 | sym
    return lut.tolist()


def _bit_windows(seg: bytes) -> list[int]:
    """win[i]: the 64 bits from byte i on (big-endian), zeros past the end;
    bit p of the segment is bit 63 - p % 8 of win[p >> 3]."""
    n = len(seg) + 8
    b = np.frombuffer(seg + bytes(16), np.uint8).astype(np.uint64)
    win = np.zeros(n, np.uint64)
    for i in range(8):
        win |= b[i:i + n] << np.uint64(56 - 8 * i)
    return win.tolist()


def _entropy_segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data from `pos`: its restart intervals (stuffed
    zero bytes removed) and the position of the marker that ends it."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            raise DecodeError("JPEG scan runs past the end of the data")
        k = i
        while k + 1 < len(data) and data[k + 1] == 0xFF:
            k += 1  # fill bytes before a marker
        if k + 1 >= len(data):
            raise DecodeError("JPEG scan runs past the end of the data")
        marker = data[k + 1]
        if marker == 0x00 and k == i:
            pos = i + 2
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= marker <= 0xD7:
            pos = start = k + 2
            continue
        return segs, k


class _Frame:
    """SOF parameters and the coefficient store of every component."""

    def __init__(self, body: bytes, kind: tuple[bool, bool, bool], layers: tuple = (1, 3, 4)):
        precision, self.height, self.width, n = struct.unpack(">BHHB", body[:6])
        if precision != 8 or n not in layers:
            # PIL's JPEG plugin does not take the file: it is no format PIL reads
            raise NotThisFormat(f"cannot handle {precision}-bit, {n}-layer JPEG")
        if self.height == 0 or self.width == 0:
            raise DecodeError("JPEG frame without a size (DNL is not supported)")
        self.progressive, self.arithmetic, self.lossless = kind
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for c in range(n):
            cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise DecodeError("corrupt JPEG sampling factors")
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        unit = 1 if self.lossless else 8  # a lossless data unit is one sample
        self.mcus_x = -(-self.width // (unit * self.hmax))
        self.mcus_y = -(-self.height // (unit * self.vmax))
        # per component: samples across and down (libjpeg's downsampled
        # width / height) and the MCU-padded block store
        self.cw = [-(-self.width * h // self.hmax) for h in self.h]
        self.ch = [-(-self.height * v // self.vmax) for v in self.v]
        self.bx = [self.mcus_x * h for h in self.h]
        self.by = [self.mcus_y * v for v in self.v]
        self.coefs = None if self.lossless else [[0] * (bx * by * 64) for bx, by in zip(self.bx, self.by)]
        self.quant: list[np.ndarray | None] = [None] * n
        self.samples: list[np.ndarray | None] = [None] * n  # lossless: each component's samples

    def scan_mcus(self, comps: list[int]) -> list[list[tuple[int, int]]]:
        """Each MCU of a scan over `comps`: (index into comps, offset of the
        block's 64 coefficients in that component's store)."""
        if len(comps) == 1:  # non-interleaved: the component's own block grid
            c = comps[0]
            nbx, nby = -(-self.cw[c] // 8), -(-self.ch[c] // 8)
            return [[(0, (y * self.bx[c] + x) * 64)] for y in range(nby) for x in range(nbx)]
        mcus = []
        for my in range(self.mcus_y):
            for mx in range(self.mcus_x):
                blocks = []
                for i, c in enumerate(comps):
                    for y in range(self.v[c]):
                        for x in range(self.h[c]):
                            blocks.append((i, ((my * self.v[c] + y) * self.bx[c] + mx * self.h[c] + x) * 64))
                mcus.append(blocks)
        return mcus


def _receive(win, pos, s):
    """(the s-bit value at bit `pos`, sign-extended as T.81 F.2.2.1, pos + s)."""
    v = (win[pos >> 3] >> (64 - (pos & 7) - s)) & ((1 << s) - 1)
    if v < (1 << (s - 1)):
        v -= (1 << s) - 1
    return v, pos + s


def _decode_scan(frame: _Frame, comps, dc_luts, ac_luts, ss, se, ah, al, segs, restart):
    """Decode one scan's segments into the frame's coefficient stores
    (zigzag order): sequential, or one progressive pass (DC first or
    refine, AC first or refine, T.81 G.1.2)."""
    mcus = frame.scan_mcus(comps)
    per = restart or len(mcus)
    if -(-len(mcus) // per) > len(segs):
        raise DecodeError("JPEG scan has fewer restart intervals than MCUs need")
    stores = [frame.coefs[c] for c in comps]
    sequential = not frame.progressive
    p1, m1 = 1 << al, -1 << al
    bad = "corrupt JPEG data: invalid Huffman code"
    for seg_i in range(-(-len(mcus) // per)):
        win = _bit_windows(segs[seg_i])
        pos = 0
        pred = [0] * len(comps)
        eobrun = 0
        for mcu in mcus[seg_i * per:(seg_i + 1) * per]:
            for ci, base in mcu:
                co = stores[ci]
                if ss == 0 and ah == 0:  # DC first, or the DC of a sequential block
                    e = dc_luts[ci][(win[pos >> 3] >> (48 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise DecodeError(bad)
                    pos += e >> 8
                    s = e & 0xFF
                    if s:
                        d, pos = _receive(win, pos, s)
                        pred[ci] += d
                    co[base] = pred[ci] << al
                    if not sequential:
                        continue
                    ac = ac_luts[ci]
                    k = 1
                    while k < 64:
                        e = ac[(win[pos >> 3] >> (48 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise DecodeError(bad)
                        pos += e >> 8
                        rs = e & 0xFF
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            if k > 63:
                                raise DecodeError("corrupt JPEG data: coefficient past 63")
                            v = (win[pos >> 3] >> (64 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            co[base + k] = v
                            k += 1
                        elif rs == 0xF0:
                            k += 16
                        else:
                            break
                elif ss == 0:  # DC refine: one bit
                    if (win[pos >> 3] >> (63 - (pos & 7))) & 1:
                        co[base] |= p1
                    pos += 1
                elif ah == 0:  # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    ac = ac_luts[ci]
                    k = ss
                    while k <= se:
                        e = ac[(win[pos >> 3] >> (48 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise DecodeError(bad)
                        pos += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > se:
                                raise DecodeError("corrupt JPEG data: coefficient past the band")
                            v, pos = _receive(win, pos, s)
                            co[base + k] = v * p1
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = 1 << r
                            if r:
                                eobrun += (win[pos >> 3] >> (64 - (pos & 7) - r)) & ((1 << r) - 1)
                                pos += r
                            eobrun -= 1
                            break
                else:  # AC refine (jdphuff.c decode_mcu_AC_refine)
                    k = ss
                    if not eobrun:
                        ac = ac_luts[ci]
                        while k <= se:
                            e = ac[(win[pos >> 3] >> (48 - (pos & 7))) & 0xFFFF]
                            if not e:
                                raise DecodeError(bad)
                            pos += e >> 8
                            rs = e & 0xFF
                            r, s = rs >> 4, rs & 15
                            if s:
                                if s != 1:
                                    raise DecodeError("corrupt JPEG data: refinement size")
                                s = p1 if (win[pos >> 3] >> (63 - (pos & 7))) & 1 else m1
                                pos += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += (win[pos >> 3] >> (64 - (pos & 7) - r)) & ((1 << r) - 1)
                                    pos += r
                                break
                            while k <= se:  # correct nonzero ones, skip r zero ones
                                c = co[base + k]
                                if c:
                                    if (win[pos >> 3] >> (63 - (pos & 7))) & 1 and not c & p1:
                                        co[base + k] = c + (p1 if c >= 0 else m1)
                                    pos += 1
                                elif r:
                                    r -= 1
                                else:
                                    break
                                k += 1
                            if s:
                                if k > se:
                                    raise DecodeError("corrupt JPEG data: coefficient past the band")
                                co[base + k] = s
                            k += 1
                    if eobrun:  # the band's rest: correction bits only
                        while k <= se:
                            c = co[base + k]
                            if c:
                                if (win[pos >> 3] >> (63 - (pos & 7))) & 1 and not c & p1:
                                    co[base + k] = c + (p1 if c >= 0 else m1)
                                pos += 1
                            k += 1
                        eobrun -= 1
        if pos > 8 * len(segs[seg_i]) + 64:
            raise DecodeError("JPEG scan data ends early")


# jidctint.c: CONST_BITS 13, PASS1_BITS 2, the FIX_* constants
_IDCT_LIMIT = np.array([v + 128 if v < 128 else 255 if v < 512 else 0 if v < 896 else v - 896
                        for v in range(1024)], np.uint8)  # IDCT_range_limit, masked by 1023


def _idct_pass(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One 1-D pass of jpeg_idct_islow over `axis` of int64 blocks."""
    c = [np.take(x, k, axis) for k in range(8)]
    z1 = (c[2] + c[6]) * 4433
    tmp2 = z1 - c[6] * 15137
    tmp3 = z1 + c[2] * 6270
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + r) >> shift for o in out], axis)


def _component_plane(frame: _Frame, c: int) -> np.ndarray:
    """Component c's samples, (ch, cw) int32: dequantised, ISLOW IDCT."""
    bx, by = frame.bx[c], frame.by[c]
    zz = np.asarray(frame.coefs[c], np.int64).reshape(-1, 64)
    nat = np.empty_like(zz)
    nat[:, JPEG_ZIGZAG] = zz
    z = (nat * frame.quant[c].astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_pass(z, 1, 13 - 2)  # columns, then rows
    px = _IDCT_LIMIT[_idct_pass(ws, 2, 13 + 2 + 3) & 1023]
    plane = px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
    return plane[:frame.ch[c], :frame.cw[c]].astype(np.int32)


def _upsample(x: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """jdsample.c: h2v1 / h1v2 / h2v2 "fancy" (triangle) upsampling with the
    edges replicated, plain replication for other integer factors and for
    planes of 2 samples or fewer across (as libjpeg chooses)."""
    w = x.shape[1]
    if (fx, fy) == (1, 2) or ((fx, fy) in ((2, 1), (2, 2)) and w > 2):
        if fy == 2:  # the nearer row 3/4, the farther 1/4
            up = np.concatenate([x[:1], x[:-1]])
            down = np.concatenate([x[1:], x[-1:]])
            if fx == 1:
                out = np.empty((2 * x.shape[0], w), np.int32)
                out[0::2] = (3 * x + up + 1) >> 2
                out[1::2] = (3 * x + down + 2) >> 2
                return out
            sums = np.empty((2 * x.shape[0], w), np.int32)
            sums[0::2] = 3 * x + up
            sums[1::2] = 3 * x + down
            x, bias = sums, (8, 7, 4)
        else:
            bias = (1, 2, 2)
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((x.shape[0], 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + bias[0]) >> bias[2]
        out[:, 1::2] = (3 * x + right + bias[1]) >> bias[2]
        return out
    return np.repeat(np.repeat(x, fy, 0), fx, 1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: SCALEBITS 16, FIX(x) rounded."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb - 46802 * cr + 32768) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(data: bytes, layers: tuple = (1, 3, 4)) -> tuple[_Frame, bool, int | None]:
    """Parse a JPEG and entropy-decode every scan: (the frame, with its
    coefficient stores or, lossless, its samples; whether a JFIF marker was
    seen; the Adobe transform, None without an Adobe marker)."""
    if not data.startswith(b"\xff\xd8"):
        raise DecodeError("not a JPEG image")
    pos = 2
    frame = None
    qt: dict[int, np.ndarray] = {}
    dht: dict[tuple[int, int], list[int]] = {}
    cond: dict = {}  # DAC: ("dc", t) -> (L, U), ("ac", t) -> Kx
    restart = 0
    jfif, adobe = False, None
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # garbage between segments, as libjpeg skips it
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise DecodeError("JPEG without EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue  # parameterless markers
        if pos + 2 > len(data):
            raise DecodeError("truncated JPEG segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise DecodeError("truncated JPEG segment")
        pos += length
        if marker in _JPEG_SOF or marker in _JPEG_UNSUPPORTED_SOF:
            if frame is not None:
                raise DecodeError("JPEG with two frames")
            frame = _Frame(body, _JPEG_SOF.get(marker, (False, False, False)), layers)
            if marker in _JPEG_UNSUPPORTED_SOF:  # PIL opens it; libjpeg-turbo fails the load
                raise DecodeError(f"{_JPEG_UNSUPPORTED_SOF[marker]} JPEG: broken data stream")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                nat = np.empty(64, np.int64)
                nat[JPEG_ZIGZAG] = vals
                qt[tq] = nat
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc_th = body[i]
                bits = body[i + 1:i + 17]
                n = sum(bits)
                dht[(tc_th >> 4, tc_th & 15)] = _huffman_lut(bits, body[i + 17:i + 17 + n])
                i += 17 + n
        elif marker == 0xCC:
            for i in range(0, len(body) - 1, 2):
                t, val = body[i], body[i + 1]
                if t >= 32:
                    raise DecodeError("corrupt JPEG DAC table index")
                if t >= 16:
                    cond[("ac", t - 16)] = val
                else:
                    if val & 15 > val >> 4:
                        raise DecodeError("corrupt JPEG DAC conditioning")
                    cond[("dc", t)] = (val & 15, val >> 4)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise DecodeError("JPEG scan before its frame")
            ns = body[0]
            comps, tables = [], []
            for j in range(ns):
                cid, sel = body[1 + 2 * j], body[2 + 2 * j]
                if cid not in frame.ids:
                    raise DecodeError(f"JPEG scan names no component {cid}")
                c = frame.ids.index(cid)
                comps.append(c)
                tables.append((sel >> 4, sel & 15))
                if frame.quant[c] is None and not frame.lossless:  # latched at its first scan
                    if frame.tq[c] not in qt:
                        raise DecodeError("JPEG component without a quantisation table")
                    frame.quant[c] = qt[frame.tq[c]]
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            segs, pos = _entropy_segments(data, pos)
            if frame.lossless:
                luts = [dht.get((0, t)) for t, _ in tables]
                if None in luts:
                    raise DecodeError("JPEG scan without its Huffman table")
                jpeg_lossless.decode_scan(frame, comps, luts, ss, al, segs, restart, _bit_windows, _receive)
                continue
            if not frame.progressive:
                ss, se, ah, al = 0, 63, 0, 0
            elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and ns != 1):
                raise DecodeError("corrupt JPEG progressive scan parameters")
            if frame.arithmetic:
                jpeg_arith.decode_scan(frame, comps, [t for t, _ in tables], [t for _, t in tables],
                                       ss, se, ah, al, segs, restart, cond)
                continue
            dc_luts = [dht.get((0, t)) for t, _ in tables]
            ac_luts = [dht.get((1, t)) for _, t in tables]
            if (ss == 0 and ah == 0 and None in dc_luts) or (se > 0 and None in ac_luts):
                raise DecodeError("JPEG scan without its Huffman table")
            _decode_scan(frame, comps, dc_luts, ac_luts, ss, se, ah, al, segs, restart)
    if frame is None:
        raise DecodeError("JPEG without a frame")
    if frame.lossless:
        if any(p is None for p in frame.samples):
            raise DecodeError("JPEG component without a scan")
    elif any(q is None for q in frame.quant):
        raise DecodeError("JPEG component without a scan")
    return frame, jfif, adobe


def decode_jpeg(data: bytes, colour: str | None = None, layers: tuple = (1, 3, 4)) -> np.ndarray:
    """JPEG bytes -> (H, W, C) uint8 in the colour space libjpeg converts
    the file to for PIL: C = 1 (grey), 3 (RGB, from YCbCr unless the file is
    RGB) or 4 (CMYK, from YCCK where an Adobe marker says so). Huffman or
    arithmetic coding, baseline, extended sequential and progressive, and
    8-bit lossless (no colour conversion: libjpeg-turbo refuses one); any
    integral sampling factors; restart intervals. 12-bit and other
    precisions raise NotThisFormat (no format PIL reads); hierarchical and
    arithmetic lossless frames raise DecodeError, as libjpeg-turbo fails
    them. `colour` overrides libjpeg's colour-space guess as libtiff does
    for a JPEG-compressed TIFF: "ycc" converts YCbCr to RGB, "raw" keeps
    the components as they are; `layers` are the component counts taken
    (a TIFF's grey + alpha stream has two)."""
    frame, jfif, adobe = read_jpeg(data, layers)
    n = len(frame.ids)
    planes = []
    for c in range(n):
        if frame.hmax % frame.h[c] or frame.vmax % frame.v[c]:
            raise DecodeError("JPEG with a non-integral sampling ratio: libjpeg-turbo does not decode it")
        fx, fy = frame.hmax // frame.h[c], frame.vmax // frame.v[c]
        if frame.lossless:  # no IDCT; libjpeg-turbo never upsamples fancily here
            p = np.repeat(np.repeat(frame.samples[c].astype(np.int32), fy, 0), fx, 1)
        else:
            p = _upsample(_component_plane(frame, c), fx, fy)
        planes.append(p[:frame.height, :frame.width])
    if n == 1:
        return planes[0].astype(np.uint8)[..., None]
    # libjpeg's colour-space guess (jdapimin.c default_decompress_parms)
    if colour is not None:
        ycc = colour == "ycc"
    elif n == 3:
        if jfif:
            ycc = True
        elif adobe is not None:
            ycc = adobe != 0
        else:  # the component ids: "RGB" is RGB, anything else YCbCr (RGB if lossless)
            ycc = tuple(frame.ids) != (82, 71, 66) and not frame.lossless
    else:
        ycc = adobe is not None and adobe != 0  # YCCK; CMYK without an Adobe marker
    if ycc and frame.lossless:
        raise DecodeError("lossless JPEG with a colour transform: libjpeg-turbo cannot convert it")
    if n == 3:
        return _ycc_to_rgb(*planes) if ycc else np.stack(planes, -1).astype(np.uint8)
    if ycc:  # jdcolor.c ycck_cmyk_convert: 255 - the YCbCr -> RGB result, K as it is
        cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int32)
        return np.concatenate([cmy, planes[3][..., None]], -1).astype(np.uint8)
    return np.stack(planes, -1).astype(np.uint8)


def rgb8_from_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, as PIL's convert("RGB") gives it: grey
    replicated; CMYK read inverted (PIL's CMYK;I) and converted as PIL's
    cmyk2rgb converts it."""
    px = decode_jpeg(data)
    if px.shape[-1] == 1:
        return np.repeat(px, 3, axis=-1)
    if px.shape[-1] == 4:
        return cmyk_rgb(255 - px)
    return px


# ---- Radiance .hdr (RGBE) ---------------------------------------------------

def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr -> (H, W, 3) float32 linear (stbi_loadf equivalent).

    Supports the common '-Y H +X W' orientation with new-style RLE scanlines.
    """
    with open(path, "rb") as f:
        data = f.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    header_end = data.index(b"\n\n") + 2
    nl = data.index(b"\n", header_end)
    res_line = data[header_end:nl].decode("ascii").split()
    pos = nl + 1
    if len(res_line) != 4 or res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {' '.join(res_line)}")
    h, w = int(res_line[1]), int(res_line[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    idx = 0
    for y in range(h):
        # new-style RLE scanline: 0x02 0x02 hi lo (hi/lo must encode the
        # width — a flat pixel can also start with 0x02 0x02)
        if (
            w >= 8
            and w < 32768
            and raw[idx] == 2
            and raw[idx + 1] == 2
            and (int(raw[idx + 2]) << 8 | int(raw[idx + 3])) == w
        ):
            idx += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(raw[idx])
                    idx += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = raw[idx]
                        idx += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = raw[idx : idx + count]
                        idx += count
                        x += count
        else:  # flat scanline
            rgbe[y] = raw[idx : idx + 4 * w].reshape(w, 4)
            idx += 4 * w

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 2^(e-128)/256
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] == 0, 0.0, 1.0
    )


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W, 4) RGBE bytes (shared-exponent encode)."""
    m = img.max(axis=-1)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    mant, exp = np.frexp(np.maximum(m, 0.0))
    valid = m > 1e-32
    s = np.where(valid, mant * 256.0 / np.maximum(m, 1e-32), 0.0)
    out[..., 0] = np.clip(img[..., 0] * s, 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(img[..., 1] * s, 0, 255).astype(np.uint8)
    out[..., 2] = np.clip(img[..., 2] * s, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    return out


def save_hdr(path: str, img: np.ndarray) -> None:
    """(H, W, 3) float32 -> uncompressed Radiance .hdr."""
    h, w = img.shape[:2]
    rgbe = float_to_rgbe(np.asarray(img, np.float32))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---- PFM (the reference's BSDFTest output format) ---------------------------

def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(img[::-1].tobytes())


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if kind == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, -1)[::-1]
    return img.squeeze()
