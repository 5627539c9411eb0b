"""Image IO: PNG read-write, the Radiance .hdr loader and PFM (port of
optixpathtracer_tpu/io/image.py).

The reference decodes and encodes PNG through PIL. The port has its own
PNG codec written with `zlib` and `struct`, so it needs no image library:
8-bit, non-interlaced, colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA), all five scanline filters. `read_rgb8`
gives the uint8 values PIL's `Image.open(...).convert("RGB")` gives for
those files: grey is replicated, palettes are looked up and alpha is
dropped. Interlaced PNGs, other bit depths and JPEG decoding raise
NotImplementedError naming ROADMAP A.1; they never decode to something
else. The Radiance RGBE and PFM code is the reference's numpy.

`encode_jpeg` is the port's own baseline JPEG encoder (the reference's
viewer encodes with PIL): JFIF, the Annex K quantisation tables scaled by
quality with the IJG formula, 4:2:0 chroma, the standard Huffman tables.
The colour transform, DCT and quantisation are tensor ops on the frame's
own device; the entropy coding is vectorised numpy. The tables and the
zigzag order live here once, for a decoder to reuse.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

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
            raise ValueError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length  # length, type, body, CRC
    raise ValueError("PNG without IEND")


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
        raise ValueError("PNG image data too short")
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
            raise ValueError(f"unknown PNG filter type {kind}")
    return out[1:]


def decode_png(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None]:
    """PNG bytes -> (samples (H, W, C) uint8, colour type, palette (256, 3)
    uint8 or None)."""
    if data.startswith(_JPEG_MAGIC):
        raise NotImplementedError("JPEG decoding is not ported (ROADMAP A.1)")
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG image")
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
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _compression, _filter, interlace = header
    if interlace:
        raise NotImplementedError("interlaced PNG decoding is not ported (ROADMAP A.1)")
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNG decoding is not ported (ROADMAP A.1)")
    if color not in _CHANNELS:
        raise ValueError(f"invalid PNG colour type {color}")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    rows = _unfilter(raw, height, width * ch, ch)
    return rows.reshape(height, width, ch), color, palette


def rgb8_from_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's convert("RGB") gives it."""
    px, color, palette = decode_png(data)
    if color == 3:
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_rgb8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return rgb8_from_png(f.read())


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
