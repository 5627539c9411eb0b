"""VP8L, WebP's lossless bitstream, as the WebP lossless specification
(and libwebp's vp8l_dec.c) decodes it: ARGB pixels.

The four transforms (predictor with its 14 modes, cross colour, subtract
green, colour indexing with pixel packing), the colour cache, LZ77 copies
with the 120-entry distance map, and the meta prefix codes (an entropy
image choosing one group of five prefix codes per block). The entropy
decoding is a sequential host loop over 64-bit windows of the stream (LSB
first, the prefix codes read through lookup tables of their longest code);
the transforms but the predictor are numpy over the image, the predictor
a row loop (each pixel may predict from the one before it)."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError
from .vp8_tables import CODE_TO_PLANE

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABET = (256, 256, 256, 40)  # red, blue, alpha, distance; green is 256 + 24 + cache size


class _Bits:
    """LSB-first bit reader over 64-bit little-endian windows."""

    def __init__(self, data: bytes):
        n = len(data) + 8
        b = np.frombuffer(data + bytes(16), np.uint8).astype(np.uint64)
        win = np.zeros(n, np.uint64)
        for i in range(8):
            win |= b[i:i + n] << np.uint64(8 * i)
        self.win = win.tolist()
        self.pos = 0
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if self.pos > self.end + 64:
            raise DecodeError("truncated VP8L data")
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)


class _Code:
    """A canonical prefix code: `lut[peek(bits)]` = (length << 16) | symbol;
    a code with one used symbol reads no bits."""

    def __init__(self, lengths: list[int]):
        used = [s for s, n in enumerate(lengths) if n]
        if not used:
            raise DecodeError("VP8L prefix code without symbols")
        if len(used) == 1:
            self.bits, self.lut = 0, [used[0]]
            return
        self.bits = max(lengths)
        counts = [0] * (self.bits + 1)
        for n in lengths:
            counts[n] += 1
        counts[0] = 0
        nxt, code = [0] * (self.bits + 2), 0
        for n in range(1, self.bits + 1):
            code = (code + counts[n - 1]) << 1
            nxt[n] = code
        if sum(c << (self.bits - n) for n, c in enumerate(counts) if n) != 1 << self.bits:
            raise DecodeError("VP8L prefix code not complete")
        lut = np.zeros(1 << self.bits, np.int64)
        for s in used:
            n = lengths[s]
            c = nxt[n]
            nxt[n] += 1
            rev = int(f"{c:0{n}b}"[::-1], 2)  # the stream gives the code's first bit first
            lut[rev::1 << n] = n << 16 | s
        self.lut = lut.tolist()

    def read(self, br: _Bits) -> int:
        if not self.bits:
            return self.lut[0]
        p = br.pos
        e = self.lut[(br.win[p >> 3] >> (p & 7)) & ((1 << self.bits) - 1)]
        br.pos = p + (e >> 16)
        return e & 0xFFFF


def _read_code(br: _Bits, size: int) -> _Code:
    lengths = [0] * size
    if br.read(1):  # simple: one or two symbols
        n = br.read(1) + 1
        first = br.read(1 + 7 * br.read(1))
        lengths[first] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _Code(lengths)
    cl = [0] * 19
    for i in range(4 + br.read(4)):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    lc = _Code(cl)
    max_symbol = size
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise DecodeError("VP8L code length count past the alphabet")
    prev, s = 8, 0
    while s < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        n = lc.read(br)
        if n < 16:
            lengths[s] = n
            s += 1
            if n:
                prev = n
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
        rep = br.read(extra) + offset
        if s + rep > size:
            raise DecodeError("VP8L code lengths past the alphabet")
        v = prev if n == 16 else 0
        lengths[s:s + rep] = [v] * rep
        s += rep
    return _Code(lengths)


def _copy_length(br: _Bits, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_pixels(br: _Bits, width: int, height: int, level0: bool) -> np.ndarray:
    """One entropy-coded image -> (height, width) uint32 ARGB."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise DecodeError(f"VP8L colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw, mh = -(-width // (1 << meta_bits)), -(-height // (1 << meta_bits))
        meta = ((_decode_pixels(br, mw, mh, False) >> 8) & 0xFFFF).astype(np.int64)
        n_groups = int(meta.max()) + 1
        meta = meta.tolist()
    else:
        n_groups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, 256 + 24 + cache_size)] + [_read_code(br, n) for n in _ALPHABET])
    n = width * height
    out = [0] * n
    cache = [0] * cache_size
    shift = 32 - cache_bits
    last_cached = 0
    pos = 0
    g = groups[0]
    while pos < n:
        if meta is not None:
            y, x = divmod(pos, width)
            g = groups[meta[y >> meta_bits][x >> meta_bits]]
        code = g[0].read(br)
        if code < 256:
            red = g[1].read(br)
            blue = g[2].read(br)
            alpha = g[3].read(br)
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
        elif code < 280:
            length = _copy_length(br, code - 256)
            dsym = g[4].read(br)
            dcode = _copy_length(br, dsym)
            if dcode > 120:
                dist = dcode - 120
            else:
                p = CODE_TO_PLANE[dcode - 1]
                dist = max(1, (p >> 4) * width + 8 - (p & 15))
            if dist > pos or pos + length > n:
                raise DecodeError("VP8L backward reference out of the image")
            for i in range(pos, pos + length):
                out[i] = out[i - dist]
            pos += length
        elif cache_size:
            ci = code - 280
            if ci >= cache_size:
                raise DecodeError("VP8L colour cache index past the cache")
            while last_cached < pos:  # every pixel so far enters the cache in order
                v = out[last_cached]
                cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> shift] = v
                last_cached += 1
            out[pos] = cache[ci]
            pos += 1
        else:
            raise DecodeError("VP8L colour cache code without a cache")
        if cache_size and code < 280:
            while last_cached < pos:
                v = out[last_cached]
                cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> shift] = v
                last_cached += 1
    if br.pos > br.end:
        raise DecodeError("truncated VP8L data")
    return np.array(out, np.uint32).reshape(height, width)


def _channels(px: np.ndarray) -> np.ndarray:
    """(..., ) uint32 ARGB -> (..., 4) int64 A, R, G, B."""
    p = px.astype(np.int64)
    return np.stack([(p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255], -1)


def _pack(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.uint32) & 255
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def _avg(a, b):
    return [(x + y) >> 1 for x, y in zip(a, b)]


def _predict(mode, L, T, TR, TL):
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:  # the one of L and T nearer to L + T - TL
        pa = sum(abs(l_ - tl) - abs(t - tl) for l_, t, tl in zip(L, T, TL))
        return L if pa > 0 else T
    if mode == 12:
        return [min(255, max(0, l_ + t - tl)) for l_, t, tl in zip(L, T, TL)]
    if mode == 13:
        a = _avg(L, T)
        return [min(255, max(0, x + int((x - tl) / 2))) for x, tl in zip(a, TL)]
    return [255, 0, 0, 0]  # 0, and 14 / 15: opaque black


def _inverse_predictor(c: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    """Residuals (h, w, 4) -> pixels, in raster order."""
    h, w, _ = c.shape
    out = c.copy()
    out[0, 0, 0] += 255  # the first pixel predicts opaque black, the rest of its row from the left
    out[0] = np.cumsum(out[0], axis=0) & 255
    rows = out.tolist()
    res = c.tolist()
    mode_rows = modes.tolist()
    for y in range(1, h):
        up, cur, r = rows[y - 1], rows[y], res[y]
        cur[0] = [(a + b) & 255 for a, b in zip(r[0], up[0])]  # the first column predicts from above
        mrow = mode_rows[y >> bits]
        for x in range(1, w):
            tr = up[x + 1] if x + 1 < w else cur[0]
            p = _predict(mrow[x >> bits], cur[x - 1], up[x], tr, up[x - 1])
            cur[x] = [(a + b) & 255 for a, b in zip(r[x], p)]
    return np.array(rows, np.int64)


def _inverse_cross_colour(c: np.ndarray, bits: int, t: np.ndarray) -> np.ndarray:
    h, w, _ = c.shape
    tc = _channels(t)
    ys, xs = np.arange(h) >> bits, np.arange(w) >> bits
    e = tc[ys][:, xs]  # (h, w, 4): red_to_blue in red, green_to_blue in green, green_to_red in blue

    def s8(v):
        return ((v + 128) & 255) - 128

    def delta(t_, v):
        return (s8(t_) * s8(v)) >> 5

    g = c[..., 2]
    red = (c[..., 1] + delta(e[..., 3], g)) & 255
    blue = (c[..., 3] + delta(e[..., 2], g) + delta(e[..., 1], red)) & 255
    return np.stack([c[..., 0], red, g, blue], -1)


def decode(data: bytes) -> np.ndarray:
    """A VP8L bitstream -> (H, W, 4) uint8 RGBA."""
    if len(data) < 5 or data[0] != 0x2F:
        raise DecodeError("not a VP8L bitstream")
    br = _Bits(data)
    br.read(8)
    width, height = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha_is_used: a hint only
    if br.read(3) != 0:
        raise DecodeError("VP8L version is not 0")
    transforms = []
    xsize = width
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise DecodeError("VP8L transform used twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_pixels(br, -(-xsize // (1 << bits)), -(-height // (1 << bits)), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 2:
            transforms.append((2, 0, None, xsize))
        else:
            n = br.read(8) + 1
            xbits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _channels(_decode_pixels(br, n, 1, False)[0])
            pal = np.cumsum(pal, axis=0) & 255  # the colour map is delta coded
            full = np.zeros((1 << (8 >> xbits), 4), np.int64)  # indices past it read transparent black
            full[:n] = pal
            transforms.append((3, xbits, full, xsize))
            xsize = -(-xsize // (1 << xbits))
    c = _channels(_decode_pixels(br, xsize, height, True))
    for kind, bits, extra, xs in reversed(transforms):
        if kind == 0:
            c = _inverse_predictor(c, bits, (_channels(extra)[..., 2] & 15))
        elif kind == 1:
            c = _inverse_cross_colour(c, bits, extra)
        elif kind == 2:
            c = np.stack([c[..., 0], (c[..., 1] + c[..., 2]) & 255, c[..., 2], (c[..., 3] + c[..., 2]) & 255], -1)
        else:
            per = 1 << bits
            bpp = 8 >> bits
            x = np.arange(xs)
            packed = c[:, x >> bits, 2]
            idx = (packed >> (bpp * (x & (per - 1)))) & ((1 << bpp) - 1)
            c = extra[idx]
    return np.ascontiguousarray(c[..., [1, 2, 3, 0]].astype(np.uint8))
