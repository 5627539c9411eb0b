"""Encoders the codec tests write their inputs with, where PIL writes no
such file: arithmetic-coded JPEG (a QM coder after T.81 Annex D, the
statistics of Annexes F and G), lossless JPEG, GIF LZW with clear codes,
TGA, BMP (every header, bit depth and compression) and the container
headers of DDS, PSD, QOI, SGI, PCX and ICO. Each is written from the
format's specification, independently of the port's decoders; PIL's decode
of what they write is the oracle."""
from __future__ import annotations

import struct

import numpy as np

from optixpathtracer_tpu.io import image as jimg
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io.codecs import jpeg_arith


def pil_rgb(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_like_pil(data: bytes, tmp_path=None, name: str = "image") -> np.ndarray:
    """The port's decode equals PIL's convert("RGB") bit for bit; given a
    directory, the file's `load_image` equals the JAX package's too."""
    want = pil_rgb(data)
    got = timg.rgb8_from_bytes(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if tmp_path is not None:
        path = tmp_path / name
        path.write_bytes(data)
        np.testing.assert_array_equal(timg.load_image(str(path)), jimg.load_image(str(path)))
    return got


def assert_fails_like_pil(data: bytes) -> None:
    """PIL cannot read it: the port raises an OSError (and no A.1)."""
    import pytest

    with pytest.raises(Exception) as pil_error:
        pil_rgb(data)
    with pytest.raises(OSError) as port_error:
        timg.rgb8_from_bytes(data)
    assert not isinstance(port_error.value, NotImplementedError), (pil_error.value, port_error.value)


def assert_as_pil(data: bytes, tmp_path=None, name: str = "image") -> bool:
    """assert_like_pil where PIL reads the data, else assert_fails_like_pil;
    whether PIL read it."""
    try:
        pil_rgb(data)
    except Exception:  # noqa: BLE001 -- PIL's own failure is the case under test
        assert_fails_like_pil(data)
        return False
    assert_like_pil(data, tmp_path, name)
    return True


def photo(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Smooth gradients with noise and a flat band: every coder path in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(x / 5.0 - y / 3.0),
                    (x * 3 + y * 5) % 256, 200 - x % 50], -1)[..., :channels] + rng.normal(0, 18, (h, w, channels))
    img[:, : w // 4] = img[:, :1]
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_bytes(img, fmt: str, mode: str | None = None, **kw) -> bytes:
    import io

    from PIL import Image

    im = img if hasattr(img, "save") else Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()

# ---- arithmetic-coded JPEG ------------------------------------------------------


class QMEncoder:
    """T.81 D.1 (libjpeg's jcarith.c layout of the C register)."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def _emit(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _flush_zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def encode(self, st: list, i: int, val: int) -> None:
        sv = st[i]
        s = sv & 0x7F
        qe = jpeg_arith.QE[s]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ jpeg_arith.NLPS[s]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ jpeg_arith.NMPS[s]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self.out += b"\xff\x00"
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self.out += b"\xff\x00"
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _encode_value(enc: QMEncoder, st: list, i: int, v: int, k: int, kx: int, dc: bool) -> int:
    """Figures F.8 / F.9 for |v| - 1 = v (v >= 0 here): the category
    decisions from bin i, then the magnitude bits; returns the category m."""
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v
        if dc:
            i = 20
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    mm = m >> 1
    while mm:
        enc.encode(st, i, 1 if mm & v else 0)
        mm >>= 1
    return m


def _pt(v: int, al: int) -> int:
    """The point transform of an AC coefficient: divide, rounding to 0."""
    return v >> al if v >= 0 else -((-v) >> al)


def arith_scan(blocks, comp_of, ss, se, ah, al, progressive, lower=0, upper=1, kx=5) -> bytes:
    """One scan's arithmetic-coded bytes (one restart interval): `blocks`
    the scan's blocks in order (64 zigzag coefficients each), comp_of[b]
    the index of block b's component within the scan (its own DC / AC
    statistics: one conditioning table per scan component)."""
    enc = QMEncoder()
    n = max(comp_of) + 1
    dc_st = [[0] * 64 for _ in range(n)]
    ac_st = [[0] * 256 for _ in range(n)]
    fixed = [jpeg_arith.FIXED]
    last = [0] * n
    ctx = [0] * n
    for blk, ci in zip(blocks, comp_of):
        if ss == 0 and ah == 0:
            m = blk[0] >> al if progressive else blk[0]
            st = dc_st[ci]
            v = m - last[ci]
            if v == 0:
                enc.encode(st, ctx[ci], 0)
                ctx[ci] = 0
            else:
                last[ci] = m
                enc.encode(st, ctx[ci], 1)
                sign = v < 0
                enc.encode(st, ctx[ci] + 1, int(sign))
                i = ctx[ci] + 2 + sign
                cat = _encode_value(enc, st, i, abs(v) - 1, 0, 0, True)
                if cat < (1 << lower) >> 1:
                    ctx[ci] = 0
                elif cat > (1 << upper) >> 1:
                    ctx[ci] = 12 + 4 * sign
                else:
                    ctx[ci] = 4 + 4 * sign
            if progressive:
                continue
        elif ss == 0:  # DC refine
            enc.encode(fixed, 0, (blk[0] >> al) & 1)
            continue
        st = ac_st[ci]
        k0, k1 = (1, 63) if not progressive else (ss, se)
        shift = al if progressive else 0
        vals = [_pt(blk[k], shift) for k in range(64)]
        ke = k1
        while ke > 0 and ke >= k0 and not vals[ke]:
            ke -= 1
        if progressive and ah:  # AC refine
            kex = ke
            while kex > 0 and not _pt(blk[kex], ah):
                kex -= 1
            k = k0
            while k <= ke:
                i = 3 * (k - 1)
                if k > kex:
                    enc.encode(st, i, 0)
                while True:
                    v = vals[k]
                    if v:
                        if abs(v) >> 1:
                            enc.encode(st, i + 2, abs(v) & 1)
                        else:
                            enc.encode(st, i + 1, 1)
                            enc.encode(fixed, 0, int(v < 0))
                        break
                    enc.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                k += 1
        else:
            k = k0
            while k <= ke:
                i = 3 * (k - 1)
                enc.encode(st, i, 0)
                while not vals[k]:
                    enc.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                enc.encode(st, i + 1, 1)
                v = vals[k]
                enc.encode(fixed, 0, int(v < 0))
                _encode_value(enc, st, i + 2, abs(v) - 1, k, kx, False)
                k += 1
        if k <= k1:
            enc.encode(st, 3 * (k - 1), 1)
    return enc.finish()


def arith_jpeg(data: bytes, progressive: bool = False, restart_mcus: int = 0, dac=None,
               adobe: int | None = None, keep_app: bool = True) -> bytes:
    """A Huffman JPEG's quantised coefficients re-encoded with arithmetic
    coding (SOF9, or SOF10 with a successive-approximation script), the
    same quantisation tables and sampling; `dac`: (L, U, Kx) for every
    table, written as a DAC segment; restart intervals of `restart_mcus`
    MCUs (interleaved scans) or blocks."""
    frame, jfif, adobe0 = timg.read_jpeg(data)
    n = len(frame.ids)
    sof = struct.pack(">BHHB", 8, frame.height, frame.width, n) + b"".join(
        bytes([frame.ids[c], frame.h[c] << 4 | frame.v[c], c]) for c in range(n))
    out = b"\xff\xd8"
    if keep_app and jfif:
        out += timg._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    a = adobe if adobe is not None else (adobe0 if keep_app else None)
    if a is not None:
        out += timg._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, a]))
    out += timg._segment(0xDB, b"".join(bytes([c]) + b for c, b in
                                        ((c, frame.quant[c][timg.JPEG_ZIGZAG].astype(np.uint8).tobytes())
                                         for c in range(n))))
    out += timg._segment(0xCA if progressive else 0xC9, sof)
    lower, upper, kx = dac or (0, 1, 5)
    if dac:
        out += timg._segment(0xCC, b"".join(bytes([t, upper << 4 | lower, 16 + t, kx]) for t in range(min(n, 4))))
    if restart_mcus:
        out += timg._segment(0xDD, struct.pack(">H", restart_mcus))
    if progressive:  # every pass kind: DC first / refine, AC first / refine
        every = list(range(n))
        script = ([(every, 0, 0, 0, 1)] + [([c], 1, 5, 0, 2) for c in every]
                  + [([c], 6, 63, 0, 1) for c in every] + [([c], 1, 5, 2, 1) for c in every]
                  + [(every, 0, 0, 1, 0)] + [([c], 1, 63, 1, 0) for c in every])
    else:
        script = [(list(range(n)), 0, 63, 0, 0)]
    for comps, ss, se, ah, al in script:
        mcus = frame.scan_mcus(comps)
        sos = bytes([len(comps)]) + b"".join(bytes([frame.ids[c], (c % 4) << 4 | (c % 4)]) for c in comps)
        sos += bytes([ss, se, ah << 4 | al])
        out += timg._segment(0xDA, sos)
        per = restart_mcus or len(mcus)
        for r, start in enumerate(range(0, len(mcus), per)):
            blocks, comp_of = [], []
            for mcu in mcus[start:start + per]:
                for ci, base in mcu:
                    blocks.append(frame.coefs[comps[ci]][base:base + 64])
                    comp_of.append(ci)
            out += arith_scan(blocks, [comps[ci] % 4 for ci in comp_of], ss, se, ah, al, progressive,
                              lower, upper, kx)
            if start + per < len(mcus):
                out += bytes([0xFF, 0xD0 + r % 8])
    return out + b"\xff\xd9"


# ---- LZW ----------------------------------------------------------------------


def lzw_encode(data: bytes, min_size: int, msb: bool, early: bool, clear_every: int = 0) -> bytes:
    """LZW codes for `data`: GIF (LSB first, min_size, no early change) or
    TIFF (MSB first, 8, early change); a clear code first, then every
    `clear_every` codes (0: only when the table fills), an end code last."""
    clear = 1 << min_size
    end = clear + 1

    def reset():
        return {bytes([i]): i for i in range(clear)}, min_size + 1

    table, size = reset()
    codes = [(clear, size)]
    w = b""
    count = 0
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], size))
        count += 1
        nxt = len(table) + 2  # the clear and end codes
        if nxt < 4094:
            table[wc] = nxt
            if nxt + 1 + (1 if early else 0) > (1 << size) and size < 12:
                size += 1
        w = bytes([b])
        if (clear_every and count % clear_every == 0) or len(table) + 2 >= 4094:
            codes.append((table[w], size))
            w = b""
            codes.append((clear, size))
            table, size = reset()
    if w:
        codes.append((table[w], size))
    codes.append((end, size))
    out = bytearray()
    acc = nacc = 0
    for c, s in codes:
        if msb:
            acc = acc << s | c
            nacc += s
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
        else:
            acc |= c << nacc
            nacc += s
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if msb else acc & 0xFF)
    return bytes(out)


def gif_blocks(b: bytes) -> bytes:
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255] for i in range(0, len(b), 255)) + b"\0"


# ---- TIFF -----------------------------------------------------------------------


def packbits(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and (j + 1 >= len(data) or data[j] != data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_file(samples: np.ndarray, bits: int = 8, photometric: int = 2, order: str = "<",
              compression: int = 1, predictor: int = 1, planar: int = 1, rows_per_strip: int | None = None,
              tile: tuple[int, int] | None = None, extra: tuple = (), sample_format: int = 1,
              colormap: np.ndarray | None = None, fill_order: int = 1, big: bool = False,
              jpeg_chunks=None, jpeg_tables: bytes | None = None, extra_tags: dict | None = None) -> bytes:
    """A TIFF of (H, W, S) integer samples at `bits` per sample (MSB-first
    packing below 8, the byte order's words above), in strips or tiles,
    planar configuration 1 or 2, compressed with none (1), LZW (5),
    Deflate (8), PackBits (32773) or, given `jpeg_chunks` (one JPEG stream
    per strip or tile), JPEG (7); horizontal differencing when predictor 2;
    each stored byte's bits reversed for fill order 2."""
    import zlib

    h, w, spp = samples.shape
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    if tile:
        tw, th = tile
        grid = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        th = rows_per_strip or h
        tw = w
        grid = [(0, y) for y in range(0, h, th)]
    kind = {1: "u", 2: "i", 3: "f"}[sample_format]

    def chunk_bytes(px: np.ndarray) -> bytes:
        """(rows, cols, n) samples -> the chunk's rows of bytes."""
        rows, cols, n = px.shape
        if bits < 8:
            flat = px.reshape(rows, cols * n).astype(np.uint8)
            bitsarr = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(rows, -1)
            return np.packbits(bitsarr, axis=1).tobytes()
        dt = np.dtype(f"{kind}{bits // 8}").newbyteorder(order)
        v = px.astype(dt)
        if predictor == 2:
            u = v.view(np.dtype(f"u{bits // 8}").newbyteorder(order)).astype(np.int64)
            d = u.copy()
            d[:, 1:] = u[:, 1:] - u[:, :-1]
            v = (d % (1 << bits)).astype(np.dtype(f"u{bits // 8}").newbyteorder(order))
        return v.tobytes()

    chunks = []
    if jpeg_chunks is not None:
        chunks = list(jpeg_chunks)
    else:
        for plane in planes:
            for x, y in grid:
                px = plane[y:y + th, x:x + tw]
                if tile:  # tiles are whole: pad past the image's edge
                    px = np.pad(px, ((0, th - px.shape[0]), (0, tw - px.shape[1]), (0, 0)))
                raw = chunk_bytes(px)
                if compression == 5:
                    raw = lzw_encode(raw, 8, msb=True, early=True)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = packbits(raw)
                if fill_order == 2:  # the stored bytes, compressed or not, LSB first
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if extra:
        tags[338] = (3, list(extra))
    if sample_format != 1:
        tags[339] = (3, [sample_format] * spp)
    if colormap is not None:
        tags[320] = (3, [int(v) for v in colormap.T.reshape(-1)])
    if jpeg_tables is not None:
        tags[347] = (7, list(jpeg_tables))
    for k, v in (extra_tags or {}).items():
        tags[k] = v
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags[322], tags[323] = (3, [tw]), (3, [th])
    else:
        tags[278] = (3, [th])
    head = 16 if big else 8
    data = bytearray(head)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    tags[off_tag] = (16 if big else 4, offsets)
    tags[cnt_tag] = (16 if big else 4, [len(c) for c in chunks])
    fmt = {1: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
    size = {1: 1, 3: 2, 4: 4, 7: 1, 16: 8}
    inline = 8 if big else 4
    blobs = {}
    for tag, (typ, vals) in tags.items():
        raw = struct.pack(order + fmt[typ] * len(vals), *vals)
        if len(raw) > inline:
            blobs[tag] = len(data)
            data += raw + (b"\0" if len(raw) % 2 else b"")
    ifd_pos = len(data)
    entries = b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(order + fmt[typ] * len(vals), *vals)
        val = struct.pack(order + ("Q" if big else "I"), blobs[tag]) if tag in blobs else raw.ljust(inline, b"\0")
        entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, len(vals)) + val
    data += struct.pack(order + ("Q" if big else "H"), len(tags)) + entries + bytes(8 if big else 4)
    mark = b"II" if order == "<" else b"MM"
    if big:
        data[:16] = mark + struct.pack(order + "HHHQ", 43, 8, 0, ifd_pos)
    else:
        data[:8] = mark + struct.pack(order + "HI", 42, ifd_pos)
    return bytes(data)


# ---- the simpler containers ---------------------------------------------------------


def lossless_jpeg(img: np.ndarray, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  markers: bytes = b"") -> bytes:
    """An 8-bit lossless JPEG (SOF3, the Annex K luminance DC table for every
    component, no subsampling) of (H, W, C) samples; a restart every
    `restart_rows` rows."""
    h, w, nc = img.shape
    bits, vals = timg.JPEG_HUFFMAN["dc_luma"]
    code, length = timg._huffman_codes(bits, vals)
    x = img.astype(np.int64) >> pt
    out = []
    cur_v, cur_l = [], []
    for y in range(h):
        first_row = y == 0 or (restart_rows and y % restart_rows == 0)
        if restart_rows and y and y % restart_rows == 0:
            out.append(timg._pack_bits(np.array(cur_v, np.int64), np.array(cur_l, np.int64)))
            cur_v, cur_l = [], []
        for xx in range(w):
            for c in range(nc):
                if first_row:
                    p = (1 << (8 - pt - 1)) if xx == 0 else x[y, xx - 1, c]
                elif xx == 0:
                    p = x[y - 1, 0, c]
                else:
                    ra, rb, rc = x[y, xx - 1, c], x[y - 1, xx, c], x[y - 1, xx - 1, c]
                    p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                         6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                d = ((int(x[y, xx, c] - p) + 32768) % 65536) - 32768
                s = abs(d).bit_length()
                cur_v.append(int(code[s]))
                cur_l.append(int(length[s]))
                if s:
                    cur_v.append(d if d >= 0 else d + (1 << s) - 1)
                    cur_l.append(s)
    out.append(timg._pack_bits(np.array(cur_v, np.int64), np.array(cur_l, np.int64)))
    scan = b"".join(seg + (bytes([0xFF, 0xD0 + i % 8]) if i < len(out) - 1 else b"")
                    for i, seg in enumerate(out))
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(bytes([c + 1, 0x11, 0]) for c in range(nc))
    dht = bytes([0x00]) + bytes(bits) + bytes(vals)
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0x00]) for c in range(nc)) + bytes([predictor, 0, pt])
    dri = timg._segment(0xDD, struct.pack(">H", restart_rows * w)) if restart_rows else b""
    return (b"\xff\xd8" + markers + timg._segment(0xC3, sof) + timg._segment(0xC4, dht) + dri
            + timg._segment(0xDA, sos) + scan + b"\xff\xd9")


def tga_file(px: np.ndarray, kind: int, depth: int, cmap: np.ndarray | None = None, cmap_depth: int = 24,
             cmap_start: int = 0, origin: int = 0, image_id: bytes = b"", rng=None) -> bytes:
    """A TGA of `px` (raw pixel bytes (H, W * bytes)) of image type `kind`
    (RLE for 9-11, packets cut at random lengths, crossing rows), origin
    bits `origin` (0x20 top-down, 0x10 mirrored)."""
    h = px.shape[0]
    size = max(1, depth // 8)
    w = px.shape[1] // size if depth >= 8 else px.shape[1] * 8
    header = struct.pack("<BBBHHBHHHHBB", len(image_id), int(cmap is not None), kind, cmap_start,
                         0 if cmap is None else len(cmap), 0 if cmap is None else cmap_depth, 0, 0, w, h,
                         depth, origin)
    body = image_id + (b"" if cmap is None else cmap.tobytes())
    raw = px.tobytes()
    if kind & 8:
        rng = rng or np.random.default_rng(0)
        pix = [raw[i:i + size] for i in range(0, len(raw), size)]
        out, i = bytearray(), 0
        while i < len(pix):
            j = i
            while j < len(pix) and j - i < 128 and pix[j] == pix[i]:
                j += 1
            if j - i >= 2 or rng.random() < 0.2:
                out += bytes([0x80 | (j - i - 1)]) + pix[i]
                i = j
            else:
                n = min(len(pix) - i, int(rng.integers(1, 129)))
                out += bytes([n - 1]) + b"".join(pix[i:i + n])
                i += n
        raw = bytes(out)
    return header + body + raw


def bmp_file(px: bytes, width: int, height: int, bits: int, header_size: int = 40, compression: int = 0,
             palette: np.ndarray | None = None, masks=None, top_down: bool = False, colors: int = 0) -> bytes:
    """A BMP: file header, a DIB header of `header_size`, the palette
    (BGR0, or BGR under a 12-byte header), `px` as the pixel data."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header_size == 12 else b"\0") for r, g, b in palette)
    if header_size == 12:
        dib = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", header_size, width, -height if top_down else height, 1, bits,
                          compression, len(px), 2835, 2835, colors, 0)
        extra = b""
        if header_size >= 52:
            extra += struct.pack("<III", *(masks[:3] if masks else (0, 0, 0)))
        if header_size >= 56:
            extra += struct.pack("<I", masks[3] if masks and len(masks) > 3 else 0)
        dib += extra + bytes(header_size - len(dib) - len(extra))
        if compression == 3 and header_size == 40:
            dib += struct.pack("<III", *masks[:3])
    off = 14 + len(dib) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(px), 0, 0, off) + dib + pal + px


def bmp_rle(idx: np.ndarray, rle4: bool) -> bytes:
    """BI_RLE8 / BI_RLE4 of (H, W) indices, bottom row first: encoded runs,
    absolute runs (even lengths for RLE4, padded to 16 bits), end of line
    and end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            j = x
            while j < w and j - x < 255 and row[j] == row[x]:
                j += 1
            if j - x >= 3 or w - x < 4:
                n = j - x
                out += bytes([n, (row[x] << 4 | row[x]) if rle4 else row[x]])
                x = j
                continue
            n = min(w - x, 8) & ~1 if rle4 else min(w - x, 8)
            vals = row[x:x + n]
            lit = bytes((vals[i] << 4 | vals[i + 1]) for i in range(0, n, 2)) if rle4 else bytes(vals)
            out += bytes([0, n]) + lit + (b"\0" if len(lit) % 2 else b"")
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def gif_file(frame: np.ndarray, palette: np.ndarray, screen: tuple[int, int], at: tuple[int, int] = (0, 0),
             local: bool = False, interlace: bool = False, transparency: int | None = None,
             clear_every: int = 0, code_size: int | None = None) -> bytes:
    """A GIF89a: a logical screen, a global (or local) colour table of
    2^k entries, one frame of (h, w) indices at `at`."""
    bits = max(1, int(np.ceil(np.log2(len(palette)))))
    table = palette.astype(np.uint8).tobytes().ljust(3 << bits, b"\0")
    flags = 0x80 | (bits - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, 0 if local else flags, 0, 0) + (b"" if local else table)
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    h, w = frame.shape
    out += b"," + struct.pack("<HHHHB", at[0], at[1], w, h, (flags if local else 0) | (0x40 if interlace else 0))
    if local:
        out += table
    rows = frame
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = frame[order]
    code_size = code_size or max(2, bits)
    return out + bytes([code_size]) + gif_blocks(lzw_encode(rows.astype(np.uint8).tobytes(), code_size, msb=False,
                                                            early=False, clear_every=clear_every)) + b";"


def dds_file(width: int, height: int, body: bytes, fourcc: bytes = b"", dxgi: int | None = None,
             pf_flags: int = 4, bitcount: int = 0, masks=(0, 0, 0, 0)) -> bytes:
    """A DDS: the 124-byte header (a FourCC, or a DX10 header naming a DXGI
    format, or uncompressed bit masks), then the first mip level's bytes."""
    if dxgi is not None:
        fourcc = b"DX10"
    head = b"DDS " + struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 1) + bytes(44)
    head += struct.pack("<2I", 32, pf_flags) + fourcc.ljust(4, b"\0") + struct.pack("<5I", bitcount, *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def psd_file(planes: list, mode: int, bits: int = 8, compression: int = 0, palette: np.ndarray | None = None,
             extra_channels: int = 0) -> bytes:
    """A PSD (version 1) with one image resource, no layers and the
    composite: raw or PackBits with per-row byte counts; `planes` (H, row
    bytes) each."""
    h = planes[0].shape[0]
    w = planes[0].shape[1] * (8 if bits == 1 else 1)
    allp = list(planes) + [np.zeros_like(planes[0])] * extra_channels
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, len(allp), h, w, bits, mode)
    out += struct.pack(">I", 768) + palette.T.tobytes() if palette is not None else struct.pack(">I", 0)
    out += struct.pack(">I", 14) + b"8BIM" + struct.pack(">HBxI", 1000, 0, 2) + b"ab"
    out += struct.pack(">I", 0) + struct.pack(">H", compression)
    if compression == 0:
        return out + b"".join(p.tobytes() for p in allp)
    rows = [[packbits(r.tobytes()) for r in p] for p in allp]
    return out + b"".join(struct.pack(">H", len(r)) for p in rows for r in p) + b"".join(
        r for p in rows for r in p)


def sgi_rle(img: np.ndarray, bpc: int) -> bytes:
    """An RLE SGI of (H, W, Z) samples (16-bit big-endian words if bpc 2),
    rows bottom-up: literal runs and repeats."""
    h, w, z = img.shape
    head = struct.pack(">hBBHHHH", 474, 1, bpc, 3 if z > 1 else 2, w, h, z) + bytes(512 - 12)
    rows = []
    for c in range(z):
        for y in range(h):
            row = img[h - 1 - y, :, c]
            enc, i = bytearray(), 0
            while i < w:
                j = i
                while j < w and j - i < 127 and row[j] == row[i]:
                    j += 1
                if j - i >= 2:
                    enc += (bytes([0, j - i]) if bpc == 2 else bytes([j - i])) + (
                        row[i:i + 1].astype(">u2").tobytes() if bpc == 2 else row[i:i + 1].astype(np.uint8).tobytes())
                    i = j
                    continue
                n = min(w - i, 5)
                enc += (bytes([0, 0x80 | n]) if bpc == 2 else bytes([0x80 | n])) + (
                    row[i:i + n].astype(">u2").tobytes() if bpc == 2 else row[i:i + n].astype(np.uint8).tobytes())
                i += n
            rows.append(bytes(enc) + bytes(bpc))
    starts, off = [], 512 + 8 * len(rows)
    for r in rows:
        starts.append(off)
        off += len(r)
    return head + struct.pack(f">{len(rows)}I", *starts) + struct.pack(f">{len(rows)}I", *map(len, rows)) + b"".join(rows)


def cur_file(entries: list[tuple[int, int, int]], rng) -> bytes:
    """A CUR of (width, height, bits) BMP entries with random pixels."""
    bodies = []
    for w, h, bits in entries:
        body = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, 0, 0)
        if bits <= 8:
            body += bytes(rng.integers(0, 256, 4 << bits, dtype=np.uint8))
        stride = ((w * bits + 31) >> 3) & ~3
        body += bytes(rng.integers(0, 256, stride * h, dtype=np.uint8)) + bytes(((w + 31) // 32 * 4) * h)
        bodies.append(body)
    out = struct.pack("<HHH", 0, 2, len(entries))
    off = 6 + 16 * len(entries)
    for (w, h, _), body in zip(entries, bodies):
        out += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 1, len(body), off)
        off += len(body)
    return out + b"".join(bodies)


def riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + (b"\0" if len(body) % 2 else b"")


def webp_frame_chunk(webp: bytes) -> bytes:
    """The image chunk (VP8 or VP8L, with a preceding ALPH) of a simple or
    VP8X WebP file."""
    out, pos = b"", 12
    while pos + 8 <= len(webp):
        kind, size = webp[pos:pos + 4], int.from_bytes(webp[pos + 4:pos + 8], "little")
        if kind in (b"ALPH", b"VP8 ", b"VP8L"):
            out += webp[pos:pos + 8 + size + (size & 1)]
        pos += 8 + size + (size & 1)
    return out


def webp_animation(canvas: tuple[int, int], frames: list[tuple[bytes, int, int, int, int]]) -> bytes:
    """A VP8X + ANIM WebP: frames of (a simple WebP's bytes, x, y, w, h)."""
    w, h = canvas
    vp8x = bytes([0x12, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    body = riff_chunk(b"VP8X", vp8x) + riff_chunk(b"ANIM", bytes(4) + struct.pack("<H", 0))
    for data, x, y, fw, fh in frames:
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (fw - 1).to_bytes(3, "little")
        head += (fh - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + bytes([0])
        body += riff_chunk(b"ANMF", head + webp_frame_chunk(data))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ---- VP8 key frames with every header option --------------------------------------


class BoolEncoder:
    """RFC 6386 section 7.3's boolean entropy encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put(128, (v >> i) & 1)

    def signed(self, v: int, n: int) -> None:
        self.literal(abs(v), n)
        self.put(128, int(v < 0))

    def optional_signed(self, v: int, n: int) -> None:
        self.put(128, int(v != 0))
        if v:
            self.signed(v, n)

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v <<= c & 7
        for _ in range(c >> 3):
            v <<= 8
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_YMODE4_PATHS = {}


def _mode4_paths():
    """Each 4x4 mode's (node, bit) path down the decoder's tree."""
    from optixpathtracer_tpu_torch.io.codecs.vp8 import _YMODES4

    if not _YMODE4_PATHS:
        def walk(node, path):
            for bit in (0, 1):
                nxt = _YMODES4[2 * node + bit]
                if nxt > 0:
                    walk(nxt, path + [(node, bit)])
                else:
                    _YMODE4_PATHS[-nxt] = path + [(node, bit)]
        walk(0, [])
    return _YMODE4_PATHS


def _put_large(enc: BoolEncoder, v: int, p) -> None:
    from optixpathtracer_tpu_torch.io.codecs.vp8 import _CAT

    if v <= 4:
        enc.put(p[3], 0)
        enc.put(p[4], int(v > 2))
        if v > 2:
            enc.put(p[5], v - 3)
        return
    enc.put(p[3], 1)
    if v <= 10:
        enc.put(p[6], 0)
        enc.put(p[7], int(v > 6))
        if v <= 6:
            enc.put(159, v - 5)
        else:
            enc.put(165, (v - 7) >> 1)
            enc.put(145, (v - 7) & 1)
        return
    enc.put(p[6], 1)
    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
    enc.put(p[8], cat >> 1)
    enc.put(p[9 + (cat >> 1)], cat & 1)
    extra = v - 3 - (8 << cat)
    probs = _CAT[cat]
    for i, prob in enumerate(probs):
        enc.put(prob, (extra >> (len(probs) - 1 - i)) & 1)


def _put_coeffs(enc: BoolEncoder, bands, ctx: int, levels: list, first: int) -> int:
    """Tokens of one block's levels (zigzag order) from position `first`;
    returns what the decoder's GetCoeffs returns."""
    nz = [i for i in range(first, 16) if levels[i]]
    last = nz[-1] if nz else first - 1
    n, p = first, bands[first][ctx]
    while n < 16:
        if n > last:
            enc.put(p[0], 0)
            return n
        enc.put(p[0], 1)
        while not levels[n]:
            enc.put(p[1], 0)
            n += 1
            p = bands[n][0]
        enc.put(p[1], 1)
        v = abs(levels[n])
        if v == 1:
            enc.put(p[2], 0)
            nxt = 1
        else:
            enc.put(p[2], 1)
            _put_large(enc, v, p)
            nxt = 2
        enc.put(128, int(levels[n] < 0))
        n += 1
        if n < 16:
            p = bands[n][nxt]
    return 16


def vp8_frame(width: int, height: int, rng, simple: int = 0, level: int = 20, sharpness: int = 0,
              log2_parts: int = 0, segments=None, lf_delta=None, quant=(40, 0, 0, 0, 0, 0),
              use_skip: bool = True, prob_updates: float = 0.0, big: float = 0.0, big_max: int = 100) -> bytes:
    """A VP8 key frame (for a "VP8 " chunk) of random modes and levels,
    every header field as given: the loop filter (simple or normal, level,
    sharpness, reference / mode deltas), 2^log2_parts token partitions,
    segments ((update map, absolute, quantisers, filter levels, tree
    probabilities) or None), the quantiser and its five deltas, token
    probability updates, the skip flag. Levels are small, a share `big` of
    them 11-`big_max` (the extra-bit categories). Keep big_max times the
    largest dequantisation factor within a real encoder's +-2047: libwebp's
    SSE2 transforms wrap 16-bit lanes past that range, its C ones do not."""
    from optixpathtracer_tpu_torch.io.codecs.vp8 import _BANDS
    from optixpathtracer_tpu_torch.io.codecs.vp8_tables import BMODES_PROBA, COEFFS_PROBA0, COEFFS_UPDATE_PROBA

    hdr = BoolEncoder()
    hdr.literal(0, 2)
    hdr.put(128, int(segments is not None))
    seg_probs = [255, 255, 255]
    if segments is not None:
        update_map, absolute, seg_q, seg_lf, seg_probs = segments
        hdr.put(128, update_map)
        hdr.put(128, 1)
        hdr.put(128, absolute)
        for q in seg_q:
            hdr.optional_signed(q, 7)
        for lf in seg_lf:
            hdr.optional_signed(lf, 6)
        if update_map:
            for prob in seg_probs:
                hdr.put(128, int(prob != 255))
                if prob != 255:
                    hdr.literal(prob, 8)
    else:
        update_map = 0
    hdr.put(128, simple)
    hdr.literal(level, 6)
    hdr.literal(sharpness, 3)
    hdr.put(128, int(lf_delta is not None))
    if lf_delta is not None:
        hdr.put(128, 1)
        for d in list(lf_delta[0]) + list(lf_delta[1]):
            hdr.put(128, int(d != 0))
            if d:
                hdr.signed(d, 6)
    hdr.literal(log2_parts, 2)
    hdr.literal(quant[0], 7)
    for d in quant[1:]:
        hdr.optional_signed(d, 4)
    hdr.put(128, 0)  # refresh_entropy_probs
    probs = []
    i = 0
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                row = []
                for _ in range(11):
                    upd = rng.random() < prob_updates
                    hdr.put(COEFFS_UPDATE_PROBA[i], int(upd))
                    v = int(rng.integers(1, 256)) if upd else COEFFS_PROBA0[i]
                    if upd:
                        hdr.literal(v, 8)
                    row.append(v)
                    i += 1
                ctxs.append(row)
            bands.append(ctxs)
        probs.append([bands[_BANDS[n]] for n in range(17)])
    skip_p = int(rng.integers(1, 255))
    hdr.put(128, int(use_skip))
    if use_skip:
        hdr.literal(skip_p, 8)
    n_parts = 1 << log2_parts
    parts = [BoolEncoder() for _ in range(n_parts)]
    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    paths = _mode4_paths()
    intra_t = [0] * (4 * mbw)
    nz_top, nz_dc_top = [0] * mbw, [0] * mbw

    def levels(first):
        out = [0] * 16
        for k in range(first, 16):
            r = rng.random()
            if r < 0.45 / (1 + k):
                out[k] = int(rng.integers(1, 5)) * (1 if rng.random() < 0.5 else -1)
            elif r < 0.45 / (1 + k) + big:
                out[k] = int(rng.integers(11, big_max + 1)) * (1 if rng.random() < 0.5 else -1)
        return out

    for mb_y in range(mbh):
        intra_l = [0] * 4
        nz_left = nz_dc_left = 0
        tok = parts[mb_y & (n_parts - 1)]
        for mb_x in range(mbw):
            if update_map:
                seg = int(rng.integers(4))
                hdr.put(seg_probs[0], seg >> 1)
                hdr.put(seg_probs[1 + (seg >> 1)], seg & 1)
            skip = int(use_skip and rng.random() < 0.15)
            if use_skip:
                hdr.put(skip_p, skip)
            i4 = rng.random() < 0.5
            hdr.put(145, int(not i4))
            if not i4:
                ymode = int(rng.integers(4))  # DC, TM, V, H
                hdr.put(156, int(ymode in (1, 3)))
                if ymode in (1, 3):
                    hdr.put(128, int(ymode == 1))
                else:
                    hdr.put(163, int(ymode == 2))
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rng.integers(10))
                        prob = BMODES_PROBA[(intra_t[4 * mb_x + x] * 10 + intra_l[y]) * 9:][:9]
                        for node, bit in paths[m]:
                            hdr.put(prob[node], bit)
                        intra_t[4 * mb_x + x] = intra_l[y] = m
            uv = int(rng.integers(4))
            hdr.put(142, int(uv != 0))
            if uv:
                hdr.put(114, int(uv != 2))
                if uv != 2:
                    hdr.put(183, int(uv == 1))
            if skip:
                nz_top[mb_x] = nz_left = 0
                if not i4:
                    nz_dc_top[mb_x] = nz_dc_left = 0
                continue
            if not i4:
                nz = _put_coeffs(tok, probs[1], nz_dc_top[mb_x] + nz_dc_left, levels(0), 0)
                nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
            first, ac = (1, probs[0]) if not i4 else (0, probs[3])
            tnz, lnz = nz_top[mb_x], nz_left
            tcol = [(tnz >> x) & 1 for x in range(4)]
            new_l = 0
            for y in range(4):
                lft = (lnz >> y) & 1
                for x in range(4):
                    nz = _put_coeffs(tok, ac, lft + tcol[x], levels(first), first)
                    lft = tcol[x] = int(nz > first)
                new_l |= lft << y
            new_t = sum(tcol[x] << x for x in range(4))
            for shift in (4, 6):
                tc = [(tnz >> (shift + x)) & 1 for x in range(2)]
                for y in range(2):
                    lft = (lnz >> (shift + y)) & 1
                    for x in range(2):
                        nz = _put_coeffs(tok, probs[2], lft + tc[x], levels(0), 0)
                        lft = tc[x] = int(nz > 0)
                    new_l |= lft << (shift + y)
                new_t |= (tc[0] | tc[1] << 1) << shift
            nz_top[mb_x], nz_left = new_t, new_l
    first_part = hdr.flush()
    tokens = [p.flush() for p in parts]
    sizes = b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    tag = (len(first_part) << 5) | (1 << 4)  # a key frame, version 0, shown
    frame = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
    return frame + first_part + sizes + b"".join(tokens)


def webp_vp8(frame: bytes) -> bytes:
    """A simple lossy WebP around one VP8 key frame."""
    body = riff_chunk(b"VP8 ", frame)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
