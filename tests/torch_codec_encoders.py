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
              jpeg_chunks=None, jpeg_tables: bytes | None = None, extra_tags: dict | None = None,
              old_lzw: bool = False) -> bytes:
    """A TIFF of (H, W, S) integer samples at `bits` per sample (MSB-first
    packing below 8, the byte order's words above), in strips or tiles,
    planar configuration 1 or 2, compressed with none (1), LZW (5; the
    old LSB-first codes when `old_lzw`), Deflate (8), PackBits (32773),
    LZMA (34925), ThunderScan (32809, 4-bit grey) or, given `jpeg_chunks`
    (one JPEG stream per strip or tile), JPEG (7); horizontal differencing
    when predictor 2;
    each stored byte's bits reversed for fill order 2; libtiff's
    floating-point predictor when predictor 3."""
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
        if predictor == 3:  # libtiff's float predictor: byte planes (most significant first), bytes differenced
            nb = bits // 8
            be = px.astype(np.dtype(f"{kind}{nb}").newbyteorder(">")).view(np.uint8).reshape(rows, cols * n, nb)
            planes = be.transpose(0, 2, 1).reshape(rows, -1).astype(np.int64)
            d = planes.copy()
            d[:, n:] = planes[:, n:] - planes[:, :-n]
            return (d % 256).astype(np.uint8).tobytes()
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
                    raw = lzw_encode(raw, 8, msb=not old_lzw, early=not old_lzw)
                elif compression == 34925:
                    import lzma

                    raw = lzma.compress(raw)
                elif compression == 32809:
                    raw = thunderscan(px[..., 0])
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
    fmt = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}  # 5: rationals, given as numerator, denominator, ...
    size = {1: 1, 3: 2, 4: 4, 5: 4, 7: 1, 16: 8}
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
        entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, len(vals) // (2 if typ == 5 else 1)) + val
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


# ---- the small raster formats -------------------------------------------------------


def sun_file(rows: np.ndarray, depth: int, kind: int = 1, cmap: np.ndarray | None = None) -> bytes:
    """A Sun raster file of (H, W) samples (depth 1, 4, 8) or (H, W, C)
    pixels in file order (depth 24: BGR, or RGB for type 3; 32: with a
    pad byte), rows padded to 16 bits; type 2 run-length encodes the
    unpadded rows' bytes (0x80 n v: n + 1 copies of v, 0x80 0: 0x80)."""
    h, w = rows.shape[:2]
    if depth < 8:
        bits = ((rows[..., None].astype(np.uint8) >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
        packed = np.packbits(bits, axis=1)
    else:
        packed = rows.reshape(h, -1).astype(np.uint8)
    stride = (w * depth + 15) // 16 * 2
    if kind == 2:
        flat = packed[:, :(w * depth + 7) // 8].tobytes()
        body = bytearray()
        i = 0
        while i < len(flat):
            j = i
            while j < len(flat) and flat[j] == flat[i] and j - i < 256:
                j += 1
            n = j - i
            if n >= 3 or flat[i] == 0x80:
                if n == 1:
                    body += b"\x80\x00"
                else:
                    body += bytes([0x80, n - 1, flat[i]])
            else:
                body += flat[i:j]
            i = j
        body = bytes(body)
    else:
        body = np.pad(packed, ((0, 0), (0, stride - packed.shape[1]))).tobytes()
    pal = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind, 1 if cmap is not None else 0,
                       len(pal)) + pal + body


def msp_rle(bits: np.ndarray) -> bytes:
    """A Paint v2 ("LinS") file of (H, W) 0/1 pixels: each row's packed bytes
    as runs (0 n v) and literals (n bytes), an all-white row empty."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    enc = []
    for r in rows:
        r = r.tobytes()
        if r == b"\xff" * len(r):
            enc.append(b"")
            continue
        out = bytearray()
        i = 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, r[i]])
            else:
                k = i
                while k < len(r) and k - i < 255 and not (k + 2 < len(r) and r[k] == r[k + 1] == r[k + 2]):
                    k += 1
                j = max(k, i + 1)
                out += bytes([j - i]) + r[i:j]
            i = j
        enc.append(bytes(out))
    head = bytearray(struct.pack("<4s10H", b"LinS", w, h, 1, 1, 1, 1, w, h, 0, 0) + bytes(8))
    check = 0
    for i in range(0, 32, 2):
        check ^= struct.unpack("<H", head[i:i + 2])[0]
    head[24:26] = struct.pack("<H", check)
    return bytes(head) + b"".join(struct.pack("<H", len(e)) for e in enc) + b"".join(enc)


def xpm_file(idx: np.ndarray, colours: list[bytes], chars: int, none: int | None = None) -> bytes:
    """An XPM of (H, W) indices into `colours` ("#RRGGBB"), `chars`
    characters a pixel; entry `none` is the transparent colour."""
    alphabet = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.#"
    keys = []
    for i in range(len(colours)):
        k, n = b"", i
        for _ in range(chars):
            k, n = alphabet[n % len(alphabet):n % len(alphabet) + 1] + k, n // len(alphabet)
        keys.append(k)
    h, w = idx.shape
    out = [b"/* XPM */", b"static char *x[] = {", b'"%d %d %d %d",' % (w, h, len(colours), chars)]
    for i, (k, c) in enumerate(zip(keys, colours)):
        out.append(b'"%s c %s",' % (k, b"None" if i == none else c))
    out.append(b"/* pixels */")
    out += [b'"' + b"".join(keys[v] for v in row) + b'",' for row in idx]
    out[-1] = out[-1][:-1]
    return b"\n".join(out + [b"};", b""])


def ftex_file(width: int, height: int, fmt: int, body: bytes) -> bytes:
    """An FTEX texture: one format entry (0 DXT1, 1 RGB) and one mip level."""
    head = b"FTEX" + struct.pack("<i2i2i2i", 1, width, height, 1, 1, fmt, 40)
    return head.ljust(40, b"\0") + struct.pack("<i", len(body)) + body


def dcx_file(frames: list[bytes]) -> bytes:
    """An Intel DCX container of PCX files."""
    offsets, pos = [], 4 + 4 * (len(frames) + 1)
    for f in frames:
        offsets.append(pos)
        pos += len(f)
    return struct.pack("<I", 0x3ADE68B1) + struct.pack(f"<{len(frames) + 1}I", *offsets, 0) + b"".join(frames)


def blp1_jpeg(jpeg: bytes, width: int, height: int, split: int = 0, alpha: int = 0) -> bytes:
    """A BLP1 texture with JPEG content: the first `split` bytes of the
    stream as the shared header, the rest as mip 0."""
    head_len = split or jpeg.index(b"\xff\xda")
    body_at = 156 + 4 + head_len
    offsets = [body_at] + [0] * 15
    lengths = [len(jpeg) - head_len] + [0] * 15
    return (b"BLP1" + struct.pack("<iIIIii", 0, alpha, width, height, 5, 0) + struct.pack("<16I", *offsets)
            + struct.pack("<16I", *lengths) + struct.pack("<I", head_len) + jpeg)


def blp2_file(width: int, height: int, body: bytes, encoding: int = 2, alpha_encoding: int = 0, alpha: int = 0,
              palette: np.ndarray | None = None) -> bytes:
    """A BLP2 texture: a 256-entry BGRA palette, then mip 0 (DXT blocks or
    palette indices)."""
    pal = np.zeros((256, 4), np.uint8) if palette is None else np.asarray(palette, np.uint8)
    at = 148 + 1024
    return (b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha, alpha_encoding, 0, width, height)
            + struct.pack("<16I", at, *[0] * 15) + struct.pack("<16I", len(body), *[0] * 15) + pal.tobytes() + body)


def icns_rle24(img: np.ndarray) -> bytes:
    """ICNS 24-bit RLE of an (N, N, 3) image: the planes one after another,
    runs of 3-130 bytes as (n + 125, v), literals as (n - 1, bytes)."""
    out = bytearray()
    for c in range(3):
        p = img[..., c].tobytes()
        i = 0
        while i < len(p):
            j = i
            while j < len(p) and p[j] == p[i] and j - i < 130:
                j += 1
            if j - i >= 3:
                out += bytes([j - i + 125, p[i]])
                i = j
                continue
            k = i
            while k < len(p) and k - i < 128 and not (k + 2 < len(p) and p[k] == p[k + 1] == p[k + 2]):
                k += 1
            out += bytes([k - i - 1]) + p[i:k]
            i = k
    return bytes(out)


def icns_file(entries: list[tuple[bytes, bytes]]) -> bytes:
    body = b"".join(sig + struct.pack(">I", 8 + len(d)) + d for sig, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def fits_file(data: np.ndarray, bitpix: int, extra_cards: list[bytes] = ()) -> bytes:
    """A FITS primary HDU of (H, W) samples, big-endian as FITS stores them
    (rows as given)."""
    h, w = data.shape
    cards = [b"SIMPLE  =                    T", b"BITPIX  = %20d" % bitpix, b"NAXIS   =                    2",
             b"NAXIS1  = %20d" % w, b"NAXIS2  = %20d" % h, *extra_cards, b"END"]
    head = b"".join(c.ljust(80) for c in cards)
    head = head.ljust(-(-len(head) // 2880) * 2880)
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    body = data.astype(dt).tobytes()
    return head + body.ljust(-(-len(body) // 2880) * 2880, b"\0")


def fits_gzip(data: np.ndarray, bitpix: int) -> bytes:
    """A tile-compressed FITS (an empty primary HDU, then a BINTABLE with
    ZIMAGE and GZIP_1) whose heap is one gzip stream of 4-byte big-endian
    words, as PIL's reader takes it."""
    import gzip

    h, w = data.shape
    primary = b"".join(c.ljust(80) for c in [b"SIMPLE  =                    T", b"BITPIX  =                    8",
                                             b"NAXIS   =                    0", b"END"]).ljust(2880)
    stream = gzip.compress(data.astype(">i4").tobytes(), mtime=0)
    cards = [b"XTENSION= 'BINTABLE'", b"BITPIX  =                    8", b"NAXIS   =                    2",
             b"NAXIS1  =                    8", b"NAXIS2  =                    1", b"ZIMAGE  =                    T",
             b"ZCMPTYPE= 'GZIP_1  '", b"ZBITPIX = %20d" % bitpix, b"ZNAXIS  =                    2",
             b"ZNAXIS1 = %20d" % w, b"ZNAXIS2 = %20d" % h, b"END"]
    head = b"".join(c.ljust(80) for c in cards).ljust(2880)
    table = struct.pack(">ii", len(stream), 0)
    return primary + head + table + stream


def iptc_file(img: np.ndarray, layers: int = 1, component: int = 0, band: int | None = None,
              jpeg: bytes | None = None, split: int = 1) -> bytes:
    """An IPTC/NAA record: 3:60 layers and component flag, 3:20 / 3:30 the
    size, 3:120 compression (1 raw, 5 JPEG), 3:65 the band, then the image
    data in `split` 8:10 fields (the last with an extended size: PIL takes
    the count of size bytes from the header's fourth byte and reads them
    after its fifth)."""
    def field(rec: int, ds: int, value: bytes, extended: bool = False) -> bytes:
        if extended:
            return bytes([0x1C, rec, ds, 0x84, 0]) + struct.pack(">I", len(value)) + value
        return bytes([0x1C, rec, ds]) + struct.pack(">H", len(value)) + value

    h, w = img.shape[:2]
    out = field(2, 0, b"\x00\x04") + field(3, 60, bytes([layers, component])) + field(3, 20, struct.pack(">H", w))
    out += field(3, 30, struct.pack(">H", h)) + field(3, 120, bytes([5 if jpeg else 1]))
    if band is not None:
        out += field(3, 65, bytes([band + 1]))
    body = jpeg if jpeg else img.astype(np.uint8).tobytes()
    cuts = np.linspace(0, len(body), split + 1).astype(int)
    for i in range(split):
        out += field(8, 10, body[cuts[i]:cuts[i + 1]], extended=i == split - 1)
    return out + bytes(5)


def thunderscan(px: np.ndarray) -> bytes:
    """ThunderScan 4-bit codes for (rows, width) pixels, each row from 0:
    runs of the last pixel, three 2-bit deltas (-1..1, 2 skips), two 3-bit
    deltas (-3..3, 4 skips), else the raw pixel."""
    out = bytearray()
    for row in px.astype(int):
        last, i, n = 0, 0, len(row)
        while i < n:
            k = 0
            while i + k < n and row[i + k] == last and k < 63:
                k += 1
            if k >= 2:
                out.append(k)
                i += k
                continue
            d = [row[j] - prev for j, prev in zip(range(i, min(i + 3, n)), [last, *row[i:i + 2]])]
            if len(d) >= 1 and all(-1 <= x <= 1 for x in d[:3]) and len(d) == 3:
                codes = [{0: 0, 1: 1, -1: 3}[x] for x in d]
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                last, i = row[i + 2], i + 3
            elif all(-3 <= x <= 3 for x in d[:2]) and len(d) >= 2:
                codes = [x & 7 for x in d[:2]]
                out.append(0x80 | codes[0] << 3 | codes[1])
                last, i = row[i + 1], i + 2
            elif abs(d[0]) <= 3 and i == n - 1:
                out.append(0x80 | (d[0] & 7) << 3 | 4)
                last, i = row[i], i + 1
            else:
                out.append(0xC0 | row[i])
                last, i = row[i], i + 1
    return bytes(out)


def pixar_file(img: np.ndarray) -> bytes:
    """A PIXAR raster: the size at bytes 416 / 418, mode (14, 2), RGB from 1024."""
    h, w, _ = img.shape
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    head[416:420] = struct.pack("<HH", h, w)
    head[424:428] = struct.pack("<HH", 14, 2)
    return bytes(head) + img.astype(np.uint8).tobytes()


def mcidas_file(v: np.ndarray, size: int, prefix: int = 0) -> bytes:
    """A McIdas area: the 64-word descriptor, then rows of `size`-byte
    big-endian samples, each after `prefix` bytes."""
    h, w = v.shape
    d = [0] * 64
    d[1] = 4
    d[8], d[9], d[10], d[13], d[14], d[33] = h, w, size, 1, prefix, 256  # w[9..] in PIL's 1-based terms
    head = struct.pack("!64i", *d)
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[size]
    rows = b"".join(bytes(prefix) + r.astype(dt).tobytes() for r in v)
    return head + rows


def gbr_file(px: np.ndarray, version: int = 2) -> bytes:
    """A GIMP brush of (H, W) grey or (H, W, 4) RGBA pixels."""
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    name = b"brush\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(name), 1, w, h, depth) + name
    else:
        head = struct.pack(">5I", 28 + len(name), 2, w, h, depth) + b"GIMP" + struct.pack(">I", 10) + name
    return head + px.astype(np.uint8).tobytes()


def xvthumb_file(idx: np.ndarray) -> bytes:
    h, w = idx.shape
    return b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n%d %d 255\n" % (w, h) + idx.astype(np.uint8).tobytes()


def imt_file(px: np.ndarray) -> bytes:
    h, w = px.shape
    return b"* a comment\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h) + px.astype(np.uint8).tobytes()


def tiff_raw_strip(strip: bytes, width: int, height: int, bits: int, photometric: int, order: str = "<",
                   compression: int = 1, spp: int = 1) -> bytes:
    """A one-strip TIFF around bytes already packed or compressed (12-bit
    grey, say, which tiff_file does not pack, or a hand-made zstd frame)."""
    base = tiff_file(np.zeros((height, 1, spp), np.uint8), 8, photometric, order, 1)
    data = bytearray(base)
    off = 8
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    out = bytearray(data[:8]) + strip + (b"\0" if len(strip) % 2 else b"")
    new_ifd = len(out)
    entries = b""
    for i in range(n):
        e = bytes(data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        tag = struct.unpack(order + "H", e[:2])[0]
        if tag == 256:
            e = e[:8] + struct.pack(order + "I", width)
        elif tag == 258 and spp == 1:
            e = e[:8] + struct.pack(order + "HH", bits, 0)
        elif tag == 259:
            e = e[:8] + struct.pack(order + "HH", compression, 0)
        elif tag == 273:
            e = e[:8] + struct.pack(order + "I", off)
        elif tag == 279:
            e = e[:8] + struct.pack(order + "I", len(strip))
        entries += e
    out += struct.pack(order + "H", n) + entries + bytes(4)
    out[4:8] = struct.pack(order + "I", new_ifd)
    return bytes(out)


# ---- FLI / FLC ------------------------------------------------------------------


def fli_file(width: int, height: int, chunks: list[tuple[int, bytes]], magic: int = 0xAF12,
             prefix: bytes | None = None) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file of one frame of `chunks` (type,
    body), after an optional prefix chunk (0xF100)."""
    subs = b""
    for kind, body in chunks:
        if len(body) % 2:
            body += b"\0"
        subs += struct.pack("<IH", 6 + len(body), kind) + body
    frame = struct.pack("<IHH", 16 + len(subs), 0xF1FA, len(chunks)) + bytes(8) + subs
    pre = b"" if prefix is None else struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 128 + len(pre) + len(frame), magic, 1, width, height, 8, 3)
    struct.pack_into("<I", head, 16, 70)
    return bytes(head) + pre + frame


def fli_color(pal: np.ndarray, six_bit: bool = False, skip: int = 0) -> tuple[int, bytes]:
    """A COLOR_256 (4) or COLOR_64 (11) chunk: one packet of the entries
    after `skip`."""
    p = np.asarray(pal, np.uint8)
    n = len(p)
    return (11 if six_bit else 4), struct.pack("<H", 1) + bytes([skip, n % 256]) + p.tobytes()


def fli_brun(img: np.ndarray) -> tuple[int, bytes]:
    out = bytearray()
    for row in img.astype(np.uint8):
        out.append(0)
        x, w = 0, len(row)
        while x < w:
            j = x
            while j < w and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 3:
                out += bytes([j - x, row[x]])
                x = j
                continue
            j = x
            while j < w and j - x < 127 and not (j + 2 < w and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            out += bytes([256 - (j - x)]) + row[x:j].tobytes()
            x = j
    return 15, bytes(out)


def fli_copy(img: np.ndarray) -> tuple[int, bytes]:
    return 16, img.astype(np.uint8).tobytes()


def fli_lc(img: np.ndarray, y0: int = 0) -> tuple[int, bytes]:
    """Byte deltas over a black frame: each line's non-zero spans as runs
    or literals."""
    rows = img.astype(np.uint8)[y0:]
    out = bytearray(struct.pack("<HH", y0, len(rows)))
    for row in rows:
        packets, x, w = bytearray(), 0, len(row)
        n = 0
        while x < w:
            skip = 0
            while x < w and row[x] == 0 and skip < 255:
                x += 1
                skip += 1
            if x >= w:
                break
            j = x
            while j < w and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 3:
                packets += bytes([skip, 256 - (j - x), row[x]])
            else:
                j = min(x + 1 + int(row[x] % 5), w)
                packets += bytes([skip, j - x]) + row[x:j].tobytes()
            x = j
            n += 1
        out += bytes([n]) + packets
    return 12, bytes(out)


def fli_ss2(img: np.ndarray) -> tuple[int, bytes]:
    """Word deltas over a black frame (even width): one line skip word for
    an all-black line, word runs and literals, the last byte of an odd
    width in a flag word."""
    h, w = img.shape
    rows = img.astype(np.uint8)
    out = bytearray()
    lines = 0
    y = 0
    while y < h:
        words = bytearray()
        skip = 0
        while y < h and not rows[y].any():
            skip += 1
            y += 1
        if y >= h:
            break
        if skip:
            words += struct.pack("<H", 65536 - skip)
        row = rows[y]
        even = w - w % 2
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(row[-1]))
        packets, x, n = bytearray(), 0, 0
        while x < even:
            s = 0
            while x < even and row[x] == 0 and row[x + 1] == 0 and s < 254:
                x += 2
                s += 2
            if x >= even:
                break
            j = x
            while j + 1 < even and row[j] == row[x] and row[j + 1] == row[x + 1] and (j - x) // 2 < 127:
                j += 2
            if (j - x) // 2 >= 2:
                packets += bytes([s, 256 - (j - x) // 2]) + row[x:x + 2].tobytes()
            else:
                j = min(x + 2 * (1 + int(row[x] % 3)), even)
                packets += bytes([s, (j - x) // 2]) + row[x:j].tobytes()
            x = j
            n += 1
        words += struct.pack("<H", n) + packets
        out += words
        lines += 1
        y += 1
    return 7, struct.pack("<H", lines) + bytes(out)


def pcd_file(y: np.ndarray, c1: np.ndarray, c2: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD base image: (512, 768) luma, (256, 384) C1 and C2, from
    byte 96 * 2048, after the "PCD_" header and its orientation byte."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    rows = [y[2 * k].tobytes() + y[2 * k + 1].tobytes() + c1[k].tobytes() + c2[k].tobytes() for k in range(256)]
    return bytes(head) + b"".join(rows)


def ycbcr_tiff(ycc: np.ndarray, sub: tuple[int, int] = (2, 2), compression: int = 5, rows_per_strip: int = 4,
               order: str = "<", extra_tags: dict | None = None) -> bytes:
    """A YCbCr TIFF (photometric 6) without JPEG: (H, W, 3) samples stored
    as data units (`sub` = (h, v): h * v luma samples of a block, row by
    row, then its Cb and Cr, the block's first pixel's), blocks past the
    image's edge padded with its edge pixels."""
    import lzma
    import zlib

    h, w, _ = ycc.shape
    hs, vs = sub
    chunks = []
    for y0 in range(0, h, rows_per_strip):
        units = bytearray()
        for by in range(y0, min(y0 + rows_per_strip, h), vs):
            for bx in range(0, w, hs):
                ys = [ycc[min(by + j, h - 1), min(bx + i, w - 1), 0] for j in range(vs) for i in range(hs)]
                units += bytes(ys) + bytes([ycc[by, bx, 1], ycc[by, bx, 2]])
        raw = bytes(units)
        if compression == 5:
            raw = lzw_encode(raw, 8, msb=True, early=True)
        elif compression in (8, 32946):
            raw = zlib.compress(raw)
        elif compression == 32773:
            raw = packbits(raw)
        elif compression == 34925:
            raw = lzma.compress(raw)
        chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [6]),
            277: (3, [3]), 278: (3, [rows_per_strip]), 284: (3, [1]), 530: (3, [hs, vs])}
    tags.update(extra_tags or {})
    data = bytearray(8)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + (b"\0" if len(c) % 2 else b"")
    tags[273] = (4, offsets)
    tags[279] = (4, [len(c) for c in chunks])
    fmt = {3: "H", 4: "I", 5: "II"}
    blobs = {}
    for tag, (typ, vals) in tags.items():
        raw = struct.pack(order + fmt[typ] * (len(vals) // (2 if typ == 5 else 1)), *vals)
        if len(raw) > 4:
            blobs[tag] = len(data)
            data += raw
    ifd = len(data)
    entries = b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        n = len(vals) // (2 if typ == 5 else 1)
        raw = struct.pack(order + fmt[typ] * n, *vals)
        val = struct.pack(order + "I", blobs[tag]) if tag in blobs else raw.ljust(4, b"\0")
        entries += struct.pack(order + "HHI", tag, typ, n) + val
    data += struct.pack(order + "H", len(tags)) + entries + bytes(4)
    data[:8] = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, ifd)
    return bytes(data)


def zstd_simple_frame(data: bytes, rle_at: int) -> bytes:
    """A Zstandard frame of three blocks: data[:rle_at] raw, a run of its
    next byte as an RLE block, then the rest as a compressed block of RLE
    literals without sequences (the rest must be one repeated byte)."""
    run = data[rle_at]
    n = len(data) - rle_at
    k = next(i for i in range(n) if i == n - 1 or data[rle_at + i + 1] != run) + 1
    rest = data[rle_at + k:]
    assert rest == rest[:1] * len(rest) and 0 < len(rest) < 4096
    frame = b"\x28\xb5\x2f\xfd" + bytes([0x00, 0x58])  # no content size; a window descriptor
    frame += (rle_at << 3 | 0).to_bytes(3, "little") + data[:rle_at]
    frame += (k << 3 | 2).to_bytes(3, "little") + bytes([run])
    lit = (1 | 1 << 2 | len(rest) << 4).to_bytes(2, "little") + rest[:1] + b"\x00"  # RLE literals, no sequences
    frame += (len(lit) << 3 | 4 | 1).to_bytes(3, "little") + lit
    return frame


def ojpeg_tiff(jpeg: bytes, height: int, width: int, split: bool = False, order: str = "<",
               extra_tags: dict | None = None) -> bytes:
    """An old-style JPEG TIFF (compression 6): JPEGInterchangeFormat at the
    JPEG stream; one strip, the whole stream, or with `split` the stream's
    header alone at JPEGInterchangeFormat (its length stopping before the
    scan) and the scan (from its SOS) as the strip."""
    sos = jpeg.index(b"\xff\xda")
    head_len = sos if split else len(jpeg)
    probe = tiff_file(np.zeros((height, width, 3), np.uint8), 8, 6, order, 6, jpeg_chunks=[jpeg],
                      rows_per_strip=height, extra_tags={513: (4, [0]), 514: (4, [0])})
    at = struct.unpack(order + "I", probe[4:8])[0] and 8  # tiff_file puts the first chunk at byte 8
    tags = {513: (4, [at]), 514: (4, [head_len]), 530: (3, [2, 2])}
    tags.update(extra_tags or {})
    data = bytearray(tiff_file(np.zeros((height, width, 3), np.uint8), 8, 6, order, 6, jpeg_chunks=[jpeg],
                               rows_per_strip=height, extra_tags=tags))
    if split:  # the strip starts at the scan
        from_ifd = struct.unpack(order + "I", data[4:8])[0]
        n = struct.unpack(order + "H", data[from_ifd:from_ifd + 2])[0]
        for i in range(n):
            e = from_ifd + 2 + 12 * i
            tag = struct.unpack(order + "H", data[e:e + 2])[0]
            if tag == 273:
                data[e + 8:e + 12] = struct.pack(order + "I", at + sos)
            elif tag == 279:
                data[e + 8:e + 12] = struct.pack(order + "I", len(jpeg) - sos)
    return bytes(data)


def jpeg_segments(jpeg: bytes) -> tuple[dict, bytes]:
    """A baseline JPEG's tables and scan: ({"dqt": {id: 64 zigzag bytes},
    "dht": {(class, id): counts + values}}, the entropy-coded data)."""
    tables = {"dqt": {}, "dht": {}}
    pos = 2
    while True:
        marker, length = jpeg[pos + 1], int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        body = jpeg[pos + 4:pos + 2 + length]
        if marker == 0xDB:
            i = 0
            while i < len(body):
                tables["dqt"][body[i] & 15] = body[i + 1:i + 65]
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                tables["dht"][(body[i] >> 4, body[i] & 15)] = body[i + 1:i + 17 + n]
                i += 17 + n
        elif marker == 0xDA:
            scan = jpeg[pos + 2 + length:]
            return tables, scan[:scan.rindex(b"\xff\xd9")]
        pos += 2 + length


def ojpeg_tables_tiff(jpeg: bytes, height: int, width: int, order: str = "<", rows_per_strip: int | None = None,
                      restart: int | None = None) -> bytes:
    """An old-style JPEG TIFF of the TIFF 6.0 kind: JPEGProc 1, the
    quantisation and Huffman tables at JPEGQTables / JPEGDCTables /
    JPEGACTables (one per component: luma's, then chroma's twice), one
    strip of the scan's entropy-coded data; 4:2:0 YCbCr. With
    `rows_per_strip`, the scan (written with a restart marker at each
    strip's start) is cut at its RST markers into strips, the markers
    dropped; `restart` sets JPEGRestartInterval."""
    tables, scan = jpeg_segments(jpeg)
    strips = [scan]
    if rows_per_strip:
        import re

        strips = re.split(rb"\xff[\xd0-\xd7]", scan)
    q = [tables["dqt"][0], tables["dqt"].get(1, tables["dqt"][0])]
    dc = [tables["dht"][(0, 0)], tables["dht"].get((0, 1), tables["dht"][(0, 0)])]
    ac = [tables["dht"][(1, 0)], tables["dht"].get((1, 1), tables["dht"][(1, 0)])]
    blobs = strips + q + dc + ac
    base = bytearray(8)
    offsets = []
    for b in blobs:
        offsets.append(len(base))
        base += b + (b"\0" if len(b) % 2 else b"")
    ns = len(strips)
    so, qo, do, ao = offsets[:ns], offsets[ns:ns + 2], offsets[ns + 2:ns + 4], offsets[ns + 4:ns + 6]
    tags = {256: (4, [width]), 257: (4, [height]), 258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [6]),
            273: (4, so), 277: (3, [3]), 278: (4, [rows_per_strip or height]), 279: (4, [len(b) for b in strips]),
            284: (3, [1]), 512: (3, [1]), 519: (4, [qo[0], qo[1], qo[1]]), 520: (4, [do[0], do[1], do[1]]),
            521: (4, [ao[0], ao[1], ao[1]]), 530: (3, [2, 2])}
    if restart is not None:
        tags[515] = (3, [restart])
    fmt = {3: "H", 4: "I"}
    blob_at = {}
    for tag, (typ, vals) in tags.items():
        raw = struct.pack(order + fmt[typ] * len(vals), *vals)
        if len(raw) > 4:
            blob_at[tag] = len(base)
            base += raw
    ifd = len(base)
    entries = b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(order + fmt[typ] * len(vals), *vals)
        val = struct.pack(order + "I", blob_at[tag]) if tag in blob_at else raw.ljust(4, b"\0")
        entries += struct.pack(order + "HHI", tag, typ, len(vals)) + val
    base += struct.pack(order + "H", len(tags)) + entries + bytes(4)
    base[:8] = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, ifd)
    return bytes(base)


# ---- high-depth AVIF planes -----------------------------------------------------


def yuv_planes(rgb: np.ndarray, depth: int, yuv_format: int, full: int = 1, seed: int | None = None):
    """An (H, W, 3) uint8 image as BT.601 Y / U / V planes of `depth` bits
    (uint16) in a libavif yuvFormat (1 4:4:4, 2 4:2:2, 3 4:2:0, 4 4:0:0: Y
    alone; the chroma averaged over its block), in full or limited range,
    with noise below the eighth bit where `seed` is given."""
    h, w, _ = rgb.shape
    rgb = rgb.astype(np.float64) / 255
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb, cr = (b - y) / 1.772 + 0.5, (r - y) / 1.402 + 0.5
    top, scale = (1 << depth) - 1, 1 << (depth - 8)
    rng = None if seed is None else np.random.default_rng(seed + 1000)

    def code(p, lo, span):
        v = lo + p * span
        if rng is not None:
            v = v + rng.normal(0, scale, p.shape)
        return np.clip(np.rint(v), 0, top).astype(np.uint16)
    out = [code(y, 0, top) if full else code(y, 16 * scale, 219 * scale)]
    if yuv_format == 4:
        return out
    sx, sy = {1: (0, 0), 2: (1, 0), 3: (1, 1)}[yuv_format]
    hc, wc = (h + sy) >> sy, (w + sx) >> sx
    for c in (cb, cr):
        c = np.pad(c, ((0, hc * (1 + sy) - h), (0, wc * (1 + sx) - w)), mode="edge")
        c = c.reshape(hc, 1 + sy, wc, 1 + sx).mean((1, 3))
        out.append(code(c, 0, top) if full else code(c, 16 * scale, 224 * scale))
    return out


def yuv_photo(h: int, w: int, seed: int, depth: int, yuv_format: int, full: int = 1) -> list[np.ndarray]:
    """`photo` as `yuv_planes`, with noise in the bits below the eighth."""
    return yuv_planes(photo(h, w, seed), depth, yuv_format, full, seed)


# ---- AVIF grid images -----------------------------------------------------------


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, body: bytes, flags: int = 0) -> bytes:
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def image_grid(rows: int, cols: int, width: int, height: int, version: int = 0) -> bytes:
    """An ImageGrid payload (HEIF 6.6.2.3): 16-bit output sizes where they
    fit, 32-bit ones (flags & 1) otherwise."""
    wide = width > 0xFFFF or height > 0xFFFF
    size = struct.pack(">II" if wide else ">HH", width, height)
    return bytes([version, int(wide), rows - 1, cols - 1]) + size


def avif_grid(cells: list, rows: int, cols: int, width: int, height: int, cell_size: tuple, av1c: bytes,
              depth: int = 8, channels: int = 3, colr: bytes | None = None, alpha=None, premultiplied: bool = False,
              grid: bytes | None = None, dimg: list | None = None, cell_types=None) -> bytes:
    """A grid AVIF (MIAF 7.3.11.4) written box by box: a `grid` primary item
    whose payload is `grid` (image_grid(rows, cols, width, height) by
    default) and whose `dimg` references are the cell items in `dimg` order
    (the cells in row-major order by default; indices into `cells`, an
    index past the end naming no item), each cell an `av01` item (or its
    `cell_types` entry) holding that cell's OBUs, of `cell_size` (width,
    height; or a list of one per cell) in `ispe`, sharing the `av1C` box `av1c`; `colr` (a whole
    colr box) on the grid item. `alpha` = (cells, av1C box, grid payload
    or None for a single av01 alpha item): an auxiliary item with the alpha
    URN referencing the grid (`auxl`), its cells referenced likewise (of
    the colour cells' size, or of a fourth entry's (width, height)), and a
    `prem` reference from the colour to it where `premultiplied`."""
    grid = image_grid(rows, cols, width, height) if grid is None else grid
    types = [b"av01"] * len(cells) if cell_types is None else cell_types
    refs = [(b"dimg", [len(cells) if i >= len(cells) else i for i in (range(len(cells)) if dimg is None else dimg)])]
    sizes = cell_size if isinstance(cell_size, list) else [cell_size] * len(cells)
    return _avif_file((b"grid", grid, (width, height)), [(t, c, z, av1c) for t, c, z in zip(types, cells, sizes)],
                      refs, depth, channels, colr, alpha, premultiplied)


def avif_still(obus: bytes, size: tuple, av1c: bytes, depth: int = 8, channels: int = 3,
               colr: bytes | None = None, alpha=None, premultiplied: bool = False) -> bytes:
    """A still AVIF of one av01 item holding `obus`, of `size` (width,
    height) in `ispe`, with its `av1C` box and `colr`; `alpha` = (OBUs, av1C
    box[, its ispe (width, height)]) an alpha item, of the same size unless
    given (`prem` where `premultiplied`)."""
    if alpha is not None:
        alpha = ([alpha[0]], alpha[1], None) + tuple(alpha[2:])
    return _avif_file((b"av01", obus, size, av1c), [], [], depth, channels, colr, alpha, premultiplied)


def _avif_file(primary: tuple, cells: list, cell_refs: list, depth: int, channels: int, colr, alpha,
               premultiplied: bool) -> bytes:
    """The boxes of a still AVIF: the primary item (type, payload, (width,
    height)[, av1C box]) as item 1, then `cells` (type, payload, (width,
    height), av1C box) as items 2.., `cell_refs` (type, [cell indices; one
    past the end naming no item]) from the primary, and the alpha item(s)."""
    props, assoc = [], {}

    def prop(box: bytes) -> int:
        if box not in props:
            props.append(box)
        return props.index(box) + 1

    def ispe(size) -> bytes:
        return _full_box(b"ispe", 0, struct.pack(">II", *size))
    pixi = _full_box(b"pixi", 0, bytes([channels]) + bytes([depth] * channels))
    pixi1 = _full_box(b"pixi", 0, bytes([1, depth]))
    auxc = _full_box(b"auxC", 0, b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0")
    items = [(primary[0], primary[1])]
    assoc[1] = [prop(ispe(primary[2])), prop(pixi)] + ([0x80 | prop(primary[3])] if len(primary) > 3 else [])
    assoc[1] += [prop(colr)] if colr else []
    for kind, payload, size, av1c in cells:
        items.append((kind, payload))
        assoc[len(items)] = [prop(ispe(size)), prop(pixi), 0x80 | prop(av1c)]
    refs = [(k, 1, [2 + i for i in to]) for k, to in cell_refs]
    if alpha is not None:
        a_cells, a_av1c, a_grid = alpha[:3]
        first = len(items) + 1
        if a_grid is None:
            items.append((b"av01", a_cells[0]))
            assoc[first] = [prop(ispe(alpha[3] if len(alpha) > 3 else primary[2])), prop(pixi1), 0x80 | prop(a_av1c),
                            prop(auxc)]
        else:
            items.append((b"grid", a_grid))
            assoc[first] = [prop(ispe(primary[2])), prop(pixi1), prop(auxc)]
            size = alpha[3] if len(alpha) > 3 else cells[0][2]
            for c in a_cells:
                items.append((b"av01", c))
                assoc[len(items)] = [prop(ispe(size)), prop(pixi1), 0x80 | prop(a_av1c)]
            refs.append((b"dimg", first, list(range(first + 1, len(items) + 1))))
        refs.append((b"auxl", first, [1]))
        if premultiplied:
            refs.append((b"prem", 1, [first]))
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")
    hdlr = _full_box(b"hdlr", 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = _full_box(b"pitm", 0, struct.pack(">H", 1))
    infes = b"".join(_full_box(b"infe", 2, struct.pack(">HH", i + 1, 0) + kind + b"\0")
                     for i, (kind, _) in enumerate(items))
    iinf = _full_box(b"iinf", 0, struct.pack(">H", len(items)) + infes)
    iref = _full_box(b"iref", 0, b"".join(_box(k, struct.pack(">HH", f, len(t)) + b"".join(struct.pack(">H", x)
                                                                                        for x in t))
                                          for k, f, t in refs)) if refs else b""
    ipma = _full_box(b"ipma", 0, struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", i, len(a)) + bytes(a) for i, a in sorted(assoc.items())))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)

    def meta(base: int) -> bytes:
        body, at = b"", base
        for i, (_, payload) in enumerate(items):
            body += struct.pack(">HHHII", i + 1, 0, 1, at, len(payload))
            at += len(payload)
        iloc = _full_box(b"iloc", 0, bytes([0x44, 0x00]) + struct.pack(">H", len(items)) + body)
        return _full_box(b"meta", 0, hdlr + pitm + iloc + iinf + iref + iprp)

    head = ftyp + meta(0)
    head = ftyp + meta(len(head) + 8)
    return head + _box(b"mdat", b"".join(p for _, p in items))
