"""Zstandard frames (RFC 8878), as libtiff's ZSTD codec writes one for each
TIFF strip or tile and libzstd reads it back: raw, RLE and compressed
blocks; literals raw, RLE or Huffman-coded (one or four streams, the tree
given by direct or FSE-coded weights, or repeated); sequences under the
predefined, RLE, FSE-coded or repeated tables, with the three repeat
offsets. No dictionaries; the checksum is skipped. A sequential host loop
over the bits: backward bit streams read through a sliding window of bytes."""
from __future__ import annotations

from ._common import DecodeError

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                              16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)


class _Back:
    """A backward bit stream: from the bit under the last byte's highest set
    bit towards the first byte; bits past the start read as zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise DecodeError("zstd bit stream without its end mark")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo < 0:
            v = self._window(0, lo + n) << -lo if lo + n > 0 else 0
            return v & ((1 << n) - 1)
        return self._window(lo, n)

    def peek(self, n: int) -> int:
        lo = self.pos - n
        if lo < 0:
            return (self._window(0, self.pos) << -lo) & ((1 << n) - 1) if self.pos > 0 else 0
        return self._window(lo, n)

    def _window(self, lo: int, n: int) -> int:
        b0, b1 = lo >> 3, (lo + n + 7) >> 3
        return (int.from_bytes(self.data[b0:b1], "little") >> (lo & 7)) & ((1 << n) - 1)

    @property
    def overflow(self) -> bool:
        return self.pos < 0


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description (FSE_readNCount) -> (counts, accuracy log,
    the position after it)."""
    bits = int.from_bytes(data[pos:pos + 512], "little")
    used = 0

    def take(n):
        nonlocal used
        v = (bits >> used) & ((1 << n) - 1)
        used += n
        return v

    log = take(4) + 5
    if log > max_log:
        raise DecodeError("zstd FSE accuracy log too large")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            while True:
                r = take(2)
                counts += [0] * r
                if r != 3:
                    break
            if len(counts) > max_symbol:
                break
        mx = (2 * threshold - 1) - remaining
        v = (bits >> used) & (threshold - 1)
        if v < mx:
            used += nbits - 1
        else:
            v = (bits >> used) & (2 * threshold - 1)
            if v >= threshold:
                v -= mx
            used += nbits
        count = v - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise DecodeError("corrupt zstd FSE table description")
    return counts, log, pos + (used + 7) // 8


def _fse_table(counts, log: int):
    """FSE_buildDTable -> [(symbol, bits, base)] of 2^log states."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[p] = s
            p = (p + step) & (size - 1)
            while p > high:
                p = (p + step) & (size - 1)
    table = []
    for u in range(size):
        s = symbols[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        table.append((s, nb, (n << nb) - size))
    return table, log


def _huffman_weights(data: bytes, pos: int):
    """The Huffman tree description -> (weights, the position after it)."""
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = [(raw[i // 2] >> (4 if i % 2 == 0 else 0)) & 15 for i in range(n)]
        return weights, pos + (n + 1) // 2
    counts, log, at = _read_ncount(data, pos, 255, 6)
    table, log = _fse_table(counts, log)
    stream = _Back(data[at:pos + head])
    s1, s2 = stream.read(log), stream.read(log)
    weights = []
    while True:
        for cur, other in ((0, 1), (1, 0)):
            state = (s1, s2)[cur]
            sym, nb, base = table[state]
            weights.append(sym)
            new = base + stream.read(nb)
            if cur == 0:
                s1 = new
            else:
                s2 = new
            if stream.overflow:
                weights.append(table[(s1, s2)[other]][0])
                return weights, pos + head
        if len(weights) > 255:
            raise DecodeError("corrupt zstd Huffman weights")


def _huffman_table(weights):
    """Weights (the last one implied) -> (decoding table of 2^max_bits
    (symbol, bits), max_bits)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise DecodeError("zstd Huffman tree of no weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise DecodeError("zstd Huffman weights that do not complete a tree")
    weights = list(weights) + [rest.bit_length()]
    table = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                table += [(s, max_bits + 1 - w)] * (1 << (w - 1))
    return table, max_bits


def _huffman_stream(data: bytes, table, max_bits: int, n: int) -> bytes:
    stream = _Back(data)
    out = bytearray(n)
    for i in range(n):
        s, nb = table[stream.peek(max_bits)]
        out[i] = s
        stream.pos -= nb
    if stream.pos != 0:
        raise DecodeError("zstd Huffman stream not consumed exactly")
    return bytes(out)


class _Frame:
    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML
        self.reps = [1, 4, 8]
        self.out = bytearray()

    def literals(self, data: bytes, pos: int):
        b0 = data[pos]
        kind, fmt = b0 & 3, (b0 >> 2) & 3
        if kind in (0, 1):
            if fmt in (0, 2):
                size, pos = b0 >> 3, pos + 1
            elif fmt == 1:
                size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
            else:
                size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
            if kind == 0:
                lit = data[pos:pos + size]
                if len(lit) < size:
                    raise DecodeError("truncated zstd literals")
                return lit, pos + size
            return data[pos:pos + 1] * size, pos + 1
        nbytes = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
        c = int.from_bytes(data[pos:pos + nbytes], "little")
        width = {3: 10, 4: 14, 5: 18}[nbytes]
        regen, comp = (c >> 4) & ((1 << width) - 1), (c >> (4 + width)) & ((1 << width) - 1)
        streams = 1 if fmt == 0 else 4
        pos += nbytes
        end = pos + comp
        if kind == 2:
            weights, pos = _huffman_weights(data, pos)
            self.huffman = _huffman_table(weights)
        elif self.huffman is None:
            raise DecodeError("zstd treeless literals without a previous tree")
        table, max_bits = self.huffman
        if streams == 1:
            return _huffman_stream(data[pos:end], table, max_bits, regen), end
        sizes = [data[pos] | data[pos + 1] << 8, data[pos + 2] | data[pos + 3] << 8, data[pos + 4] | data[pos + 5] << 8]
        pos += 6
        each = (regen + 3) // 4
        out = b""
        for k in range(4):
            size = sizes[k] if k < 3 else end - pos
            out += _huffman_stream(data[pos:pos + size], table, max_bits, each if k < 3 else regen - 3 * each)
            pos += size
        return out, end

    def table(self, k: int, mode: int, data: bytes, pos: int):
        default, max_symbol, max_log = ((_LL_DEFAULT, 35, 9), (_OF_DEFAULT, 31, 8), (_ML_DEFAULT, 52, 9))[k]
        if mode == 0:
            self.tables[k] = _fse_table(*default)
        elif mode == 1:
            self.tables[k] = ([(data[pos], 0, 0)], 0)
            pos += 1
        elif mode == 2:
            counts, log, pos = _read_ncount(data, pos, max_symbol, max_log)
            self.tables[k] = _fse_table(counts, log)
        elif self.tables[k] is None:
            raise DecodeError("zstd repeated table without a previous one")
        return pos

    def block(self, data: bytes) -> None:
        lit, pos = self.literals(data, 0)
        b0 = data[pos] if pos < len(data) else 0
        if b0 == 0:
            self.out += lit
            return
        if b0 < 128:
            n, pos = b0, pos + 1
        elif b0 < 255:
            n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
        else:
            n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
        modes = data[pos]
        pos += 1
        for k, shift in ((0, 6), (1, 4), (2, 2)):
            pos = self.table(k, (modes >> shift) & 3, data, pos)
        (llt, lll), (oft, ofl), (mlt, mll) = self.tables
        stream = _Back(data[pos:])
        ll_s, of_s, ml_s = stream.read(lll), stream.read(ofl), stream.read(mll)
        out, reps, lp = self.out, self.reps, 0
        for i in range(n):
            of_code, ml_code, ll_code = oft[of_s][0], mlt[ml_s][0], llt[ll_s][0]
            if of_code > 31 or ml_code > 52 or ll_code > 35:
                raise DecodeError("corrupt zstd sequence codes")
            ofv = (1 << of_code) + stream.read(of_code)
            ml = _ML_BASE[ml_code] + stream.read(_ML_BITS[ml_code])
            ll = _LL_BASE[ll_code] + stream.read(_LL_BITS[ll_code])
            if ofv > 3:
                off = ofv - 3
                reps[:] = [off, reps[0], reps[1]]
            else:
                idx = ofv - 1 + (ll == 0)
                if idx == 0:
                    off = reps[0]
                elif idx == 3:
                    off = reps[0] - 1
                    reps[:] = [off, reps[0], reps[1]]
                elif idx == 1:
                    off = reps[1]
                    reps[:] = [off, reps[0], reps[2]]
                else:
                    off = reps[2]
                    reps[:] = [off, reps[0], reps[1]]
            out += lit[lp:lp + ll]
            lp += ll
            if off <= 0 or off > len(out):
                raise DecodeError("zstd match offset before the data")
            start = len(out) - off
            if off >= ml:
                out += out[start:start + ml]
            else:
                for j in range(ml):
                    out.append(out[start + j])
            if i + 1 < n:
                _, nb, base = llt[ll_s]
                ll_s = base + stream.read(nb)
                _, nb, base = mlt[ml_s]
                ml_s = base + stream.read(nb)
                _, nb, base = oft[of_s]
                of_s = base + stream.read(nb)
        out += lit[lp:]


def decompress(data: bytes, limit: int) -> bytes:
    """Zstandard frames (and skippable ones) -> their data, up to about
    `limit` bytes."""
    out = bytearray()
    pos = 0
    while pos + 4 <= len(data) and len(out) < limit:
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        if magic != 0xFD2FB528:
            raise DecodeError("no zstd frame")
        fhd = data[pos + 4]
        pos += 5
        single = fhd >> 5 & 1
        if fhd & 8:
            raise DecodeError("zstd frame header with its reserved bit set")
        if not single:
            pos += 1
        dict_id = (0, 1, 2, 4)[fhd & 3]
        if dict_id and int.from_bytes(data[pos:pos + dict_id], "little"):
            raise DecodeError("zstd frame needing a dictionary")
        pos += dict_id
        pos += (1 if single else 0, 2, 4, 8)[fhd >> 6]
        frame = _Frame()
        while True:
            if pos + 3 > len(data):
                raise DecodeError("truncated zstd block header")
            h = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, kind, size = h & 1, (h >> 1) & 3, h >> 3
            if kind == 0:
                if pos + size > len(data):
                    raise DecodeError("truncated zstd raw block")
                frame.out += data[pos:pos + size]
                pos += size
            elif kind == 1:
                frame.out += data[pos:pos + 1] * size
                pos += 1
            elif kind == 2:
                if pos + size > len(data):
                    raise DecodeError("truncated zstd block")
                frame.block(data[pos:pos + size])
                pos += size
            else:
                raise DecodeError("reserved zstd block type")
            if last:
                break
        if fhd & 4:
            pos += 4
        out += frame.out
    return bytes(out)
