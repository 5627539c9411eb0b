"""CCITT fax coding in TIFF (libtiff's tif_fax3.c, as PIL's libtiff
decoder runs it): modified Huffman (compression 2, each row byte-aligned),
its word-aligned variant (32771), Group 3 (3: an EOL before each row,
1-D, or 2-D when T4Options' first bit is set, a tag bit after each EOL
choosing) and Group 4 (4: 2-D rows against the previous one, from an
all-white line). Runs alternate white and black from white; black pixels
come out as set bits, as libtiff fills them. A sequential host loop over
the code bits, looked up in prefix dictionaries of the ITU-T T.4 tables."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 101010 "
    "101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010 "
    "00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 00101001 "
    "00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 "
    "01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 00110011 "
    "00110100")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
    "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
    "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 "
    "000000101000 000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 000001100111")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
    "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
    "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101")
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
               "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111")
_EOL = "000000000001"


def _table(term: str, makeup: str) -> dict:
    t = {c: (n, True) for n, c in enumerate(term.split())}
    t.update({c: (64 * (n + 1), False) for n, c in enumerate(makeup.split())})
    t.update({c: (1792 + 64 * n, False) for n, c in enumerate(_EXT_MAKEUP.split())})
    t["0" * 11] = (-1, True)  # an EOL, which libtiff's tables take as its eleven zeros
    return t


_RUNS = (_table(_WHITE_TERM, _WHITE_MAKEUP), _table(_BLACK_TERM, _BLACK_MAKEUP))
# 2-D mode codes -> ("P", 0) pass, ("H", 0) horizontal, ("V", d) vertical a1 = b1 + d
_MODES = {"0001": ("P", 0), "001": ("H", 0), "1": ("V", 0), "011": ("V", 1), "000011": ("V", 2),
          "0000011": ("V", 3), "010": ("V", -1), "000010": ("V", -2), "0000010": ("V", -3)}


class _Bits:
    def __init__(self, data: bytes):
        self.s = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def code(self, table: dict, longest: int = 13, strict: bool = True):
        """The next code of `table` (bits past the data read as zeros);
        None at an EOL or the end; a bad code raises, or, not `strict`,
        gives None. Not strict, the code's width comes with it."""
        s, p = self.s, self.pos
        for n in range(1, longest + 1):
            c = s[p:p + n].ljust(n, "0")
            if c in table:
                self.pos = p + n
                return table[c] if strict else table[c] + (n,)
        if not strict or s.startswith(_EOL[:-1], p) or p >= len(s):
            return None
        raise DecodeError(f"bad CCITT code at bit {p}")

    def run(self, colour: int) -> int | None:
        """One run: make-up codes, then a terminating code; None at an EOL
        or the data's end."""
        total = 0
        while True:
            got = self.code(_RUNS[colour])
            if got is None:
                return None
            n, term = got
            if n < 0:  # an EOL: left for the next row's search
                self.pos -= 11
                return None
            total += n
            if term:
                return total

    def sync_eol(self) -> bool:
        """libtiff's SYNC_EOL: on to the next EOL (eleven zero bits, then
        zero bits up to a one) and past it; False at the data's end."""
        i = self.s.find("00000000000", self.pos)
        if i < 0:
            return False
        j = self.s.find("1", i + 11)
        if j < 0:
            return False
        self.pos = j + 1
        return True


def _row_rle(bits: _Bits, width: int, word: bool, state: list[int]) -> list[int]:
    """One row of modified Huffman (RLE) as libtiff's Fax3DecodeRLE reads
    it, its bit accumulator kept as libtiff keeps it (`state`: the bytes
    loaded, the bits held): each code looked up with 12 (white) or 13
    (black) bits held, loading a byte or two; an EOL ends the row, as a
    code that is no code does (which consumes nothing), the rest of the
    row white; at the row's end the held
    bits are cut to a multiple of 8 (RLE) or 16 (RLE-W), and for RLE-W an
    emptied accumulator at an odd byte skips one. So an RLE-W row starts
    where libtiff's decoder, not the writer, puts it."""
    changes, a0, colour = [], 0, 0
    n_bytes = len(bits.s) // 8
    runlength = 0
    while a0 < width:
        wid = 12 if colour == 0 else 13
        loaded, held = state
        if held < wid:
            if loaded >= n_bytes:
                if held == 0:
                    break
                held = wid
            else:
                loaded, held = loaded + 1, held + 8
                if held < wid and loaded < n_bytes:
                    loaded, held = loaded + 1, held + 8
        state[0], state[1] = loaded, held
        got = bits.code(_RUNS[colour], wid, strict=False)
        if got is None:
            break
        n, term, width_bits = got
        state[1] -= width_bits
        if n < 0:  # an EOL, its zeros consumed
            break
        runlength += n
        if term:
            a0 += runlength
            runlength = 0
            changes.append(a0)
            colour ^= 1
    if runlength:
        a0 += runlength
        changes.append(a0)
    held = state[1]
    cut = held % (16 if word else 8)
    bits.pos += cut
    state[1] = held - cut
    if word and state[1] == 0 and state[0] % 2:
        state[0] += 1
        bits.pos = 8 * state[0]
    return changes


def _row_1d(bits: _Bits, width: int) -> list[int] | None:
    """The changing elements of one 1-D row (white first)."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        n = bits.run(colour)
        if n is None:
            break
        a0 += n
        changes.append(a0)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, ref: list[int], width: int) -> list[int]:
    """The changing elements of one 2-D row against the reference row's."""
    changes, a0, colour = [], -1, 0
    ref = ref + [width, width]
    while a0 < width:
        # b1: the reference's first change right of a0 to the colour opposite a0's
        k = 0
        while k < len(ref) and (ref[k] <= a0 if a0 >= 0 else ref[k] < 0 or False):
            k += 1
        if k % 2 != colour:
            k += 1
        b1 = ref[k] if k < len(ref) else width
        b2 = ref[k + 1] if k + 1 < len(ref) else width
        mode = bits.code(_MODES, 7)
        if mode is None:
            break
        kind, d = mode
        if kind == "P":
            a0 = b2
        elif kind == "H":
            start = max(a0, 0)
            r1 = bits.run(colour)
            r2 = bits.run(colour ^ 1)
            if r1 is None or r2 is None:
                break
            a1 = start + r1
            changes += [a1, a1 + r2]
            a0 = a1 + r2
        else:
            a1 = b1 + d
            changes.append(a1)
            a0 = a1
            colour ^= 1
    return changes


def _fill(changes: list[int], width: int) -> bytes:
    """A row's pixels from its changing elements, as libtiff's CLEANUP_RUNS
    leaves them: runs past the row's end dropped, the rest of a short row
    white."""
    while changes and changes[-1] > width:
        changes = changes[:-1]
    row = np.zeros(width, np.uint8)
    for a, b in zip(changes[0::2], changes[1::2]):
        row[max(a, 0):b] = 1
    return np.packbits(row).tobytes()


def decode(data: bytes, compression: int, width: int, rows: int, t4options: int = 0) -> bytes:
    """One strip or tile of CCITT data -> `rows` rows of packed 1-bit
    pixels (set: black), MSB first."""
    bits = _Bits(data)
    out = []
    ref: list[int] = []
    eol_seen = False
    state = [0, 0]
    for _ in range(rows):
        if compression in (2, 32771):
            changes = _row_rle(bits, width, compression == 32771, state)
        elif compression == 3:
            if not eol_seen and not bits.sync_eol():
                break
            eol_seen = False
            if t4options & 1:
                one_d = bits.s[bits.pos:bits.pos + 1] == "1"
                bits.pos += 1
                changes = _row_1d(bits, width) if one_d else _row_2d(bits, ref, width)
            else:
                changes = _row_1d(bits, width)
        else:
            changes = _row_2d(bits, ref, width)
        if changes is None:
            break
        out.append(_fill(changes, width))
        ref = [min(c, width) for c in changes]
    blank = bytes((width + 7) // 8)
    return b"".join(out) + blank * (rows - len(out))
