"""DirectDraw Surface, the first mip level, as PIL's DdsImagePlugin and
Pillow's block decoder (BcnDecode.c) read it.

Block-compressed: BC1 (DXT1, its 3-colour + black mode where c0 <= c1),
BC2 (DXT3) and BC3 (DXT5) colour (always 4 colours), BC4 (ATI1 / BC4U),
BC5 (ATI2 / BC5U, and signed BC5S with blue at 128), BC7 (every mode, partitions, p-bits,
rotation and index selection), by FourCC or the DX10 header; sizes that are
not multiples of 4 crop the last blocks. Uncompressed: RGB(A) bit masks
(each channel scaled as int(v / max * 255)), 8-bit luminance, 16-bit
luminance + alpha, 8-bit palettes, DX10 R8G8B8A8. Every block decodes at
once: the endpoints, weights and indices are numpy over the block axis,
with Pillow's integer interpolation and rounding (not the D3D
specification's). BC6H (UF16 and SF16) decodes its half floats as Pillow
does and clamps them into 0-255."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, grey_rgb, u32le

_FOURCC = {b"DXT1": 1, b"DXT3": 2, b"DXT5": 3, b"BC4U": 4, b"ATI1": 4, b"BC5S": -5, b"BC5U": 5,
           b"ATI2": 5}
# DX10 DXGI formats -> block kind (negative: signed BC5 / BC6H, "rgba": R8G8B8A8)
_DXGI = {70: 1, 71: 1, 73: 2, 74: 2, 76: 3, 77: 3, 79: 4, 80: 4, 82: 5, 83: 5, 84: -5, 95: 6, 96: -6,
         97: 7, 98: 7, 99: 7, 27: "rgba", 28: "rgba", 29: "rgba"}


def _bits(blocks: np.ndarray, start, n: int) -> np.ndarray:
    """Bits [start, start + n) of each 128-bit block (LSB first), as int64;
    `start` a scalar or one position per block."""
    lo = blocks[:, :8].copy().view("<u8")[:, 0]
    hi = blocks[:, 8:].copy().view("<u8")[:, 0]
    start = np.broadcast_to(np.asarray(start, np.int64), lo.shape)
    out = np.zeros(lo.shape, np.uint64)
    for b in range(n):
        p = start + b
        word = np.where(p < 64, lo, hi)
        out |= ((word >> (p & 63).astype(np.uint64)) & np.uint64(1)) << np.uint64(b)
    return out.astype(np.int64)


def _565(c: np.ndarray) -> np.ndarray:
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def _bc1_colour(blk: np.ndarray, four: bool) -> np.ndarray:
    """(n, 8) colour blocks -> (n, 16, 3): decode_bc1_color."""
    c0 = blk[:, 0].astype(np.int64) | blk[:, 1].astype(np.int64) << 8
    c1 = blk[:, 2].astype(np.int64) | blk[:, 3].astype(np.int64) << 8
    lut = blk[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    p0, p1 = _565(c0), _565(c1)
    mode4 = (c0 > c1)[:, None] | four
    p2 = np.where(mode4, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(mode4, (p0 + 2 * p1) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], 1)  # (n, 4, 3)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc3_channel(blk: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 8) alpha-style blocks -> (n, 16) uint8: decode_bc3_alpha."""
    if signed:
        a0 = blk[:, 0].view(np.int8).astype(np.int64) + 128
        a1 = blk[:, 1].view(np.int8).astype(np.int64) + 128
    else:
        a0, a1 = blk[:, 0].astype(np.int64), blk[:, 1].astype(np.int64)
    a0c, a1c = a0[:, None], a1[:, None]
    w = np.arange(1, 7)
    eight = ((7 - w) * a0c + w * a1c) // 7
    w4 = np.arange(1, 5)
    six = np.concatenate([((5 - w4) * a0c + w4 * a1c) // 5, np.zeros_like(a0c), np.full_like(a0c, 255)], 1)
    pal = np.concatenate([a0c, a1c, np.where((a0 > a1)[:, None], eight, six)], 1) & 0xFF
    lut = np.zeros(len(blk), np.int64)
    for i in range(6):
        lut |= blk[:, 2 + i].astype(np.int64) << (8 * i)
    idx = (lut[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(pal, idx, 1).astype(np.uint8)


# ---- BC7 ------------------------------------------------------------------------

# (subsets, partition bits, rotation bits, index selection bits, colour bits,
#  alpha bits, endpoint p-bits, shared p-bits, index bits, second index bits)
_BC7_MODES = [(3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0), (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
              (2, 6, 0, 0, 7, 0, 1, 0, 2, 0), (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0)]
_BC7_P2 = [0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80, 0xE800,
           0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
           0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA, 0xF0F0, 0x5A5A, 0x33CC,
           0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
           0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718,
           0xCCF0, 0x0FCC, 0x7744, 0xEE22]
_BC7_P3 = [0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0, 0x5A5A5050,
           0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250,
           0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500,
           0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200,
           0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
           0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600,
           0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
           0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254]
_BC7_A2 = [15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2,
           8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15,
           15, 15, 15, 2, 2, 15]
_BC7_A3A = [3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5,
            15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10,
            8, 13, 15, 12, 3, 3]
_BC7_A3B = [15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6,
            10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15,
            15, 15, 15, 15, 15, 15, 3, 15, 15, 8]
_BC7_WEIGHTS = {2: [0, 21, 43, 64], 3: [0, 9, 18, 27, 37, 46, 55, 64],
                4: [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]}


# ---- BC6H ----------------------------------------------------------------------

# (subsets, transformed (delta) endpoints, partition bits, endpoint bits,
#  red / green / blue delta bits) of modes 0-13 (BcnDecode.c's numbering)
_BC6_MODES = [(2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4), (2, 1, 5, 11, 4, 5, 4),
              (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5), (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5),
              (2, 1, 5, 8, 5, 5, 6), (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4)]
# where each endpoint bit of a mode goes: (word << 4) | bit, the words
# r0 g0 b0 r1 g1 b1 ... (the D3D specification's bit layout)
_BC6_PACKINGS = (
    (116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161,
    162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147,
    148, 179),
    (117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33,
    34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69,
    160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146,
    147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81,
    82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81,
    82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80,
    81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
    80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38,
    39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
    80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38,
    39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163,
    80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38,
    39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163,
    80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36,
    37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161,
    162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148,
    149),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83,
    84, 85, 86, 87, 88, 89),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83,
    84, 85, 86, 87, 88, 42),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83,
    84, 85, 86, 87, 43, 42),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83,
    47, 46, 45, 44, 43, 42),
)


def _bc6_unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    """Endpoints (int64 of their 16-bit words) to 16-bit (signed: 15-bit
    and sign) interpolation range, as BcnDecode.c's bc6_unquantize."""
    if not signed:
        if prec >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF, ((v << 16) + 0x8000) >> prec))
    x = ((v + 0x8000) & 0xFFFF) - 0x8000
    if prec >= 16:
        return x
    s, a = x < 0, np.abs(x)
    a = np.where(a == 0, 0, np.where(a >= (1 << (prec - 1)) - 1, 0x7FFF, ((a << 15) + 0x4000) >> (prec - 1)))
    return np.where(s, -a, a)


def _bc6_channel(v: np.ndarray, signed: bool) -> np.ndarray:
    """bc6_finalize (to a half float's bits, scaled by 31/64 or 31/32),
    then clamped into [0, 1] and times 255 in float32, truncated."""
    if signed:
        half = np.where(v < 0, 0x8000 | ((-v * 31) // 32), (v * 31) // 32)
    else:
        half = (v * 31) // 64
    f = (half & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    with np.errstate(invalid="ignore"):
        scaled = f * np.float32(255.0)
        return np.where(f > 1, 255, np.where((f < 0) | np.isnan(f), 0, np.nan_to_num(scaled))).astype(np.uint8)


def _bc6(blk: np.ndarray, signed: bool) -> np.ndarray:
    """(n, 16) BC6H blocks -> (n, 16, 3): BcnDecode.c's decode_bc6_block
    and bc6_clamp; reserved modes decode to black."""
    n = len(blk)
    out = np.zeros((n, 16, 3), np.uint8)
    low = blk[:, 0].astype(np.int64) & 0x1F
    mode = np.where(low & 3 < 2, low & 3, np.where(low & 3 == 2, 2 + (low >> 2), 10 + (low >> 2)))
    for m in range(14):
        sel = mode == m
        if not sel.any():
            continue
        b = blk[sel]
        ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[m]
        start, epbits = (2, 75) if m < 2 else (5, 72) if m < 10 else (5, 60)
        ib = 4 if m >= 10 else 3
        ep = np.zeros((len(b), 12), np.int64)
        for i, d in enumerate(_BC6_PACKINGS[m][:epbits]):
            ep[:, d >> 4] |= _bits(b, start + i, 1) << (d & 15)
        bit = start + epbits
        part = _bits(b, bit, pb)
        bit += pb
        ne = 12 if ns == 2 else 6

        def sext(v, prec):
            return np.where(v & (1 << (prec - 1)), v | (-1 << prec), v) & 0xFFFF

        if signed:
            ep[:, :3] = sext(ep[:, :3], epb)
        if signed or tr:
            for i in range(3, ne, 3):
                for c, w in enumerate((rb, gb, bb)):
                    ep[:, i + c] = sext(ep[:, i + c], w)
        if tr:  # deltas from e0, kept to epb bits (Pillow does not sign-extend the sum)
            mask = (1 << epb) - 1
            for i in range(3, ne, 3):
                ep[:, i:i + 3] = (ep[:, i:i + 3] + ep[:, :3]) & mask
        ue = _bc6_unquantize(ep[:, :ne], epb, signed)
        idx = np.arange(16)
        if ns == 2:
            subset = (np.array(_BC7_P2)[part][:, None] >> idx) & 1
            anchor = (idx == 0) | (idx == np.array(_BC7_A2)[part][:, None])
        else:
            subset = np.zeros((len(b), 16), np.int64)
            anchor = np.broadcast_to(idx == 0, (len(b), 16))
        w = np.array(_BC7_WEIGHTS[ib])
        wi = np.zeros((len(b), 16), np.int64)
        pos = np.full(len(b), bit, np.int64)
        for t in range(16):
            width = ib - anchor[:, t].astype(np.int64)
            for k in np.unique(width):
                mk = width == k
                wi[mk, t] = _bits(b[mk], pos[mk], int(k))
            pos += width
        s = w[wi][..., None]
        rows = np.arange(len(b))[:, None, None]
        e0 = ue[rows, (6 * subset)[..., None] + np.arange(3)]
        e1 = ue[rows, (6 * subset + 3)[..., None] + np.arange(3)]
        out[sel] = _bc6_channel((e0 * (64 - s) + e1 * s) >> 6, signed)
    return out


def _expand(v: np.ndarray, bits: int) -> np.ndarray:
    """expand_quantized on UINT8: v << (8 - bits) kept to 8 bits, then
    v | v >> bits."""
    v = (v << (8 - bits)) & 0xFF
    return v | (v >> bits)


def _bc7_mode(blk: np.ndarray, mode: int) -> np.ndarray:
    """(n, 16) blocks of one BC7 mode -> (n, 16, 4) RGBA."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    n = len(blk)
    bit = mode + 1
    part = _bits(blk, bit, pb)
    bit += pb
    rot = _bits(blk, bit, rb)
    bit += rb
    isel = _bits(blk, bit, isb)
    bit += isb
    ne = 2 * ns
    ep = np.zeros((n, ne, 4), np.int64)
    for ch in range(3):
        for e in range(ne):
            ep[:, e, ch] = _bits(blk, bit, cb)
            bit += cb
    for e in range(ne):
        if ab:
            ep[:, e, 3] = _bits(blk, bit, ab)
            bit += ab
        else:
            ep[:, e, 3] = 255
    cbits, abits = cb, ab
    chans = 4 if ab else 3
    if epb or spb:
        cbits += 1
        abits += 1 if ab else 0
        for e in range(ne):
            if epb or e % 2 == 0:
                p = _bits(blk, bit, 1)
                bit += 1
            ep[:, e, :chans] = ((ep[:, e, :chans] << 1) | p[:, None]) & 0xFF
    ep[..., :3] = _expand(ep[..., :3], cbits)
    if ab:
        ep[..., 3] = _expand(ep[..., 3], abits)
    # per texel: its subset and whether it is an anchor (one index bit less)
    idx = np.arange(16)
    if ns == 1:
        subset = np.zeros((n, 16), np.int64)
        anchor = np.broadcast_to(idx == 0, (n, 16))
    elif ns == 2:
        subset = (np.array(_BC7_P2)[part][:, None] >> idx) & 1
        anchor = (idx == 0) | (idx == np.array(_BC7_A2)[part][:, None])
    else:
        subset = (np.array(_BC7_P3)[part][:, None] >> (2 * idx)) & 3
        anchor = (idx == 0) | (idx == np.array(_BC7_A3A)[part][:, None]) | (
            idx == np.array(_BC7_A3B)[part][:, None])
    cw = np.array(_BC7_WEIGHTS[ib])
    aw = np.array(_BC7_WEIGHTS[ib2 if ab and ib2 else ib])
    ci = np.zeros((n, 16), np.int64)
    ai = np.zeros((n, 16), np.int64)
    cpos = np.full(n, bit, np.int64)
    apos = cpos + 16 * ib - ns
    for t in range(16):
        width = ib - anchor[:, t].astype(np.int64)
        for w in np.unique(width):
            m = width == w
            ci[m, t] = _bits(blk[m], cpos[m], int(w))
        cpos += width
        if ab and ib2:
            w2 = ib2 - (1 if t == 0 else 0)
            ai[:, t] = _bits(blk, apos, w2)
            apos += w2
    e0 = np.take_along_axis(ep, (2 * subset)[..., None], 1)  # (n, 16, 4)
    e1 = np.take_along_axis(ep, (2 * subset + 1)[..., None], 1)
    if ab and ib2:
        sc, sa = cw[ci], aw[ai]
        s_rgb = np.where(isel[:, None] == 1, sa, sc)
        s_a = np.where(isel[:, None] == 1, sc, sa)
    else:
        s_rgb = s_a = cw[ci]
    s = np.concatenate([np.repeat(s_rgb[..., None], 3, -1), s_a[..., None]], -1)
    col = (((64 - s) * e0 + s * e1 + 32) >> 6) & 0xFF
    for r in (1, 2, 3):  # rotation: swap a colour channel with alpha
        m = rot == r
        if m.any():
            col[m, :, r - 1], col[m, :, 3] = col[m, :, 3].copy(), col[m, :, r - 1].copy()
    return col


def _bc7(blk: np.ndarray) -> np.ndarray:
    """(n, 16) BC7 blocks -> (n, 16, 3): the mode is the lowest set bit of
    byte 0; a zero byte decodes to black."""
    out = np.zeros((len(blk), 16, 4), np.int64)
    first = blk[:, 0].astype(np.int64)
    mode = np.full(len(blk), -1)
    for m in range(7, -1, -1):
        mode[(first >> m) & 1 == 1] = m
    for m in range(8):
        sel = mode == m
        if sel.any():
            out[sel] = _bc7_mode(blk[sel], m)
    return out[..., :3]


def _blocks(data: bytes, pos: int, width: int, height: int, size: int) -> np.ndarray:
    bw, bh = -(-width // 4), -(-height // 4)
    n = bw * bh * size
    raw = data[pos:pos + n]
    if len(raw) < n:
        raise DecodeError("truncated DDS image")
    return np.frombuffer(raw, np.uint8).reshape(bw * bh, size)


def _tile(px: np.ndarray, width: int, height: int) -> np.ndarray:
    """(blocks, 16, C) texels in block raster order -> (height, width, C)."""
    bw, bh = -(-width // 4), -(-height // 4)
    img = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, -1)
    return img[:height, :width]


def _masked(data: bytes, pos: int, width: int, height: int, bitcount: int, masks) -> np.ndarray:
    """DdsRgbDecoder: each channel (v & mask) >> its trailing zeros, then
    int(v / (mask >> zeros) * 255); a zero mask reads 0."""
    size = bitcount // 8
    n = width * height
    raw = data[pos:pos + n * size]
    if len(raw) < n * size or size < 1:
        raise DecodeError("truncated DDS image")
    b = np.frombuffer(raw, np.uint8).reshape(n, size).astype(np.int64)
    v = np.zeros(n, np.int64)
    for i in range(size):
        v |= b[:, i] << (8 * i)
    out = []
    for mask in masks[:3]:
        if not mask:
            out.append(np.zeros(n, np.int64))
            continue
        off = (mask & -mask).bit_length() - 1
        total = mask >> off
        out.append(np.floor(((v & mask) >> off) / total * 255).astype(np.int64))
    return np.stack(out, -1).astype(np.uint8).reshape(height, width, 3)


def rgb8(data: bytes) -> np.ndarray:
    if len(data) < 8 or u32le(data, 4) != 124:
        raise DecodeError(f"Unsupported DDS header size {u32le(data, 4) if len(data) >= 8 else None}")
    if len(data) < 128:
        raise DecodeError("Incomplete DDS header")
    height, width = u32le(data, 12), u32le(data, 16)
    pf_flags, fourcc, bitcount = u32le(data, 80), data[84:88], u32le(data, 88)
    pos = 128
    if pf_flags & 0x40:  # DDPF_RGB: bit masks
        masks = [u32le(data, 92 + 4 * i) for i in range(4 if pf_flags & 0x1 else 3)]
        return _masked(data, pos, width, height, bitcount, masks)
    if pf_flags & 0x20000:  # DDPF_LUMINANCE
        if bitcount == 8:
            raw = data[pos:pos + width * height]
            if len(raw) < width * height:
                raise DecodeError("truncated DDS image")
            return grey_rgb(np.frombuffer(raw, np.uint8).reshape(height, width))
        if bitcount == 16 and pf_flags & 0x1:
            raw = data[pos:pos + 2 * width * height]
            if len(raw) < 2 * width * height:
                raise DecodeError("truncated DDS image")
            return grey_rgb(np.frombuffer(raw, np.uint8).reshape(height, width, 2)[..., 0])
        raise DecodeError(f"Unsupported DDS luminance bitcount {bitcount}")
    if pf_flags & 0x20:  # DDPF_PALETTEINDEXED8: an RGBA palette, then indices
        pal = np.frombuffer(data[pos:pos + 1024].ljust(1024, b"\0"), np.uint8).reshape(256, 4)[:, :3]
        pos += 1024
        raw = data[pos:pos + width * height]
        if len(raw) < width * height:
            raise DecodeError("truncated DDS image")
        return pal[np.frombuffer(raw, np.uint8).reshape(height, width)]
    if not pf_flags & 0x4:
        raise DecodeError(f"Unknown DDS pixel format flags {pf_flags}")
    if fourcc == b"DX10":
        dxgi = u32le(data, 128)
        pos += 20
        if dxgi not in _DXGI:
            raise DecodeError(f"Unimplemented DXGI format {dxgi}")
        kind = _DXGI[dxgi]
    elif fourcc in _FOURCC:
        kind = _FOURCC[fourcc]
    else:
        raise DecodeError(f"Unimplemented DDS pixel format {fourcc!r}")
    if kind == "rgba":
        n = width * height * 4
        raw = data[pos:pos + n]
        if len(raw) < n:
            raise DecodeError("truncated DDS image")
        return np.frombuffer(raw, np.uint8).reshape(height, width, 4)[..., :3].copy()
    if kind in (1, 4):
        blk = _blocks(data, pos, width, height, 8)
        px = _bc1_colour(blk, False) if kind == 1 else np.repeat(_bc3_channel(blk)[..., None], 3, -1)
    elif kind in (2, 3):
        px = _bc1_colour(_blocks(data, pos, width, height, 16)[:, 8:], True)
    elif kind in (5, -5):
        blk = _blocks(data, pos, width, height, 16)
        r, g = _bc3_channel(blk[:, :8], kind < 0), _bc3_channel(blk[:, 8:], kind < 0)
        px = np.stack([r, g, np.full_like(r, 128 if kind < 0 else 0)], -1)  # blue: signed zero
    elif kind in (6, -6):
        px = _bc6(_blocks(data, pos, width, height, 16), kind < 0)
    else:
        px = _bc7(_blocks(data, pos, width, height, 16))
    return np.ascontiguousarray(_tile(px, width, height).astype(np.uint8))
