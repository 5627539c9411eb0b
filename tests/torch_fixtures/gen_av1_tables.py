"""Write optixpathtracer_tpu_torch/csrc/host/av1_tables.h: the AV1 default
CDFs a key frame reads (the delta q, delta lf and segment id ones too), the quantizer
lookups at 8, 10 and 12 bits, the quantizer matrices and each transform
size's offset into them, the directional derivatives, the smooth weights,
the filter-intra taps, the transform rotation constants, the tables of CDEF,
superres and loop restoration, and film grain's Gaussian sequence (AV1 Bitstream &
Decoding Process Specification, section 9.3 and the tables of 7.11-7.18).

The values are those of the specification. They are read here from the
read-only data of the libavif that PIL bundles, which links libaom (each
CDF stored as `32768 - v`, a table's rows padded to its widest symbol
count, a counter slot after each row) and dav1d (rows of `32768 - v`
without the final 32768); each table is found at the offset of its first
row and read with its published shape, and the header keeps the spec's
own form: increasing values ending in 32768, then the adaptation counter
(0). CDEF's directions (libaom's offsets into its 144-wide buffer), its
chroma direction remap for 4:2:2 and 4:4:0, its primary taps and
divisors, superres's upscaling filter (libaom's), and the self-guided filter's parameters (libaom's {r0, r1},
{e0, e1}) are read from the library too; the few rows too short to find
there (CDEF's secondary taps, the Wiener and self-guided coefficient
ranges) are typed as the specification prints them. The quantizer matrices
are libaom's inverse weights (iwt_matrix_ref, the spec's Quantizer_Matrix);
Qm_Offset is where each transform size's matrix starts in a level's row,
computed here as libaom lays the matrices out (in transform-size order, a
64-point size sharing its 32-point matrix). The Gaussian sequence is
dav1d's.
tests/test_torch_codecs_avif_tables.py finds every row of the header in the
same library again, and holds the first rows to the specification.

Run from the repository root: python tests/torch_fixtures/gen_av1_tables.py
"""
from __future__ import annotations

import glob
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(REPO, "optixpathtracer_tpu_torch", "csrc", "host", "av1_tables.h")


def library_path() -> str:
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    return sorted(glob.glob(os.path.join(libs, "libavif*.so*")))[0]


def rodata(path: str) -> bytes:
    """The .rodata section of an ELF64 shared library."""
    data = open(path, "rb").read()
    shoff = int.from_bytes(data[0x28:0x30], "little")
    shentsize, shnum, shstrndx = (int.from_bytes(data[o:o + 2], "little") for o in (0x3A, 0x3C, 0x3E))
    secs = [data[shoff + i * shentsize: shoff + (i + 1) * shentsize] for i in range(shnum)]
    stroff = int.from_bytes(secs[shstrndx][0x18:0x20], "little")
    for s in secs:
        name = data[stroff + int.from_bytes(s[0:4], "little"):].split(b"\0", 1)[0]
        if name == b".rodata":
            off, size = int.from_bytes(s[0x18:0x20], "little"), int.from_bytes(s[0x20:0x28], "little")
            return data[off:off + size]
    raise ValueError("no .rodata")


# (name, spec dims, symbols, the first row's spec values: the anchor that
# locates the table, the row stride in uint16, "aom" or "dav1d" layout)
CDFS = [
    ("Default_Intra_Frame_Y_Mode_Cdf", (5, 5), 13, (15588, 17027, 19338, 20218), 14, "aom"),
    ("Default_Angle_Delta_Cdf", (8,), 7, (2180, 5032, 7567, 22776), 8, "aom"),
    ("Default_Uv_Mode_Cfl_Not_Allowed_Cdf", (13,), 13, (22631, 24152, 25378, 25661), 15, "aom"),
    ("Default_Uv_Mode_Cfl_Allowed_Cdf", (13,), 14, (10407, 11208, 12900, 13181), 15, "aom"),
    ("Default_Partition_W8_Cdf", (4,), 4, (19132, 25510, 30392), 11, "aom"),
    ("Default_Partition_W16_Cdf", (4,), 10, (15597, 20929, 24571, 26706), 11, "aom"),
    ("Default_Partition_W32_Cdf", (4,), 10, None, 11, "aom", ("Default_Partition_W16_Cdf", 4)),
    ("Default_Partition_W64_Cdf", (4,), 10, None, 11, "aom", ("Default_Partition_W16_Cdf", 8)),
    ("Default_Partition_W128_Cdf", (4,), 8, (27899, 28219, 28529, 32484), 11, "aom"),
    ("Default_Intra_Tx_Type_Set1_Cdf", (4, 13), 7, (1535, 8035, 9461, 12751), 17, "aom"),
    ("Default_Intra_Tx_Type_Set2_Cdf", (4, 13), 5, None, 17, "aom", ("Default_Intra_Tx_Type_Set1_Cdf", 52)),
    ("Default_Inter_Tx_Type_Set1_Cdf", (4,), 16, (4458, 5560, 7695, 9709), 17, "aom"),
    ("Default_Inter_Tx_Type_Set2_Cdf", (4,), 12, None, 17, "aom", ("Default_Inter_Tx_Type_Set1_Cdf", 4)),
    ("Default_Inter_Tx_Type_Set3_Cdf", (4,), 2, None, 17, "aom", ("Default_Inter_Tx_Type_Set1_Cdf", 8)),
    ("Default_Cfl_Sign_Cdf", (), 8, (1418, 2123, 13340, 18405), 8, "dav1d"),
    ("Default_Cfl_Alpha_Cdf", (6,), 16, (7637, 20719, 31401, 32481), 17, "aom"),
    ("Default_Filter_Intra_Cdf", (22,), 2, (4621, 6743, 5893), 3, "aom"),
    ("Default_Filter_Intra_Mode_Cdf", (), 5, (8949, 12776, 17211, 29558), 5, "dav1d"),
    ("Default_Palette_Y_Mode_Cdf", (7, 3), 2, (31676, 3419, 1261, 31912), 3, "aom"),
    ("Default_Palette_Uv_Mode_Cdf", (2,), 2, (32461, 21488), 2, "dav1d"),
    ("Default_Palette_Y_Size_Cdf", (7,), 7, (7952, 13000, 18149, 21478), 8, "aom"),
    ("Default_Palette_Uv_Size_Cdf", (7,), 7, (8713, 19979, 27128, 29609), 8, "aom"),
    ("Default_Palette_Y_Color_Cdf", (7, 5), 2, (28710, 16384, 10553, 27036), 9, "aom"),
    ("Default_Palette_Uv_Color_Cdf", (7, 5), 2, (29089, 16384, 8713, 29257), 9, "aom"),
    ("Default_Tx_8x8_Cdf", (3,), 2, (19968, 19968, 24320), 4, "aom"),
    ("Default_Tx_16x16_Cdf", (3,), 3, (12272, 30172), 4, "aom"),
    ("Default_Tx_32x32_Cdf", (3,), 3, None, 4, "aom", ("Default_Tx_16x16_Cdf", 3)),
    ("Default_Tx_64x64_Cdf", (3,), 3, None, 4, "aom", ("Default_Tx_16x16_Cdf", 6)),
    ("Default_Txfm_Split_Cdf", (21,), 2, (28581, 23846, 20847), 3, "aom"),
    ("Default_Skip_Cdf", (3,), 2, (31671, 16515, 4576), 2, "dav1d"),
    ("Default_Intrabc_Cdf", (), 2, (30531,), 2, "dav1d"),
    ("Default_Mv_Joint_Cdf", (), 4, (4096, 11264, 19328), 5, "aom"),
    ("Default_Mv_Class_Cdf", (), 11, (28672, 30976, 31858, 32320), 12, "aom"),
    ("Default_Mv_Sign_Cdf", (), 2, None, 3, "aom", ("Default_Mv_Class_Cdf", 12 + 15, "raw")),
    ("Default_Mv_Class0_Bit_Cdf", (), 2, None, 3, "aom", ("Default_Mv_Class_Cdf", 12 + 15 + 9, "raw")),
    ("Default_Mv_Bit_Cdf", (10,), 2, None, 3, "aom", ("Default_Mv_Class_Cdf", 12 + 15 + 12, "raw")),
    ("Default_Txb_Skip_Cdf", (4, 5, 13), 2, (31849,), 3, "aom"),
    ("Default_Eob_Pt_16_Cdf", (4, 2, 2), 5, (840, 1039, 1980, 4895), 6, "aom"),
    ("Default_Eob_Pt_32_Cdf", (4, 2, 2), 6, (400, 520, 977, 2102), 7, "aom"),
    ("Default_Eob_Pt_64_Cdf", (4, 2, 2), 7, (329, 498, 1101, 1784), 8, "aom"),
    ("Default_Eob_Pt_128_Cdf", (4, 2, 2), 8, (219, 482, 1140, 2091), 9, "aom"),
    ("Default_Eob_Pt_256_Cdf", (4, 2, 2), 9, (310, 584, 1887, 3589), 10, "aom"),
    ("Default_Eob_Pt_512_Cdf", (4, 2, 2), 10, (641, 983, 3707, 5430), 11, "aom"),
    ("Default_Eob_Pt_1024_Cdf", (4, 2, 2), 11, (393, 421, 751, 1623), 12, "aom"),
    ("Default_Eob_Extra_Cdf", (4, 5, 2, 9), 2, (16961,), 3, "aom"),
    ("Default_Dc_Sign_Cdf", (4, 2, 3), 2, (16000,), 3, "aom"),
    ("Default_Coeff_Base_Eob_Cdf", (4, 5, 2, 4), 3, (17837, 29055), 4, "aom"),
    ("Default_Coeff_Base_Cdf", (4, 5, 2, 42), 4, (4034, 8930, 12727), 5, "aom"),
    ("Default_Coeff_Br_Cdf", (4, 5, 2, 21), 4, (14298, 20718, 24174), 5, "aom"),
    ("Default_Restoration_Type_Cdf", (), 3, (9413, 22581), 4, "dav1d"),
    ("Default_Use_Wiener_Cdf", (), 2, None, 2, "dav1d", ("Default_Restoration_Type_Cdf", 4, "raw")),
    ("Default_Use_Sgrproj_Cdf", (), 2, None, 2, "dav1d", ("Default_Restoration_Type_Cdf", 6, "raw")),
    ("Default_Segment_Id_Cdf", (3,), 8, (5622, 7893, 16093, 18233), 8, "dav1d"),
    # what an inter frame reads (AVIF step 7): the intra Y mode by size
    # group, is_inter, the single references, the inter modes and the DRL
    # index, the interpolation filter, the fractional and high-precision
    # MV parts (in libaom's nmv_component after the class CDF)
    ("Default_Y_Mode_Cdf", (4,), 13, (22801, 23489, 24293, 24756), 14, "aom"),
    ("Default_Is_Inter_Cdf", (4,), 2, (806, 16662, 20186, 26538), 2, "dav1d"),
    ("Default_Single_Ref_Cdf", (3, 6), 2, (4897, 1555, 4236, 8650), 3, "aom"),
    ("Default_New_Mv_Cdf", (6,), 2, (24035, 16630, 15339, 8386), 3, "aom"),
    ("Default_Zero_Mv_Cdf", (2,), 2, (2175, 1054), 2, "dav1d"),
    ("Default_Ref_Mv_Cdf", (6,), 2, (23974, 24188, 17848, 28622), 3, "aom"),
    ("Default_Drl_Mode_Cdf", (3,), 2, (13104, 24560, 18945), 2, "dav1d"),
    ("Default_Interp_Filter_Cdf", (16,), 3, (31935, 32720), 4, "aom"),
    ("Default_Mv_Class0_Fr_Cdf", (2,), 4, None, 5, "aom", ("Default_Mv_Class_Cdf", 12, "raw")),
    ("Default_Mv_Fr_Cdf", (), 4, None, 5, "aom", ("Default_Mv_Class_Cdf", 12 + 10, "raw")),
    ("Default_Mv_Class0_Hp_Cdf", (), 2, None, 3, "aom", ("Default_Mv_Class_Cdf", 12 + 15 + 3, "raw")),
    ("Default_Mv_Hp_Cdf", (), 2, None, 3, "aom", ("Default_Mv_Class_Cdf", 12 + 15 + 6, "raw")),
]
# the predicted segment id's CDF (three rows of 16384) cannot be told
# apart in the library: typed from the specification, as the short rows
# below
SPEC_CDFS = {"Default_Segment_Id_Predicted_Cdf": ((3,), [[16384, 32768, 0]] * 3)}
# too short to locate in the library: typed from the specification
SPEC = {
    "Cdef_Sec_Taps": [[2, 1], [2, 1]],
    "Wiener_Taps_Min": [-5, -23, -17],
    "Wiener_Taps_Max": [10, 8, 46],
    "Wiener_Taps_K": [1, 2, 3],
    "Sgrproj_Xqd_Min": [-96, -32],
    "Sgrproj_Xqd_Max": [31, 95],
    "Sgrproj_Xqd_Mid": [-32, 31],
}
SHAPES = {"Subpel_Filters": "[6][16][8]", "Quantizer_Matrix": "[15][2][3344]", "Dc_Qlookup": "[3][256]", "Ac_Qlookup": "[3][256]", "Filter_Intra_Taps": "[5][8][7]", "Sgr_Params": "[16][4]", "Cdef_Uv_Dir": "[2][2][8]",
          "Cdef_Directions": "[8][2][2]", "Cdef_Pri_Taps": "[2][2]", "Cdef_Sec_Taps": "[2][2]",
          "Upscale_Filter": "[64][8]"}

# (width, height) of TX_4X4 .. TX_64X16, the specification's order
TX_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16),
            (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]


def find(ro: bytes, words: np.ndarray, start: int = 0) -> int:
    at = ro.find(words.astype("<u2").tobytes(), start)
    while at >= 0 and at % 2:
        at = ro.find(words.astype("<u2").tobytes(), at + 1)
    return at


def anchor(ro: bytes, first: tuple, stride: int, layout: str, symbols) -> int:
    """Byte offset of the table whose first rows start with `first`: the
    values of its first row, or for a binary table the first value of each
    of its first rows (rows `stride` words apart in aom's layout, 2 in
    dav1d's), each row of aom's closed by its 32768 and counter."""
    words = np.frombuffer(ro[:len(ro) // 2 * 2], "<u2")
    if symbols == 2 or first[0] in (28710, 29089):
        step = 2 if layout == "dav1d" else stride
        want = [(i * step, 32768 - v) for i, v in enumerate(first)]
        if layout == "aom":
            want += [(i * step + k, 0) for i in range(len(first)) for k in (1, 2)]
    else:
        want = [(i, 32768 - v) for i, v in enumerate(first)]
    hits = np.nonzero(words == want[0][1])[0]
    found = [int(h) * 2 for h in hits if all(h + o < len(words) and words[h + o] == v for o, v in want)]
    if not found:
        raise ValueError(f"anchor {first} not found")
    return found


def read_rows(ro: bytes, at: int, n_rows: int, stride: int, symbols, layout: str) -> np.ndarray:
    """n_rows CDF rows (spec form, symbols + 1 entries: values .. 32768, 0)."""
    words = np.frombuffer(ro, "<u2", count=n_rows * stride, offset=at).astype(np.int64).reshape(n_rows, stride)
    rows = []
    for r, w in enumerate(words):
        n = symbols[r] if isinstance(symbols, list) else symbols
        vals = list(32768 - w[:n - 1]) + [32768, 0]
        if layout == "aom":
            assert w[n - 1] == 0 and w[n] == 0, (at, r, list(w))
        assert all(0 < v <= 32768 for v in vals[:-1]) and vals[:-1] == sorted(vals[:-1]), (at, r, vals)
        rows.append(vals)
    return rows


def tables(ro: bytes) -> dict:
    out, where = {}, {}
    for entry in CDFS:
        name, dims, symbols, first, stride, layout = entry[:6]
        n_rows = int(np.prod(dims)) if dims else 1
        if name.startswith("Default_Palette_") and name.endswith("_Color_Cdf"):
            symbols = [2 + r // 5 for r in range(35)]
        if first is not None:
            for at in anchor(ro, first, stride, layout, symbols):
                try:  # the first place where the whole table parses
                    read_rows(ro, at, n_rows, stride, symbols, layout)
                    break
                except AssertionError:
                    continue
            else:
                raise ValueError(f"{name}: no parse")
        else:
            base, skip = entry[6][0], entry[6][1]
            at = where[base][0] + 2 * skip * (where[base][1] if len(entry[6]) == 2 else 1)
        where[name] = (at, stride)
        if layout == "dav1d":
            # rows of (symbols - 1) values and a counter, 2 words a binary row
            step = 2 if symbols == 2 else stride
            words = np.frombuffer(ro, "<u2", count=n_rows * step, offset=at).astype(np.int64).reshape(n_rows, step)
            rows = [list(32768 - w[:symbols - 1]) + [32768, 0] for w in words]
        else:
            rows = read_rows(ro, at, n_rows, stride, symbols, layout)
        out[name] = (dims, rows)
    return out


def delta_cdfs(ro: bytes) -> dict:
    """The delta q and delta lf CDFs (4 symbols each, all six rows
    28160, 32120, 32677): dav1d's block of delta_q, then delta_lf[5], the
    single one first and the FRAME_LF_COUNT of delta_lf_multi after it,
    each row three values and a counter."""
    row = [32768 - v for v in (28160, 32120, 32677)] + [0]
    at = find(ro, np.array(row * 6))
    assert at >= 0, "delta CDFs not found"
    rows = [list(32768 - w[:3]) + [32768, 0]
            for w in np.frombuffer(ro, "<u2", count=24, offset=at).astype(np.int64).reshape(6, 4)]
    return {"Default_Delta_Q_Cdf": ((), rows[:1]), "Default_Delta_Lf_Cdf": ((), rows[1:2]),
            "Default_Delta_Lf_Multi_Cdf": ((4,), rows[2:])}


def scalars(ro: bytes) -> dict:
    """The tables that are not CDFs, located by their first values."""
    def grab(first, dtype, count):
        at = find(ro, np.array(first)) if dtype == "<u2" else ro.find(np.array(first, dtype).tobytes())
        assert at >= 0, first
        return np.frombuffer(ro, dtype, count=count, offset=at).astype(int).tolist()
    # libaom's dc_qlookup_QTX / ac_qlookup_QTX and their _10_ and _12_ twins
    dc = [grab([4, 8, 8, 9, 10, 11, 12, 12, 13, 14], "<i2", 256), grab([4, 9, 10, 13, 15, 17, 20, 22], "<i2", 256),
          grab([4, 12, 18, 25, 33, 41, 50, 60], "<i2", 256)]
    ac = [grab([4, 8, 9, 10, 11, 12, 13, 14, 15, 16], "<i2", 256), grab([4, 9, 11, 13, 16, 18, 21, 24], "<i2", 256),
          grab([4, 13, 19, 27, 35, 44, 54, 64], "<i2", 256)]
    assert [r[-1] for r in dc] == [1336, 5347, 21387] and [r[-1] for r in ac] == [1828, 7312, 29247], (dc, ac)
    drd = grab([0, 0, 0, 1023, 0, 0, 547, 0, 0, 372], "<i2", 90)
    sm = grab([255, 149, 85, 64, 255, 197, 146, 105], "u1", 4 + 8 + 16 + 32 + 64)
    taps = np.frombuffer(ro, "i1", count=5 * 8 * 8,
                         offset=ro.find(np.array([-6, 10, 0, 0, 0, 12, 0, 0], "i1").tobytes()))
    taps = taps.reshape(5, 8, 8)[:, :, :7].tolist()
    cos = grab([4096, 4095, 4091, 4085, 4076, 4065], "<i4", 64) + [0]
    sinpi = grab([0, 1321, 2482, 3344, 3803], "<i4", 5)
    # libaom's sgr_params: {r0, r1}, {e0, e1}; the spec's rows are r0, e0, r1, e1
    sgr = np.array(grab([2, 1, 140, 3236], "<i4", 64)).reshape(16, 2, 2).transpose(0, 2, 1).reshape(16, 4)
    div = grab([0, 840, 420, 280, 210, 168, 140, 120, 105], "<i4", 9)
    conv440 = grab([1, 2, 2, 2, 3, 4, 6, 0], "<i4", 8)
    conv422 = grab([7, 0, 2, 4, 5, 6, 6, 6], "<i4", 8)
    ident = list(range(8))
    # libaom's cdef_directions_padded: directions 6, 7, 0-7, 0, 1 as offsets
    # row * 144 + column into its filter buffer
    padded = np.array(grab([144, 288, 144, 287, -143, -286], "<i4", 24)).reshape(12, 2)[2:10]
    rows = np.rint(padded / 144).astype(int)
    dirs = np.stack([rows, padded - 144 * rows], -1)
    pri = grab([4, 2, 3, 3], "<i4", 4)
    mid = grab([3, -7, 15, 106], "<i4", 3)
    # libaom's iwt_matrix_ref: the spec's Quantizer_Matrix, levels 0-14 of
    # inverse weights for luma and chroma, each level's matrices laid out in
    # transform-size order, a 64-point size sharing its 32-point matrix
    qm = grab([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200], "u1", 15 * 2 * 3344)
    offset, start, total = [], {}, 0
    for w, h in TX_SIZES:
        adj = (min(w, 32), min(h, 32))
        if adj not in start:
            start[adj] = total
            total += adj[0] * adj[1]
        offset.append(start[adj])
    assert total == 3344, total  # QM_TOTAL_SIZE
    # dav1d's gaussian_sequence, the film grain's white noise (7.18.3.3)
    gauss = grab([56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224, 1248], "<i2", 2048)
    # libaom's av1_resize_filter_normative: superres's 8-tap filters, 64
    # phases (7.16), found by its first two rows
    upscale = grab([0, 0, 0, 128, 0, 0, 0, 0, 0, 0, -1, 128, 2, -1, 0, 0], "<i2", 64 * 8)
    # libaom's sub-pixel filters (7.11.3.4), 16 phases of 8 taps each, in
    # the specification's order: regular, smooth, sharp, bilinear, then the
    # 4-tap regular and smooth of blocks 4 samples wide or high; each found
    # by its second row
    subpel = [grab(row, "<i2", 16 * 8) for row in (
        [0, 0, 0, 128, 0, 0, 0, 0, 0, 2, -6, 126, 8, -2, 0, 0], [0, 0, 0, 128, 0, 0, 0, 0, 0, 2, 28, 62, 34, 2, 0, 0],
        [0, 0, 0, 128, 0, 0, 0, 0, -2, 2, -6, 126, 8, -2, 2, 0], [0, 0, 0, 128, 0, 0, 0, 0, 0, 0, 0, 120, 8, 0, 0, 0],
        [0, 0, 0, 128, 0, 0, 0, 0, 0, 0, -4, 126, 8, -2, 0, 0], [0, 0, 0, 128, 0, 0, 0, 0, 0, 0, 30, 62, 34, 2, 0, 0])]
    assert all(sum(r[8 * k:8 * k + 8]) == 128 for r in subpel for k in range(16)), subpel
    return {"Subpel_Filters": subpel, "Upscale_Filter": upscale, "Quantizer_Matrix": qm, "Qm_Offset": offset, "Gaussian_Sequence": gauss,
            "Dc_Qlookup": dc, "Ac_Qlookup": ac, "Dr_Intra_Derivative": drd, "Sm_Weights": sm,
            "Filter_Intra_Taps": taps, "Cos128_Lookup": cos, "Sinpi_Lookup": sinpi, "Sgr_Params": sgr.tolist(),
            "Div_Table": div, "Cdef_Uv_Dir": [[ident, conv440], [conv422, ident]], "Cdef_Directions": dirs.tolist(),
            "Cdef_Pri_Taps": [pri[:2], pri[2:]], "Wiener_Taps_Mid": mid, **SPEC}


def _fmt(rows, width=12) -> str:
    flat = [str(v) for v in rows]
    return ",\n".join("    " + ", ".join(flat[i:i + width]) for i in range(0, len(flat), width))


def header(ro: bytes) -> str:
    lines = ["// AV1 default CDFs and constant tables (AV1 Bitstream & Decoding Process",
             "// Specification, 9.3 and 7.11-7.18). Generated by",
             "// tests/torch_fixtures/gen_av1_tables.py; do not edit by hand.",
             "// Each CDF row is the spec's: increasing values ending in 32768, then the",
             "// adaptation counter; a row of fewer symbols than its table's widest is",
             "// padded with zeros after its counter.",
             "#pragma once", "#include <stdint.h>", ""]
    lines += ["// CDEF's secondary taps and the Wiener and self-guided coefficient ranges",
              "// are typed from the specification; every other table is the library's.", ""]
    for name, (dims, rows) in {**tables(ro), **delta_cdfs(ro), **SPEC_CDFS}.items():
        width = max(len(r) for r in rows)
        flat = []
        for r in rows:
            flat += r + [0] * (width - len(r))
        shape = "".join(f"[{d}]" for d in dims) + f"[{width}]"
        lines.append(f"static const uint16_t {name}{shape} = {{\n{_fmt(flat, width)}\n}};\n")
    for name, vals in scalars(ro).items():
        flat = np.ravel(vals).tolist()
        typ = "int8_t" if name == "Filter_Intra_Taps" else "int16_t" if name in (
            "Dc_Qlookup", "Ac_Qlookup", "Dr_Intra_Derivative", "Gaussian_Sequence",
            "Upscale_Filter", "Subpel_Filters") else "uint8_t" if name in (
            "Sm_Weights", "Quantizer_Matrix") else "int32_t"
        shape = SHAPES.get(name, f"[{len(flat)}]")
        lines.append(f"static const {typ} {name}{shape} = {{\n{_fmt(flat, 32 if len(flat) > 4096 else 16)}\n}};\n")
    return "\n".join(lines)


def main() -> None:
    text = header(rodata(library_path()))
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}: {len(text)} bytes")


if __name__ == "__main__":
    main()
