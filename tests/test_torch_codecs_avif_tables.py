"""Port parity, the AV1 tables of the native decoder
(optixpathtracer_tpu_torch/csrc/host/av1_tables.h): the header equals what
tests/torch_fixtures/gen_av1_tables.py reads out of the read-only data of
PIL's bundled libavif (libaom's and dav1d's default CDFs, quantizer
lookups at 8, 10 and 12 bits, directional derivatives, smooth weights, filter-intra taps and
the DCT / ADST constants, CDEF's and loop restoration's tables; the delta q
and delta lf CDFs, libaom's quantizer matrices and dav1d's Gaussian
sequence of film grain; the inter frame's CDFs and the sub-pixel filters
of AVIF step 7), and the
first row of each table, with a few more rows, equals the values the AV1
specification prints. The comparison
with the library skips where PIL ships no libavif.
"""
import re

import pytest

import torch_avif_oracle as oracle
from torch_fixtures import gen_av1_tables as gen


def _table(text: str, name: str) -> list:
    body = re.search(rf"{name}(?:\[\d+\])+ = {{(.*?)}};", text, re.S).group(1)
    return [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]


# the first row of each table as the AV1 specification prints it (a CDF row
# without its trailing 32768, 0), typed here: the derived tables (the
# partition CDFs of 32 and 64 samples, the MV sign and bit CDFs) too, so
# that an offset gen_av1_tables.py took from the memory layout fails here,
# whatever the library holds
FIRST_ROWS = {
    "Default_Angle_Delta_Cdf": [2180, 5032, 7567, 22776, 26989, 30217],
    "Default_Uv_Mode_Cfl_Not_Allowed_Cdf": [22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244, 30059,
                                            30941, 31961],
    "Default_Uv_Mode_Cfl_Allowed_Cdf": [10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986, 20086, 20995,
                                        22455, 24212],
    "Default_Partition_W8_Cdf": [19132, 25510, 30392],
    "Default_Partition_W16_Cdf": [15597, 20929, 24571, 26706, 27664, 28821, 29601, 30571, 31902],
    "Default_Partition_W32_Cdf": [18462, 20920, 23124, 27647, 28227, 29049, 29519, 30178, 31544],
    "Default_Partition_W64_Cdf": [20137, 21547, 23078, 29566, 29837, 30261, 30524, 30892, 31724],
    "Default_Partition_W128_Cdf": [27899, 28219, 28529, 32484, 32539, 32619, 32639],
    "Default_Intra_Tx_Type_Set1_Cdf": [1535, 8035, 9461, 12751, 23467, 27825],
    "Default_Cfl_Sign_Cdf": [1418, 2123, 13340, 18405, 26972, 28343, 32294],
    "Default_Cfl_Alpha_Cdf": [7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708, 32712,
                              32716, 32720, 32724],
    "Default_Filter_Intra_Cdf": [4621],
    "Default_Filter_Intra_Mode_Cdf": [8949, 12776, 17211, 29558],
    "Default_Palette_Y_Mode_Cdf": [31676],
    "Default_Palette_Uv_Mode_Cdf": [32461],
    "Default_Palette_Y_Size_Cdf": [7952, 13000, 18149, 21478, 25527, 29241],
    "Default_Palette_Uv_Size_Cdf": [8713, 19979, 27128, 29609, 31331, 32272],
    "Default_Palette_Y_Color_Cdf": [28710],
    "Default_Palette_Uv_Color_Cdf": [29089],
    "Default_Tx_8x8_Cdf": [19968],
    "Default_Tx_16x16_Cdf": [12272, 30172],
    "Default_Tx_32x32_Cdf": [12986, 15180],
    "Default_Tx_64x64_Cdf": [5782, 11475],
    "Default_Txfm_Split_Cdf": [28581],
    "Default_Intrabc_Cdf": [30531],
    "Default_Mv_Joint_Cdf": [4096, 11264, 19328],
    "Default_Mv_Class_Cdf": [28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757, 32762, 32767],
    "Default_Mv_Sign_Cdf": [16384],
    "Default_Mv_Class0_Bit_Cdf": [27648],
    "Default_Mv_Bit_Cdf": [17408],
    "Default_Txb_Skip_Cdf": [31849],
    "Default_Eob_Pt_16_Cdf": [840, 1039, 1980, 4895],
    "Default_Eob_Pt_32_Cdf": [400, 520, 977, 2102, 6542],
    "Default_Eob_Pt_64_Cdf": [329, 498, 1101, 1784, 3265, 7758],
    "Default_Eob_Pt_128_Cdf": [219, 482, 1140, 2091, 3680, 6028, 12586],
    "Default_Eob_Pt_256_Cdf": [310, 584, 1887, 3589, 6168, 8611, 11352, 15652],
    "Default_Eob_Pt_512_Cdf": [641, 983, 3707, 5430, 10234, 14958, 18788, 23412, 26061],
    "Default_Eob_Pt_1024_Cdf": [393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830],
    "Default_Eob_Extra_Cdf": [16961],
    "Default_Dc_Sign_Cdf": [16000],
    "Default_Coeff_Base_Eob_Cdf": [17837, 29055],
    "Default_Coeff_Base_Cdf": [4034, 8930, 12727],
    "Default_Coeff_Br_Cdf": [14298, 20718, 24174],
    # delta q and delta lf (AVIF step 4): the same row for all six
    "Default_Delta_Q_Cdf": [28160, 32120, 32677],
    "Default_Delta_Lf_Cdf": [28160, 32120, 32677],
    "Default_Delta_Lf_Multi_Cdf": [28160, 32120, 32677],
    # the quantizer matrices (level 0, luma, 4 x 4), each transform size's
    # offset into a level's row, and film grain's Gaussian sequence
    "Quantizer_Matrix": [32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200],
    "Qm_Offset": [0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680, 2192, 336, 336, 2704, 2768, 2832, 3088, 1680,
                  2192],
    "Gaussian_Sequence": [56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224, 1248],
    "Dr_Intra_Derivative": [0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273, 0, 0, 215],
    "Filter_Intra_Taps": [-6, 10, 0, 0, 0, 12, 0],
    # loop restoration and CDEF (7.15, 7.17)
    "Default_Restoration_Type_Cdf": [9413, 22581],
    "Default_Use_Wiener_Cdf": [11570],
    "Default_Use_Sgrproj_Cdf": [16855],
    "Sgr_Params": [2, 140, 1, 3236, 2, 112, 1, 2158],
    "Div_Table": [0, 840, 420, 280, 210, 168, 140, 120, 105],
    "Cdef_Uv_Dir": [0, 1, 2, 3, 4, 5, 6, 7, 1, 2, 2, 2, 3, 4, 6, 0, 7, 0, 2, 4, 5, 6, 6, 6],
    "Cdef_Directions": [-1, 1, -2, 2, 0, 1, -1, 2],
    "Cdef_Pri_Taps": [4, 2, 3, 3],
    "Cdef_Sec_Taps": [2, 1, 2, 1],
    "Wiener_Taps_Min": [-5, -23, -17],
    "Wiener_Taps_Max": [10, 8, 46],
    "Wiener_Taps_K": [1, 2, 3],
    "Wiener_Taps_Mid": [3, -7, 15],
    "Sgrproj_Xqd_Min": [-96, -32],
    "Sgrproj_Xqd_Max": [31, 95],
    "Sgrproj_Xqd_Mid": [-32, 31],
    # what an inter frame reads (AVIF step 7)
    "Default_Y_Mode_Cdf": [22801, 23489, 24293, 24756, 25601, 26123, 26606, 27418, 27945, 29228, 29685, 30349],
    "Default_Is_Inter_Cdf": [806],
    "Default_Single_Ref_Cdf": [4897],
    "Default_New_Mv_Cdf": [24035],
    "Default_Zero_Mv_Cdf": [2175],
    "Default_Ref_Mv_Cdf": [23974],
    "Default_Drl_Mode_Cdf": [13104],
    "Default_Interp_Filter_Cdf": [31935, 32720],
    "Default_Mv_Class0_Fr_Cdf": [16384, 24576, 26624],
    "Default_Mv_Fr_Cdf": [8192, 17408, 21248],
    "Default_Mv_Class0_Hp_Cdf": [20480],
    "Default_Mv_Hp_Cdf": [16384],
    "Default_Segment_Id_Predicted_Cdf": [16384],
    # the sub-pixel filters' first two phases of the regular 8-tap filter
    "Subpel_Filters": [0, 0, 0, 128, 0, 0, 0, 0, 0, 2, -6, 126, 8, -2, 0, 0],
}


@pytest.mark.parametrize("name", list(FIRST_ROWS))
def test_first_row_the_specification_prints(name):
    with open(gen.OUT) as f:
        text = f.read()
    want = FIRST_ROWS[name]
    got = _table(text, name)
    if name.startswith("Default_"):
        assert got[:len(want) + 2] == want + [32768, 0]
    else:
        assert got[:len(want)] == want


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
def test_header_is_the_librarys_tables():
    with open(gen.OUT) as f:
        committed = f.read()
    assert gen.header(gen.rodata(gen.library_path())) == committed


def test_rows_the_specification_prints():
    with open(gen.OUT) as f:
        text = f.read()
    assert _table(text, "Default_Intra_Frame_Y_Mode_Cdf")[:4] == [15588, 17027, 19338, 20218]
    assert _table(text, "Default_Skip_Cdf") == [31671, 32768, 0, 16515, 32768, 0, 4576, 32768, 0]
    # Dc_Qlookup / Ac_Qlookup hold the rows of 8, 10 and 12 bits: the first
    # and last values of each as the specification prints them
    dc, ac = _table(text, "Dc_Qlookup"), _table(text, "Ac_Qlookup")
    assert len(dc) == len(ac) == 3 * 256
    assert [dc[256 * k:256 * k + 4] for k in range(3)] == [[4, 8, 8, 9], [4, 9, 10, 13], [4, 12, 18, 25]]
    assert [dc[256 * k + 255] for k in range(3)] == [1336, 5347, 21387]
    assert [ac[256 * k:256 * k + 4] for k in range(3)] == [[4, 8, 9, 10], [4, 9, 11, 13], [4, 13, 19, 27]]
    assert [ac[256 * k + 255] for k in range(3)] == [1828, 7312, 29247]
    assert _table(text, "Sm_Weights")[:4] == [255, 149, 85, 64]
    assert _table(text, "Cos128_Lookup")[32] == 2896 and _table(text, "Sinpi_Lookup")[1:] == [1321, 2482, 3344, 3803]
    # the last rows of the self-guided parameters and CDEF's directions
    assert _table(text, "Sgr_Params")[-8:] == [2, 56, 0, -1, 2, 22, 0, -1]
    assert _table(text, "Sgr_Params")[40:44] == [0, -1, 1, 2589]
    assert _table(text, "Cdef_Directions")[-4:] == [1, 0, 2, -1]


def test_step7_tables_the_specification_prints():
    """Default_Single_Ref_Cdf holds single_ref_p1 .. p6 for each of three
    contexts, its last row 30304; the interpolation filter's 16 contexts
    end 14969, 21398; the other inter CDFs' rows as printed; the six
    sub-pixel filters sum to 128 at every phase, phase 8 of the regular,
    smooth, sharp, bilinear, 4-tap regular and 4-tap smooth as printed."""
    with open(gen.OUT) as f:
        text = f.read()
    assert _table(text, "Default_Single_Ref_Cdf")[-3:] == [30304, 32768, 0]
    assert _table(text, "Default_Interp_Filter_Cdf")[-4:] == [14969, 21398, 32768, 0]
    assert _table(text, "Default_New_Mv_Cdf")[::3] == [24035, 16630, 15339, 8386, 12222, 4676]
    assert _table(text, "Default_Ref_Mv_Cdf")[::3] == [23974, 24188, 17848, 28622, 24312, 19923]
    assert _table(text, "Default_Is_Inter_Cdf")[::3] == [806, 16662, 20186, 26538]
    assert _table(text, "Default_Zero_Mv_Cdf")[::3] == [2175, 1054]
    assert _table(text, "Default_Drl_Mode_Cdf")[::3] == [13104, 24560, 18945]
    filters = [_table(text, "Subpel_Filters")[128 * f:128 * (f + 1)] for f in range(6)]
    assert all(sum(f[8 * p:8 * p + 8]) == 128 for f in filters for p in range(16))
    assert [f[64:72] for f in filters] == [[0, 2, -14, 76, 76, -14, 2, 0], [0, -2, 14, 52, 52, 14, -2, 0],
                                           [-4, 12, -24, 80, 80, -24, 12, -4], [0, 0, 0, 64, 64, 0, 0, 0],
                                           [0, 0, -12, 76, 76, -12, 0, 0], [0, 0, 12, 52, 52, 12, 0, 0]]


def test_step4_tables_the_specification_prints():
    """Quantizer_Matrix[15][2][3344]: 15 levels of luma and chroma inverse
    weights, the last level nearly flat (30-32) and ending in 32; Qm_Offset
    lays the 14 matrices of up to 32 x 32 end to end (3344 entries), a
    64-point size at its 32-point matrix; Gaussian_Sequence[2048] ends
    428, -484."""
    with open(gen.OUT) as f:
        text = f.read()
    qm = _table(text, "Quantizer_Matrix")
    assert len(qm) == 15 * 2 * 3344 and qm[-1] == 32
    assert set(qm[14 * 2 * 3344:]) <= {30, 31, 32}
    offset = dict(zip(gen.TX_SIZES, _table(text, "Qm_Offset")))
    assert offset[(64, 64)] == offset[(32, 64)] == offset[(64, 32)] == offset[(32, 32)]
    assert offset[(16, 64)] == offset[(16, 32)] and offset[(64, 16)] == offset[(32, 16)]
    assert offset[(32, 8)] + 32 * 8 == 3344
    gauss = _table(text, "Gaussian_Sequence")
    assert len(gauss) == 2048 and gauss[-2:] == [428, -484]
