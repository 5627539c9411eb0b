// AV1 tile decoder: the decoding process of the AV1 Bitstream & Decoding
// Process Specification for one 8-, 10- or 12-bit frame in 4:2:0, 4:2:2,
// 4:4:4 or monochrome, as libaom writes AVIF stills, their alpha items and
// the frames of image sequences.
// io/codecs/av1_obu.py parses the OBUs and the frame header and hands the
// frame parameters, each tile's bytes and an inter frame's reference planes
// here; this file decodes the tiles (symbol decoder and CDF adaptation,
// partitions, intra modes with the edge filter and upsampling, filter
// intra, CfL, palette, IntraBC, transform sizes and types, coefficients,
// delta q and delta lf, segment ids and their features, the dequantiser
// with its quantizer matrices, the inverse transforms and the lossless WHT,
// the loop-restoration coefficients; in an inter frame, is_inter, single
// references, the inter modes and the DRL index, the MV stack of 7.10.2,
// vectors at every precision, the per-block interpolation filter, var-tx
// and the prediction of 7.11.3 by the regular, smooth, sharp, bilinear and
// 4-tap sub-pixel filters), then runs the frame's filters in the
// specification's order: deblocking (7.14, each block at its own level with
// delta lf, its segment's and its reference's and mode's deltas), CDEF
// (7.15), superres upscaling (7.16) where the frame is downscaled, and loop
// restoration (7.17) on the upscaled frame, and returns each plane cropped
// to its size, before film grain; av1_film_grain adds the grain (7.18.3)
// to the frame shown. A tile whose symbol decoder reads too far past its
// data fails the frame, as dav1d's overread check fails it.
//
// Names follow the specification (section 5.11 syntax, 7.10-7.18 decoding
// processes); the inverse DCT / ADST are the butterfly networks the
// specification defines, with the intermediate add / subtract results
// clamped to the stage range (BitDepth + 8 bits for the rows, Max(BitDepth +
// 6, 16) for the columns) as libaom and dav1d clamp them. The decoder is a
// template on its sample type, as dav1d builds 8bpc and 16bpc: uint8_t
// planes at 8 bits (BitDepth fixed at 8, so the 8-bit path compiles as it
// did), uint16_t planes at 10 and 12 bits with BitDepth read from the
// parameters. Where the specification and dav1d part (segment ids past
// the last active segment), this file follows dav1d, which PIL's libavif
// decodes with. Not handled here (the Python side raises before calling):
// the inter tools of AVIF steps 8 and 9 (temporal MV candidates, OBMC and
// warped motion, global motion, the dual filter, compound prediction, skip
// mode, inter-intra, CDFs loaded from a reference, scaled references).
//
// Build: g++ -O2 -shared -fPIC (utils/host_build.py).
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "av1_tables.h"

namespace {

// ---------------------------------------------------------------- constants
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
       SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
// inter modes (YMode of an inter block) and the compound ones after them
enum { NEARESTMV = 13, NEARMV, GLOBALMV, NEWMV, NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV,
       NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV };
enum { NONE = -1, INTRA_FRAME, LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME, BWDREF_FRAME, ALTREF2_FRAME,
       ALTREF_FRAME };
enum { EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
       ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32,
       TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32,
       BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64,
       BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
       BLOCK_INVALID };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
       PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { TX_MODE_ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT };
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2, TX_SET_INTER_1 = 1, TX_SET_INTER_2, TX_SET_INTER_3 };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
enum { SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_REF_FRAME = 5, SEG_LVL_SKIP, SEG_LVL_GLOBALMV, SEG_LVL_MAX };
const int MAX_SEGMENTS = 8;
const int OVERREAD_BITS = 15;

const int Mi_Width_Log2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const int Mi_Height_Log2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
const int Tx_Width_Log2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const int Tx_Height_Log2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
const int Transform_Row_Shift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};
const int Max_Tx_Depth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
const int Mode_To_Angle[9] = {0, 90, 180, 45, 135, 113, 157, 203, 67};
const int Intra_Mode_Context[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int Filter_Intra_Mode_To_Intra_Dir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const int Mode_To_Txfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                              DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
const int Tx_Type_Intra_Inv_Set1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int Tx_Type_Intra_Inv_Set2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int Tx_Type_Inter_Inv_Set1[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT,
                                        ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                                        FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int Tx_Type_Inter_Inv_Set2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
                                        DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
                                        FLIPADST_ADST};
const int Tx_Type_Inter_Inv_Set3[2] = {IDTX, DCT_DCT};
const int Palette_Color_Context[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
const int Palette_Color_Hash_Multipliers[3] = {1, 2, 2};
const int Sig_Ref_Diff_Offset[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                          {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                          {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int Mag_Ref_Offset_With_Tx_Class[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}},
                                                   {{0, 1}, {1, 0}, {2, 0}}};
// Coeff_Base_Ctx_Offset by block shape: square, wide (w > h), tall (w < h)
const int Coeff_Base_Ctx_Offset[3][5][5] = {
    {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}},
    {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}};
const int Coeff_Base_Pos_Ctx_Offset[3] = {26, 31, 36};
const int Intra_Edge_Kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
const int Size_Group[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};
const int REF_CAT_LEVEL = 640, MV_BORDER = 128;
const int MODE_INFO_FIELDS = 7;  // what av1_decode_frame's mode_info keeps of each 4x4

inline int imin(int a, int b) { return a < b ? a : b; }
inline int imax(int a, int b) { return a > b ? a : b; }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int round2(int64_t x, int n) { return n == 0 ? (int)x : (int)((x + ((int64_t)1 << (n - 1))) >> n); }
inline int round2signed(int64_t x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floor_log2(unsigned x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
inline int ceil_log2(int x) { if (x < 2) return 0; int i = 1; int p = 2; while (p < x) { i++; p <<= 1; } return i; }

int block_size(int wlog2, int hlog2) {  // in 4x4 units
  for (int b = 0; b < 22; b++)
    if (Mi_Width_Log2[b] == wlog2 && Mi_Height_Log2[b] == hlog2) return b;
  return BLOCK_INVALID;
}
int bw4(int b) { return 1 << Mi_Width_Log2[b]; }
int bh4(int b) { return 1 << Mi_Height_Log2[b]; }
int block_width(int b) { return 4 << Mi_Width_Log2[b]; }
int block_height(int b) { return 4 << Mi_Height_Log2[b]; }
int find_tx_size(int w, int h) {
  int wl = floor_log2(w), hl = floor_log2(h);
  for (int t = 0; t < 19; t++)
    if (Tx_Width_Log2[t] == wl && Tx_Height_Log2[t] == hl) return t;
  return -1;
}
int tx_w(int t) { return 1 << Tx_Width_Log2[t]; }
int tx_h(int t) { return 1 << Tx_Height_Log2[t]; }
int tx_sqr(int t) { return imin(Tx_Width_Log2[t], Tx_Height_Log2[t]) - 2; }
int tx_sqr_up(int t) { return imax(Tx_Width_Log2[t], Tx_Height_Log2[t]) - 2; }
int max_tx_size_rect(int b) { return find_tx_size(imin(64, block_width(b)), imin(64, block_height(b))); }
int split_tx_size(int t) {
  int wl = Tx_Width_Log2[t], hl = Tx_Height_Log2[t];
  if (t == TX_4X4) return TX_4X4;
  if (wl == hl) return find_tx_size(1 << (wl - 1), 1 << (hl - 1));
  if (wl > hl) return find_tx_size(1 << (wl - 1), 1 << hl);
  return find_tx_size(1 << wl, 1 << (hl - 1));
}
int adjusted_tx_size(int t) {
  return find_tx_size(imin(32, tx_w(t)), imin(32, tx_h(t)));
}
// Subsampled_Size: a block's size in a plane subsampled by (ssx, ssy); a
// block taller than wide has no 4:2:2 chroma size (BLOCK_INVALID)
int subsampled_size(int b, int ssx, int ssy) {
  int wl = Mi_Width_Log2[b], hl = Mi_Height_Log2[b];
  if (ssx && !ssy && hl > wl) return BLOCK_INVALID;
  return block_size(imax(0, wl - ssx), imax(0, hl - ssy));
}
int partition_subsize(int p, int b) {
  int l = Mi_Width_Log2[b];  // square
  switch (p) {
    case PARTITION_NONE: return b;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: return block_size(l, l - 1);
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: return block_size(l - 1, l);
    case PARTITION_SPLIT: return block_size(l - 1, l - 1);
    case PARTITION_HORZ_4: return block_size(l, l - 2);
    case PARTITION_VERT_4: return block_size(l - 2, l);
  }
  return BLOCK_INVALID;
}

// ------------------------------------------------------------------- CDFs
// copy a default table into its adaptable twin, which must have its shape
#define COPY(dst, src)                                              \
  do {                                                              \
    static_assert(sizeof(dst) == sizeof(src), "CDF table shape"); \
    memcpy(dst, src, sizeof(dst));                                  \
  } while (0)

struct Cdfs {
  uint16_t y_mode[5][5][14];
  uint16_t angle_delta[8][8];
  uint16_t uv_mode_cfl_not_allowed[13][14];
  uint16_t uv_mode_cfl_allowed[13][15];
  uint16_t partition_w8[4][5], partition_w16[4][11], partition_w32[4][11], partition_w64[4][11],
      partition_w128[4][9];
  uint16_t intra_tx_set1[4][13][8], intra_tx_set2[4][13][6];
  uint16_t inter_tx_set1[4][17], inter_tx_set2[4][13], inter_tx_set3[4][3];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t palette_y_mode[7][3][3];
  uint16_t palette_uv_mode[2][3];
  uint16_t palette_y_size[7][8], palette_uv_size[7][8];
  uint16_t palette_y_color[7][5][9], palette_uv_color[7][5][9];
  uint16_t tx_8x8[3][3], tx_16x16[3][4], tx_32x32[3][4], tx_64x64[3][4];
  uint16_t txfm_split[21][3];
  uint16_t skip[3][3];
  uint16_t intrabc[3];
  // the MV CDFs of MvCtx 0 (inter blocks) and MV_INTRABC_CONTEXT (1), per
  // component where the specification has one
  uint16_t mv_joint[2][5], mv_class[2][2][12], mv_sign[2][2][3], mv_class0_bit[2][2][3], mv_bit[2][2][10][3],
      mv_class0_fr[2][2][2][5], mv_fr[2][2][5], mv_class0_hp[2][2][3], mv_hp[2][2][3];
  // what an inter frame reads besides (5.11.18-5.11.33)
  uint16_t y_mode_inter[4][14], is_inter[4][3], single_ref[3][6][3], new_mv[6][3], zero_mv[2][3], ref_mv[6][3],
      drl_mode[3][3], interp_filter[16][4], segment_id_predicted[3][3];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_pt16[2][2][6], eob_pt32[2][2][7], eob_pt64[2][2][8], eob_pt128[2][2][9], eob_pt256[2][2][10],
      eob_pt512[2][11], eob_pt1024[2][12];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t coeff_base_eob[5][2][4][4];
  uint16_t coeff_base[5][2][42][5];
  uint16_t coeff_br[5][2][21][5];
  uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
  uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
  uint16_t segment_id[3][9];

  void init(int base_q_idx) {
    COPY(y_mode, Default_Intra_Frame_Y_Mode_Cdf);
    COPY(angle_delta, Default_Angle_Delta_Cdf);
    COPY(uv_mode_cfl_not_allowed, Default_Uv_Mode_Cfl_Not_Allowed_Cdf);
    COPY(uv_mode_cfl_allowed, Default_Uv_Mode_Cfl_Allowed_Cdf);
    COPY(partition_w8, Default_Partition_W8_Cdf);
    COPY(partition_w16, Default_Partition_W16_Cdf);
    COPY(partition_w32, Default_Partition_W32_Cdf);
    COPY(partition_w64, Default_Partition_W64_Cdf);
    COPY(partition_w128, Default_Partition_W128_Cdf);
    COPY(intra_tx_set1, Default_Intra_Tx_Type_Set1_Cdf);
    COPY(intra_tx_set2, Default_Intra_Tx_Type_Set2_Cdf);
    COPY(inter_tx_set1, Default_Inter_Tx_Type_Set1_Cdf);
    COPY(inter_tx_set2, Default_Inter_Tx_Type_Set2_Cdf);
    COPY(inter_tx_set3, Default_Inter_Tx_Type_Set3_Cdf);
    COPY(cfl_sign, Default_Cfl_Sign_Cdf);
    COPY(cfl_alpha, Default_Cfl_Alpha_Cdf);
    COPY(filter_intra, Default_Filter_Intra_Cdf);
    COPY(filter_intra_mode, Default_Filter_Intra_Mode_Cdf);
    COPY(palette_y_mode, Default_Palette_Y_Mode_Cdf);
    COPY(palette_uv_mode, Default_Palette_Uv_Mode_Cdf);
    COPY(palette_y_size, Default_Palette_Y_Size_Cdf);
    COPY(palette_uv_size, Default_Palette_Uv_Size_Cdf);
    COPY(palette_y_color, Default_Palette_Y_Color_Cdf);
    COPY(palette_uv_color, Default_Palette_Uv_Color_Cdf);
    COPY(tx_8x8, Default_Tx_8x8_Cdf);
    COPY(tx_16x16, Default_Tx_16x16_Cdf);
    COPY(tx_32x32, Default_Tx_32x32_Cdf);
    COPY(tx_64x64, Default_Tx_64x64_Cdf);
    COPY(txfm_split, Default_Txfm_Split_Cdf);
    COPY(skip, Default_Skip_Cdf);
    COPY(intrabc, Default_Intrabc_Cdf);
    for (int ctx = 0; ctx < 2; ctx++) {
      COPY(mv_joint[ctx], Default_Mv_Joint_Cdf);
      for (int c = 0; c < 2; c++) {
        COPY(mv_class[ctx][c], Default_Mv_Class_Cdf);
        COPY(mv_sign[ctx][c], Default_Mv_Sign_Cdf);
        COPY(mv_class0_bit[ctx][c], Default_Mv_Class0_Bit_Cdf);
        COPY(mv_bit[ctx][c], Default_Mv_Bit_Cdf);
        COPY(mv_class0_fr[ctx][c], Default_Mv_Class0_Fr_Cdf);
        COPY(mv_fr[ctx][c], Default_Mv_Fr_Cdf);
        COPY(mv_class0_hp[ctx][c], Default_Mv_Class0_Hp_Cdf);
        COPY(mv_hp[ctx][c], Default_Mv_Hp_Cdf);
      }
    }
    COPY(y_mode_inter, Default_Y_Mode_Cdf);
    COPY(is_inter, Default_Is_Inter_Cdf);
    COPY(single_ref, Default_Single_Ref_Cdf);
    COPY(new_mv, Default_New_Mv_Cdf);
    COPY(zero_mv, Default_Zero_Mv_Cdf);
    COPY(ref_mv, Default_Ref_Mv_Cdf);
    COPY(drl_mode, Default_Drl_Mode_Cdf);
    COPY(interp_filter, Default_Interp_Filter_Cdf);
    COPY(segment_id_predicted, Default_Segment_Id_Predicted_Cdf);
    int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
    COPY(txb_skip, Default_Txb_Skip_Cdf[q]);
    COPY(eob_pt16, Default_Eob_Pt_16_Cdf[q]);
    COPY(eob_pt32, Default_Eob_Pt_32_Cdf[q]);
    COPY(eob_pt64, Default_Eob_Pt_64_Cdf[q]);
    COPY(eob_pt128, Default_Eob_Pt_128_Cdf[q]);
    COPY(eob_pt256, Default_Eob_Pt_256_Cdf[q]);
    for (int p = 0; p < 2; p++) {  // libaom keeps a second, unused context for these two
      COPY(eob_pt512[p], Default_Eob_Pt_512_Cdf[q][p][0]);
      COPY(eob_pt1024[p], Default_Eob_Pt_1024_Cdf[q][p][0]);
    }
    COPY(eob_extra, Default_Eob_Extra_Cdf[q]);
    COPY(dc_sign, Default_Dc_Sign_Cdf[q]);
    COPY(coeff_base_eob, Default_Coeff_Base_Eob_Cdf[q]);
    COPY(coeff_base, Default_Coeff_Base_Cdf[q]);
    COPY(coeff_br, Default_Coeff_Br_Cdf[q]);
    COPY(restoration_type, Default_Restoration_Type_Cdf);
    COPY(use_wiener, Default_Use_Wiener_Cdf);
    COPY(use_sgrproj, Default_Use_Sgrproj_Cdf);
    COPY(delta_q, Default_Delta_Q_Cdf);
    COPY(delta_lf, Default_Delta_Lf_Cdf);
    COPY(delta_lf_multi, Default_Delta_Lf_Multi_Cdf);
    COPY(segment_id, Default_Segment_Id_Cdf);
  }
};

// --------------------------------------------------------- symbol decoder
struct SymbolDecoder {
  const uint8_t* buf;
  int64_t size_bits, pos;
  uint32_t value;
  int range, max_bits;
  bool update;

  uint32_t f(int n) {  // n bits, MSB first; past the end reads zeros
    uint32_t x = 0;
    for (int i = 0; i < n; i++) {
      int bit = 0;
      if (pos < size_bits) bit = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
      pos++;
      x = (x << 1) | bit;
    }
    return x;
  }
  void init(const uint8_t* data, int64_t sz, bool disable_update) {
    buf = data;
    size_bits = sz * 8;
    pos = 0;
    int num_bits = (int)std::min<int64_t>(sz * 8, 15);
    uint32_t b = f(num_bits);
    uint32_t padded = b << (15 - num_bits);
    value = ((1u << 15) - 1) ^ padded;
    range = 1 << 15;
    max_bits = (int)(8 * sz - 15);
    update = !disable_update;
  }
  int symbol(uint16_t* cdf, int n, bool adapt = true) {
    int cur = range, sym = -1, prev;
    do {
      sym++;
      prev = cur;
      int fv = (1 << 15) - cdf[sym];
      cur = ((range >> 8) * (fv >> 6) >> 1) + 4 * (n - sym - 1);
    } while ((int)value < cur);
    range = prev - cur;
    value -= cur;
    int bits = 15 - floor_log2(range);
    range <<= bits;
    int num_bits = imin(bits, imax(0, max_bits));
    uint32_t nd = f(num_bits);
    uint32_t padded = nd << (bits - num_bits);
    value = padded ^ (((value + 1) << bits) - 1);
    max_bits -= bits;
    if (adapt && update) {
      int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + imin(floor_log2(n), 2);
      int tmp = 0;
      for (int i = 0; i < n - 1; i++) {
        tmp = (i == sym) ? (1 << 15) : tmp;
        if (tmp < cdf[i]) cdf[i] -= ((cdf[i] - tmp) >> rate);
        else cdf[i] += ((tmp - cdf[i]) >> rate);
      }
      cdf[n] += (cdf[n] < 32);
    }
    return sym;
  }
  int boolean() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    return symbol(cdf, 2, false);
  }
  int literal(int n) {
    int x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + boolean();
    return x;
  }
  int ns(int n) {
    int w = floor_log2(n) + 1;
    int m = (1 << w) - n;
    int v = literal(w - 1);
    if (v < m) return v;
    int extra = literal(1);
    return (v << 1) - m + extra;
  }
};

// ------------------------------------------------------ inverse transforms
inline int cos128(int angle) {
  int a = angle & 255;
  if (a <= 64) return Cos128_Lookup[a];
  if (a <= 128) return -Cos128_Lookup[128 - a];
  if (a <= 192) return -Cos128_Lookup[a - 128];
  return Cos128_Lookup[256 - a];
}
inline int32_t half_btf(int w0, int32_t in0, int w1, int32_t in1) {
  int64_t r = (int64_t)w0 * in0 + (int64_t)w1 * in1;
  return (int32_t)((r + 2048) >> 12);
}
inline int32_t clampr(int64_t v, int r) {
  int64_t lo = -((int64_t)1 << (r - 1)), hi = ((int64_t)1 << (r - 1)) - 1;
  return (int32_t)(v < lo ? lo : v > hi ? hi : v);
}
inline int brev(int bits, int x) {
  int r = 0;
  for (int i = 0; i < bits; i++) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

// The odd half of an n-point inverse DCT: O holds the m = n / 2 odd-indexed
// inputs in bit-reversed order; the network is a first rotation of mirrored
// pairs, then add / subtract stages over groups of 2, 4, .. m / 2 with a
// rotation of the groups' middles between them, and a last rotation by
// pi / 4 of the middle half.
void idct_odd(int32_t* O, int n, int r) {
  int m = n / 2, lg = floor_log2(n);
  for (int k = 0; k < m / 2; k++) {
    int j = m - 1 - k;
    int b = (64 / n) * brev(lg, m + k);
    int32_t a0 = O[k], a1 = O[j];
    O[k] = half_btf(cos128(64 - b), a0, -cos128(b), a1);
    O[j] = half_btf(cos128(b), a0, cos128(64 - b), a1);
  }
  for (int g = 2; g <= m / 2; g *= 2) {
    for (int s = 0; s < m; s += g) {
      bool rev = (s / g) & 1;
      for (int i = 0; i < g / 2; i++) {
        int a = s + i, b = s + g - 1 - i;
        int32_t x = O[a], y = O[b];
        if (!rev) { O[a] = clampr((int64_t)x + y, r); O[b] = clampr((int64_t)x - y, r); }
        else { O[a] = clampr((int64_t)y - x, r); O[b] = clampr((int64_t)x + y, r); }
      }
    }
    if (g < m / 2) {
      int nb = m / (4 * g);  // blocks of 2g in the first half
      int p = 4 * nb, lp = floor_log2(p);
      for (int beta = 0; beta < nb; beta++) {
        int theta = (16 / nb) * brev(lp, p / 2 + beta);
        int s = beta * 2 * g;
        for (int i = s + g / 2; i < s + g; i++) {  // first half of the middle
          int j = m - 1 - i;
          int32_t x = O[i], y = O[j];
          O[i] = half_btf(-cos128(theta), x, cos128(64 - theta), y);
          O[j] = half_btf(cos128(64 - theta), x, cos128(theta), y);
        }
        for (int i = s + g; i < s + 3 * g / 2; i++) {  // second half
          int j = m - 1 - i;
          int32_t x = O[i], y = O[j];
          O[i] = half_btf(-cos128(64 - theta), x, -cos128(theta), y);
          O[j] = half_btf(-cos128(theta), x, cos128(64 - theta), y);
        }
      }
    } else {
      for (int i = m / 4; i < m / 2; i++) {
        int j = m - 1 - i;
        int32_t x = O[i], y = O[j];
        O[i] = half_btf(-cos128(32), x, cos128(32), y);
        O[j] = half_btf(cos128(32), x, cos128(32), y);
      }
    }
  }
}

// n-point inverse DCT of T (natural order in and out), stage range r
void idct_br(int32_t* T, int n, int r) {  // T in bit-reversed order
  if (n == 2) {
    int32_t a = T[0], b = T[1];
    T[0] = half_btf(cos128(32), a, cos128(32), b);
    T[1] = half_btf(cos128(32), a, -cos128(32), b);
    return;
  }
  int m = n / 2;
  idct_br(T, m, r);
  idct_odd(T + m, n, r);
  int32_t out[64];
  for (int i = 0; i < m; i++) {
    out[i] = clampr((int64_t)T[i] + T[n - 1 - i], r);
    out[n - 1 - i] = clampr((int64_t)T[i] - T[n - 1 - i], r);
  }
  memcpy(T, out, n * sizeof(int32_t));
}
void idct(int32_t* T, int n, int r) {
  int32_t c[64];
  int lg = floor_log2(n);
  for (int i = 0; i < n; i++) c[i] = T[brev(lg, i)];
  idct_br(c, n, r);
  memcpy(T, c, n * sizeof(int32_t));
}

void iadst4(int32_t* T) {
  int64_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
  const int32_t* sp = Sinpi_Lookup;
  int64_t s0 = sp[1] * x0, s1 = sp[2] * x0, s2 = sp[3] * x1, s3 = sp[4] * x2, s4 = sp[1] * x2,
          s5 = sp[2] * x3, s6 = sp[4] * x3;
  int64_t a7 = x0 - x2, b7 = a7 + x3;
  s0 = s0 + s3; s1 = s1 - s4; s3 = s2; s2 = sp[3] * b7;
  s0 = s0 + s5; s1 = s1 - s6;
  x0 = s0 + s3; x1 = s1 + s3; x2 = s2; x3 = s0 + s1; x3 = x3 - s3;
  T[0] = round2(x0, 12); T[1] = round2(x1, 12); T[2] = round2(x2, 12); T[3] = round2(x3, 12);
}

inline int cospi(int i) { return cos128(i); }

void iadst8(int32_t* T, int r) {
  int32_t b[8], c[8];
  b[0] = T[7]; b[1] = T[0]; b[2] = T[5]; b[3] = T[2]; b[4] = T[3]; b[5] = T[4]; b[6] = T[1]; b[7] = T[6];
  c[0] = half_btf(cospi(4), b[0], cospi(60), b[1]);
  c[1] = half_btf(cospi(60), b[0], -cospi(4), b[1]);
  c[2] = half_btf(cospi(20), b[2], cospi(44), b[3]);
  c[3] = half_btf(cospi(44), b[2], -cospi(20), b[3]);
  c[4] = half_btf(cospi(36), b[4], cospi(28), b[5]);
  c[5] = half_btf(cospi(28), b[4], -cospi(36), b[5]);
  c[6] = half_btf(cospi(52), b[6], cospi(12), b[7]);
  c[7] = half_btf(cospi(12), b[6], -cospi(52), b[7]);
  for (int i = 0; i < 4; i++) {
    b[i] = clampr((int64_t)c[i] + c[i + 4], r);
    b[i + 4] = clampr((int64_t)c[i] - c[i + 4], r);
  }
  c[0] = b[0]; c[1] = b[1]; c[2] = b[2]; c[3] = b[3];
  c[4] = half_btf(cospi(16), b[4], cospi(48), b[5]);
  c[5] = half_btf(cospi(48), b[4], -cospi(16), b[5]);
  c[6] = half_btf(-cospi(48), b[6], cospi(16), b[7]);
  c[7] = half_btf(cospi(16), b[6], cospi(48), b[7]);
  b[0] = clampr((int64_t)c[0] + c[2], r); b[1] = clampr((int64_t)c[1] + c[3], r);
  b[2] = clampr((int64_t)c[0] - c[2], r); b[3] = clampr((int64_t)c[1] - c[3], r);
  b[4] = clampr((int64_t)c[4] + c[6], r); b[5] = clampr((int64_t)c[5] + c[7], r);
  b[6] = clampr((int64_t)c[4] - c[6], r); b[7] = clampr((int64_t)c[5] - c[7], r);
  c[0] = b[0]; c[1] = b[1]; c[4] = b[4]; c[5] = b[5];
  c[2] = half_btf(cospi(32), b[2], cospi(32), b[3]);
  c[3] = half_btf(cospi(32), b[2], -cospi(32), b[3]);
  c[6] = half_btf(cospi(32), b[6], cospi(32), b[7]);
  c[7] = half_btf(cospi(32), b[6], -cospi(32), b[7]);
  T[0] = c[0]; T[1] = -c[4]; T[2] = c[6]; T[3] = -c[2];
  T[4] = c[3]; T[5] = -c[7]; T[6] = c[5]; T[7] = -c[1];
}

void iadst16(int32_t* T, int r) {
  int32_t b[16], c[16];
  static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
  for (int i = 0; i < 16; i++) b[i] = T[perm[i]];
  for (int i = 0; i < 8; i++) {
    int a = 2 + 8 * i, bb = 62 - 8 * i;
    c[2 * i] = half_btf(cospi(a), b[2 * i], cospi(bb), b[2 * i + 1]);
    c[2 * i + 1] = half_btf(cospi(bb), b[2 * i], -cospi(a), b[2 * i + 1]);
  }
  for (int i = 0; i < 8; i++) {
    b[i] = clampr((int64_t)c[i] + c[i + 8], r);
    b[i + 8] = clampr((int64_t)c[i] - c[i + 8], r);
  }
  for (int i = 0; i < 8; i++) c[i] = b[i];
  c[8] = half_btf(cospi(8), b[8], cospi(56), b[9]);
  c[9] = half_btf(cospi(56), b[8], -cospi(8), b[9]);
  c[10] = half_btf(cospi(40), b[10], cospi(24), b[11]);
  c[11] = half_btf(cospi(24), b[10], -cospi(40), b[11]);
  c[12] = half_btf(-cospi(56), b[12], cospi(8), b[13]);
  c[13] = half_btf(cospi(8), b[12], cospi(56), b[13]);
  c[14] = half_btf(-cospi(24), b[14], cospi(40), b[15]);
  c[15] = half_btf(cospi(40), b[14], cospi(24), b[15]);
  for (int h = 0; h < 16; h += 8)
    for (int i = 0; i < 4; i++) {
      b[h + i] = clampr((int64_t)c[h + i] + c[h + i + 4], r);
      b[h + i + 4] = clampr((int64_t)c[h + i] - c[h + i + 4], r);
    }
  for (int h = 0; h < 16; h += 8) {
    c[h + 0] = b[h + 0]; c[h + 1] = b[h + 1]; c[h + 2] = b[h + 2]; c[h + 3] = b[h + 3];
    c[h + 4] = half_btf(cospi(16), b[h + 4], cospi(48), b[h + 5]);
    c[h + 5] = half_btf(cospi(48), b[h + 4], -cospi(16), b[h + 5]);
    c[h + 6] = half_btf(-cospi(48), b[h + 6], cospi(16), b[h + 7]);
    c[h + 7] = half_btf(cospi(16), b[h + 6], cospi(48), b[h + 7]);
  }
  for (int h = 0; h < 16; h += 4) {
    b[h + 0] = clampr((int64_t)c[h + 0] + c[h + 2], r);
    b[h + 1] = clampr((int64_t)c[h + 1] + c[h + 3], r);
    b[h + 2] = clampr((int64_t)c[h + 0] - c[h + 2], r);
    b[h + 3] = clampr((int64_t)c[h + 1] - c[h + 3], r);
  }
  for (int h = 0; h < 16; h += 4) {
    c[h + 0] = b[h + 0]; c[h + 1] = b[h + 1];
    c[h + 2] = half_btf(cospi(32), b[h + 2], cospi(32), b[h + 3]);
    c[h + 3] = half_btf(cospi(32), b[h + 2], -cospi(32), b[h + 3]);
  }
  T[0] = c[0]; T[1] = -c[8]; T[2] = c[12]; T[3] = -c[4]; T[4] = c[6]; T[5] = -c[14]; T[6] = c[10];
  T[7] = -c[2]; T[8] = c[3]; T[9] = -c[11]; T[10] = c[15]; T[11] = -c[7]; T[12] = c[5]; T[13] = -c[13];
  T[14] = c[9]; T[15] = -c[1];
}

void iidentity(int32_t* T, int n) {
  for (int i = 0; i < n; i++) {
    if (n == 4) T[i] = round2((int64_t)T[i] * 5793, 12);
    else if (n == 8) T[i] = T[i] * 2;
    else if (n == 16) T[i] = round2((int64_t)T[i] * 11586, 12);
    else T[i] = T[i] * 4;
  }
}

void iwht(int32_t* T, int shift) {
  int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
  a += c; d -= b;
  int32_t e = (a - d) >> 1;
  b = e - b; c = e - c;
  a -= b; d += c;
  T[0] = a; T[1] = b; T[2] = c; T[3] = d;
}

enum { T_DCT, T_ADST, T_FLIPADST, T_IDTX };
void tx_types_1d(int txType, int* vert, int* horz) {
  static const int v[16] = {T_DCT, T_ADST, T_DCT, T_ADST, T_FLIPADST, T_DCT, T_FLIPADST, T_ADST,
                            T_FLIPADST, T_IDTX, T_DCT, T_IDTX, T_ADST, T_IDTX, T_FLIPADST, T_IDTX};
  static const int h[16] = {T_DCT, T_DCT, T_ADST, T_ADST, T_DCT, T_FLIPADST, T_FLIPADST, T_FLIPADST,
                            T_ADST, T_IDTX, T_IDTX, T_DCT, T_IDTX, T_ADST, T_IDTX, T_FLIPADST};
  *vert = v[txType];
  *horz = h[txType];
}
void inverse_1d(int32_t* T, int n, int type, int r) {
  if (type == T_IDTX) iidentity(T, n);
  else if (type == T_DCT) idct(T, n, r);
  else if (n == 4) iadst4(T);
  else if (n == 8) iadst8(T, r);
  else iadst16(T, r);
}

// ------------------------------------------------------------------ frame
template <typename pixel>
struct Frame {
  int stride[3], ph[3];
  std::vector<pixel> p[3];
  pixel* at(int plane, int y, int x) { return &p[plane][(size_t)y * stride[plane] + x]; }
};

struct Params {
  int FrameWidth, FrameHeight, use_128, enable_filter_intra, enable_intra_edge_filter,
      allow_screen_content_tools, allow_intrabc, base_q_idx, DeltaQYDc, DeltaQUDc, DeltaQUAc, DeltaQVDc,
      DeltaQVAc, TxMode, reduced_tx_set, disable_cdf_update, lf_level[4], lf_sharpness, lf_delta_enabled,
      lf_ref_deltas[8], lf_mode_deltas[2], enable_cdef, cdef_bits, TileCols, TileRows;
  int MiColStarts[65], MiRowStarts[65];
  int subsampling_x, subsampling_y, NumPlanes;
  int CdefDamping, cdef_y_pri[8], cdef_y_sec[8], cdef_uv_pri[8], cdef_uv_sec[8];
  int FrameRestorationType[3], LoopRestorationSize[3];
  int BitDepth;
  // quantizer matrices (qm levels 15 where using_qmatrix is 0), delta q / lf
  int using_qmatrix, qm_y, qm_u, qm_v;
  int delta_q_present, delta_q_res, delta_lf_present, delta_lf_res, delta_lf_multi;
  // film_grain_params (5.9.30; apply_grain 0: none) and the sequence's
  // matrix_coefficients, which set film grain's chroma clip
  int matrix_coefficients;
  int apply_grain, grain_seed, num_y_points, point_y_value[14], point_y_scaling[14], chroma_scaling_from_luma,
      num_cb_points, point_cb_value[10], point_cb_scaling[10], num_cr_points, point_cr_value[10],
      point_cr_scaling[10], grain_scaling_minus_8, ar_coeff_lag, ar_coeffs_y_plus_128[24],
      ar_coeffs_cb_plus_128[25], ar_coeffs_cr_plus_128[25], ar_coeff_shift_minus_6, grain_scale_shift, cb_mult,
      cb_luma_mult, cb_offset, cr_mult, cr_luma_mult, cr_offset, overlap_flag, clip_to_restricted_range;
  // segmentation_params (5.9.14): each segment's features and their
  // (clipped) values; LastActiveSegId as dav1d keeps it, -1 where no
  // feature is enabled (the specification's 0)
  int segmentation_enabled, SegIdPreSkip, LastActiveSegId, FeatureEnabled[MAX_SEGMENTS][SEG_LVL_MAX],
      FeatureData[MAX_SEGMENTS][SEG_LVL_MAX];
  // superres_params (5.9.8): FrameWidth above is the downscaled width;
  // SuperresDenom 8 where superres is off (UpscaledWidth == FrameWidth)
  int UpscaledWidth, SuperresDenom;
  // the inter frame (5.9.2; FrameIsIntra 1 for key and intra-only frames):
  // interpolation_filter (4 SWITCHABLE), the MV precision, each reference
  // frame's sign bias (LAST_FRAME .. ALTREF_FRAME at 1-7), and the tile whose
  // CDFs the frame keeps (5.9.15) unless disable_frame_end_update_cdf
  int FrameIsIntra, interpolation_filter, allow_high_precision_mv, force_integer_mv, RefFrameSignBias[8];
  int context_update_tile_id, disable_frame_end_update_cdf;
};

template <typename pixel>
struct Decoder {
  Params P;
  int MiRows, MiCols, MiStride;
  // Lossless: the block's segment's (LosslessArray); CodedLossless: every
  // segment's
  bool Lossless, CodedLossless, LosslessArray[MAX_SEGMENTS];
  Frame<pixel> F;
  // BitDepth: 8 for the uint8_t decoder whatever the parameters say
  int BitDepth, PixelMax;
  int clip1(int v) const { return clip3(0, PixelMax, v); }
  SymbolDecoder sd;
  Cdfs cdf;
  char err[256];
  bool failed;

  // per-mi state (frame)
  std::vector<uint8_t> MiSizes, YModes, UVModes, IsInters, Skips, InterTxSizes, PaletteSizes[2], Decoded,
      TxTypes;
  std::vector<int8_t> RefFrame0;
  std::vector<uint8_t> SegmentIds;
  std::vector<uint16_t> PaletteColors[2];  // 8 per mi
  std::vector<int16_t> MvRow, MvCol;
  std::vector<uint8_t> InterpFilters;  // one filter for both directions: the dual filter raises before the tiles
  std::vector<uint8_t> LfTxSizes[3];  // per 4x4 of each plane
  int lfStride[3];
  std::vector<int8_t> CdefIdx;
  // delta q / delta lf (5.11.5): the tile's running qindex and loop filter
  // deltas, read at a superblock's first block, and each mi's deltas
  int CurrentQIndex, DeltaLF[4], ReadDeltas;
  std::vector<int8_t> DeltaLFs;  // 4 per mi
  // loop restoration, per plane and unit: type, Wiener taps [pass][3], the
  // self-guided set and its two projection weights
  int LrUnitRows[3], LrUnitCols[3];
  std::vector<uint8_t> LrType[3], LrSgrSet[3];
  std::vector<int8_t> LrWiener[3];
  std::vector<int16_t> LrSgrXqd[3];
  int RefLrWiener[3][2][3], RefSgrXqd[3][2];

  // tile
  int MiRowStart, MiRowEnd, MiColStart, MiColEnd;
  std::vector<uint8_t> AboveLevelContext[3], AboveDcContext[3], LeftLevelContext[3], LeftDcContext[3];
  uint8_t BlockDecoded[3][35][35];  // indexed [y + 1][x + 1]

  // block
  int MiRow, MiCol, MiSize, HasChroma, AvailU, AvailL, AvailUChroma, AvailLChroma;
  int segment_id, skip, is_inter, use_intrabc, YMode, UVMode, AngleDeltaY, AngleDeltaUV, CflAlphaU, CflAlphaV;
  int use_filter_intra, filter_intra_mode, PaletteSizeY, PaletteSizeUV, TxSize;
  int palette_colors_y[8], palette_colors_u[8], palette_colors_v[8];
  uint8_t ColorMapY[64][64], ColorMapUV[64][64];
  int Mv[2];
  // the block's references (RefFrame[1] NONE: compound prediction raises
  // before the tiles), its neighbours' first references, its DRL index and
  // interpolation filter
  int RefFrame[2], LeftRefFrame, AboveRefFrame, RefMvIdx, interp_filter;
  // the reference frames' planes (before film grain), LAST_FRAME ..
  // ALTREF_FRAME at 1-7, each of the frame's own size
  const pixel* RefPlanes[8][3];
  int32_t InterBuf[(128 + 8) * 128];
  int MaxLumaW, MaxLumaH;
  int PlaneTxType;
  int32_t Quant[1024];
  int32_t Dequant[64][64];
  int32_t Residual[64][64];

  size_t mi(int r, int c) const { return (size_t)r * MiStride + c; }
  int ssx(int plane) const { return plane ? P.subsampling_x : 0; }
  int ssy(int plane) const { return plane ? P.subsampling_y : 0; }
  int plane_size(int plane) const { return subsampled_size(MiSize, ssx(plane), ssy(plane)); }
  void fail(const char* msg) {
    if (!failed) snprintf(err, sizeof err, "%s", msg);
    failed = true;
  }

  bool is_inside(int r, int c) const {
    return c >= MiColStart && c < MiColEnd && r >= MiRowStart && r < MiRowEnd;
  }

  // ----------------------------------------------------------- partition
  void decode_partition(int r, int c, int bSize) {
    if (failed) return;
    if (r >= MiRows || c >= MiCols) return;
    int availU = is_inside(r - 1, c), availL = is_inside(r, c - 1);
    int num4x4 = bw4(bSize), half = num4x4 >> 1, quarter = half >> 1;
    int hasRows = (r + half) < MiRows, hasCols = (c + half) < MiCols;
    int partition;
    if (bSize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int bsl = Mi_Width_Log2[bSize];
      int above = availU && (Mi_Width_Log2[MiSizes[mi(r - 1, c)]] < bsl);
      int left = availL && (Mi_Height_Log2[MiSizes[mi(r, c - 1)]] < bsl);
      int ctx = left * 2 + above;
      uint16_t* pc;
      int n;
      if (bsl == 1) { pc = cdf.partition_w8[ctx]; n = 4; }
      else if (bsl == 2) { pc = cdf.partition_w16[ctx]; n = 10; }
      else if (bsl == 3) { pc = cdf.partition_w32[ctx]; n = 10; }
      else if (bsl == 4) { pc = cdf.partition_w64[ctx]; n = 10; }
      else { pc = cdf.partition_w128[ctx]; n = 8; }
      if (hasRows && hasCols) {
        partition = sd.symbol(pc, n);
      } else if (hasCols || hasRows) {
        auto prob = [&](int p) { return (int)pc[p] - (p > 0 ? (int)pc[p - 1] : 0); };
        int psum;
        if (hasCols) {  // split_or_horz
          psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
                 prob(PARTITION_VERT_B);
          if (bSize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        } else {  // split_or_vert
          psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) + prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
                 prob(PARTITION_VERT_A);
          if (bSize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        }
        uint16_t bc[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
        int bit = sd.symbol(bc, 2, false);
        partition = bit ? PARTITION_SPLIT : (hasCols ? PARTITION_HORZ : PARTITION_VERT);
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int subSize = partition_subsize(partition, bSize);
    int splitSize = partition_subsize(PARTITION_SPLIT, bSize);
    if (P.NumPlanes > 1 && subsampled_size(subSize, P.subsampling_x, P.subsampling_y) == BLOCK_INVALID) {
      fail("block size invalid with this subsampling");
      return;
    }
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, subSize); break;
      case PARTITION_HORZ:
        decode_block(r, c, subSize);
        if (hasRows) decode_block(r + half, c, subSize);
        break;
      case PARTITION_VERT:
        decode_block(r, c, subSize);
        if (hasCols) decode_block(r, c + half, subSize);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, subSize);
        decode_partition(r, c + half, subSize);
        decode_partition(r + half, c, subSize);
        decode_partition(r + half, c + half, subSize);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, splitSize);
        decode_block(r, c + half, splitSize);
        decode_block(r + half, c, subSize);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, subSize);
        decode_block(r + half, c, splitSize);
        decode_block(r + half, c + half, splitSize);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, splitSize);
        decode_block(r + half, c, splitSize);
        decode_block(r, c + half, subSize);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, subSize);
        decode_block(r, c + half, splitSize);
        decode_block(r + half, c + half, splitSize);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < MiRows) decode_block(r + quarter * i, c, subSize);
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < MiCols) decode_block(r, c + quarter * i, subSize);
        break;
    }
  }

  // --------------------------------------------------------------- block
  void decode_block(int r, int c, int subSize) {
    if (failed) return;
    MiRow = r; MiCol = c; MiSize = subSize;
    int w4 = bw4(subSize), h4 = bh4(subSize);
    int sx = P.subsampling_x, sy = P.subsampling_y;
    if (P.NumPlanes == 1) HasChroma = 0;
    else if (sy && h4 == 1 && (MiRow & 1) == 0) HasChroma = 0;
    else if (sx && w4 == 1 && (MiCol & 1) == 0) HasChroma = 0;
    else HasChroma = 1;
    AvailU = is_inside(r - 1, c);
    AvailL = is_inside(r, c - 1);
    AvailUChroma = AvailU;
    AvailLChroma = AvailL;
    if (HasChroma) {
      if (sy && h4 == 1) AvailUChroma = is_inside(r - 2, c);
      if (sx && w4 == 1) AvailLChroma = is_inside(r, c - 2);
    } else {
      AvailUChroma = AvailLChroma = 0;
    }
    if (P.FrameIsIntra) intra_frame_mode_info();
    else inter_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context(w4, h4);
    for (int y = 0; y < h4; y++)
      for (int x = 0; x < w4; x++) {
        size_t k = mi(r + y, c + x);
        YModes[k] = YMode;
        if (HasChroma) UVModes[k] = UVMode;
        RefFrame0[k] = is_inter && !use_intrabc ? RefFrame[0] : INTRA_FRAME;  // IntraBC's is INTRA_FRAME
        InterpFilters[k] = interp_filter;
        IsInters[k] = is_inter;
        Skips[k] = skip;
        SegmentIds[k] = segment_id;
        MiSizes[k] = MiSize;
        PaletteSizes[0][k] = PaletteSizeY;
        PaletteSizes[1][k] = PaletteSizeUV;
        for (int i = 0; i < 8; i++) {
          PaletteColors[0][k * 8 + i] = i < PaletteSizeY ? palette_colors_y[i] : 0;
          PaletteColors[1][k * 8 + i] = i < PaletteSizeUV ? palette_colors_u[i] : 0;
        }
        MvRow[k] = is_inter ? Mv[0] : 0;
        MvCol[k] = is_inter ? Mv[1] : 0;
        for (int i = 0; i < 4; i++) DeltaLFs[k * 4 + i] = DeltaLF[i];
        Decoded[k] = 1;
      }
    compute_prediction();
    residual();
  }


  // 5.11.18: an inter frame's block: segment id, skip, cdef and deltas,
  // is_inter, then the inter or intra modes (skip_mode_present raises
  // before the tiles)
  void inter_frame_mode_info() {
    use_intrabc = 0;
    interp_filter = EIGHTTAP;
    LeftRefFrame = AvailL ? RefFrame0[mi(MiRow, MiCol - 1)] : INTRA_FRAME;
    AboveRefFrame = AvailU ? RefFrame0[mi(MiRow - 1, MiCol)] : INTRA_FRAME;
    int leftIntra = LeftRefFrame <= INTRA_FRAME, aboveIntra = AboveRefFrame <= INTRA_FRAME;
    skip = 0;
    inter_segment_id(1);
    if (P.SegIdPreSkip && seg_feature_active(SEG_LVL_SKIP)) {
      skip = 1;
    } else {
      int ctx = 0;
      if (AvailU) ctx += Skips[mi(MiRow - 1, MiCol)];
      if (AvailL) ctx += Skips[mi(MiRow, MiCol - 1)];
      skip = sd.symbol(cdf.skip[ctx], 2);
    }
    if (!P.SegIdPreSkip) inter_segment_id(0);
    Lossless = LosslessArray[segment_id];
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    ReadDeltas = 0;
    if (seg_feature_active(SEG_LVL_REF_FRAME)) {
      is_inter = P.FeatureData[segment_id][SEG_LVL_REF_FRAME] != INTRA_FRAME;
    } else if (seg_feature_active(SEG_LVL_GLOBALMV)) {
      is_inter = 1;
    } else {
      int ctx;
      if (AvailU && AvailL) ctx = (leftIntra && aboveIntra) ? 3 : (leftIntra || aboveIntra);
      else if (AvailU || AvailL) ctx = 2 * (AvailU ? aboveIntra : leftIntra);
      else ctx = 0;
      is_inter = sd.symbol(cdf.is_inter[ctx], 2);
    }
    AngleDeltaY = AngleDeltaUV = 0;
    use_filter_intra = 0;
    PaletteSizeY = PaletteSizeUV = 0;
    CflAlphaU = CflAlphaV = 0;
    if (is_inter) {
      inter_block_mode_info();
    } else {
      RefFrame[0] = INTRA_FRAME;
      RefFrame[1] = NONE;
      YMode = sd.symbol(cdf.y_mode_inter[Size_Group[MiSize]], 13);
      intra_modes_after_y();
    }
  }

  // 5.11.19-5.11.20: segmentation_update_map is 1 and
  // segmentation_temporal_update 0 (no primary reference frame: one raises
  // before the tiles), so each id is read as an intra frame reads it, or
  // predicted from the neighbours in a skipped block
  void inter_segment_id(int preSkip) {
    segment_id = 0;
    if (!P.segmentation_enabled || (preSkip && !P.SegIdPreSkip)) return;
    read_segment_id();
  }

  // 5.11.25: a single reference, from the neighbours' counts of each
  void read_ref_frames() {
    RefFrame[1] = NONE;
    if (seg_feature_active(SEG_LVL_REF_FRAME)) {
      RefFrame[0] = P.FeatureData[segment_id][SEG_LVL_REF_FRAME];
      return;
    }
    if (seg_feature_active(SEG_LVL_SKIP) || seg_feature_active(SEG_LVL_GLOBALMV)) {
      RefFrame[0] = LAST_FRAME;
      return;
    }
    int n[8] = {0};
    if (AvailU && AboveRefFrame > INTRA_FRAME) n[AboveRefFrame]++;
    if (AvailL && LeftRefFrame > INTRA_FRAME) n[LeftRefFrame]++;
    auto ctx = [](int a, int b) { return a < b ? 0 : a == b ? 1 : 2; };  // ref_count_ctx
    auto bit = [&](int a, int b, int p) { return sd.symbol(cdf.single_ref[ctx(a, b)][p - 1], 2); };
    if (bit(n[LAST_FRAME] + n[LAST2_FRAME] + n[LAST3_FRAME] + n[GOLDEN_FRAME],
            n[BWDREF_FRAME] + n[ALTREF2_FRAME] + n[ALTREF_FRAME], 1)) {
      if (bit(n[BWDREF_FRAME] + n[ALTREF2_FRAME], n[ALTREF_FRAME], 2)) RefFrame[0] = ALTREF_FRAME;
      else RefFrame[0] = bit(n[BWDREF_FRAME], n[ALTREF2_FRAME], 6) ? ALTREF2_FRAME : BWDREF_FRAME;
    } else if (bit(n[LAST_FRAME] + n[LAST2_FRAME], n[LAST3_FRAME] + n[GOLDEN_FRAME], 3)) {
      RefFrame[0] = bit(n[LAST3_FRAME], n[GOLDEN_FRAME], 5) ? GOLDEN_FRAME : LAST3_FRAME;
    } else {
      RefFrame[0] = bit(n[LAST_FRAME], n[LAST2_FRAME], 4) ? LAST2_FRAME : LAST_FRAME;
    }
  }

  // 5.11.23: the inter mode, the DRL index, the vector (assign_mv) and the
  // interpolation filter; motion_mode is SIMPLE (is_motion_mode_switchable
  // raises before the tiles) and no block is inter-intra (nor is its
  // sequence's enable_interintra_compound)
  void inter_block_mode_info() {
    UVMode = DC_PRED;
    read_ref_frames();
    find_mv_stack();
    if (seg_feature_active(SEG_LVL_SKIP) || seg_feature_active(SEG_LVL_GLOBALMV)) YMode = GLOBALMV;
    else if (!sd.symbol(cdf.new_mv[NewMvContext], 2)) YMode = NEWMV;
    else if (!sd.symbol(cdf.zero_mv[ZeroMvContext], 2)) YMode = GLOBALMV;
    else YMode = sd.symbol(cdf.ref_mv[RefMvContext], 2) ? NEARMV : NEARESTMV;
    RefMvIdx = 0;
    if (YMode == NEWMV || YMode == NEARMV) {
      int first = YMode == NEARMV;
      RefMvIdx = first;
      for (int idx = first; idx < first + 2; idx++) {
        if (NumMvFound > idx + 1) {
          if (!sd.symbol(cdf.drl_mode[DrlCtxStack[idx]], 2)) {
            RefMvIdx = idx;
            break;
          }
          RefMvIdx = idx + 1;
        }
      }
    }
    // assign_mv (5.11.26): GlobalMvs are zero (global motion raises
    // before the tiles)
    if (YMode == GLOBALMV) {
      Mv[0] = Mv[1] = 0;
    } else {
      int pos = YMode == NEARESTMV ? 0 : RefMvIdx;
      if (YMode == NEWMV && NumMvFound <= 1) pos = 0;
      Mv[0] = RefStackMv[pos][0];
      Mv[1] = RefStackMv[pos][1];
      if (YMode == NEWMV) read_mv(0);
    }
    if (P.interpolation_filter == SWITCHABLE) {
      int large = imin(block_width(MiSize), block_height(MiSize)) >= 8;
      interp_filter = EIGHTTAP;
      if (!(large && YMode == GLOBALMV)) {  // needs_interp_filter: GmType is IDENTITY
        int ctx = (RefFrame[1] > INTRA_FRAME) * 4, leftType = 3, aboveType = 3;
        if (AvailL && LeftRefFrame == RefFrame[0]) leftType = InterpFilters[mi(MiRow, MiCol - 1)];
        if (AvailU && AboveRefFrame == RefFrame[0]) aboveType = InterpFilters[mi(MiRow - 1, MiCol)];
        if (leftType == aboveType) ctx += leftType;
        else if (leftType == 3) ctx += aboveType;
        else if (aboveType == 3) ctx += leftType;
        else ctx += 3;
        interp_filter = sd.symbol(cdf.interp_filter[ctx], 3);
      }
    } else {
      interp_filter = P.interpolation_filter;
    }
  }

  void intra_frame_mode_info() {
    interp_filter = EIGHTTAP;
    skip = 0;
    if (P.SegIdPreSkip) intra_segment_id();
    if (P.SegIdPreSkip && seg_feature_active(SEG_LVL_SKIP)) {
      skip = 1;
    } else {
      int ctx = 0;
      if (AvailU) ctx += Skips[mi(MiRow - 1, MiCol)];
      if (AvailL) ctx += Skips[mi(MiRow, MiCol - 1)];
      skip = sd.symbol(cdf.skip[ctx], 2);
    }
    if (!P.SegIdPreSkip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    ReadDeltas = 0;
    use_intrabc = 0;
    if (P.allow_intrabc) use_intrabc = sd.symbol(cdf.intrabc, 2);
    AngleDeltaY = AngleDeltaUV = 0;
    use_filter_intra = 0;
    PaletteSizeY = PaletteSizeUV = 0;
    CflAlphaU = CflAlphaV = 0;
    if (use_intrabc) {
      is_inter = 1;
      YMode = DC_PRED;
      UVMode = DC_PRED;
      find_mv_stack_and_assign();
    } else {
      is_inter = 0;
      int abovemode = Intra_Mode_Context[AvailU ? (int)YModes[mi(MiRow - 1, MiCol)] : (int)DC_PRED];
      int leftmode = Intra_Mode_Context[AvailL ? (int)YModes[mi(MiRow, MiCol - 1)] : (int)DC_PRED];
      YMode = sd.symbol(cdf.y_mode[abovemode][leftmode], 13);
      intra_modes_after_y();
    }
  }

  // the rest of an intra block's modes once YMode is read: angle deltas,
  // the chroma mode and CfL, palette, filter intra
  void intra_modes_after_y() {
    if (MiSize >= BLOCK_8X8 && YMode >= V_PRED && YMode <= D67_PRED)
      AngleDeltaY = sd.symbol(cdf.angle_delta[YMode - V_PRED], 7) - 3;
    if (HasChroma) {
      int cflAllowed;
      if (Lossless && plane_size(1) == BLOCK_4X4) cflAllowed = 1;
      else if (!Lossless && imax(block_width(MiSize), block_height(MiSize)) <= 32) cflAllowed = 1;
      else cflAllowed = 0;
      if (cflAllowed) UVMode = sd.symbol(cdf.uv_mode_cfl_allowed[YMode], 14);
      else UVMode = sd.symbol(cdf.uv_mode_cfl_not_allowed[YMode], 13);
      if (UVMode == UV_CFL_PRED) read_cfl_alphas();
      if (MiSize >= BLOCK_8X8 && UVMode >= V_PRED && UVMode <= D67_PRED)
        AngleDeltaUV = sd.symbol(cdf.angle_delta[UVMode - V_PRED], 7) - 3;
    } else {
      UVMode = DC_PRED;
    }
    if (MiSize >= BLOCK_8X8 && block_width(MiSize) <= 64 && block_height(MiSize) <= 64 &&
        P.allow_screen_content_tools)
      palette_mode_info();
    if (P.enable_filter_intra && YMode == DC_PRED && PaletteSizeY == 0 &&
        imax(block_width(MiSize), block_height(MiSize)) <= 32) {
      use_filter_intra = sd.symbol(cdf.filter_intra[MiSize], 2);
      if (use_filter_intra) filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
    }
  }

  bool seg_feature_active(int feature) const {
    return P.segmentation_enabled && P.FeatureEnabled[segment_id][feature];
  }
  // 5.11.8-5.11.9: the block's segment id, predicted from the above,
  // left and above-left ids (skipped blocks take the prediction), then its
  // Lossless
  void intra_segment_id() {
    segment_id = 0;
    if (P.segmentation_enabled) read_segment_id();
    Lossless = LosslessArray[segment_id];
  }
  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
  }
  void read_segment_id() {
    int prevUL = AvailU && AvailL ? SegmentIds[mi(MiRow - 1, MiCol - 1)] : -1;
    int prevU = AvailU ? SegmentIds[mi(MiRow - 1, MiCol)] : -1;
    int prevL = AvailL ? SegmentIds[mi(MiRow, MiCol - 1)] : -1;
    int pred = prevU == -1 ? (prevL == -1 ? 0 : prevL) : prevL == -1 ? prevU : prevUL == prevU ? prevU : prevL;
    if (skip) {
      segment_id = pred;
      return;
    }
    int ctx = prevUL < 0 ? 0  // prevUL is -1 unless the block has both neighbours
              : prevUL == prevU && prevUL == prevL ? 2 : prevUL == prevU || prevUL == prevL || prevU == prevL;
    int diff = sd.symbol(cdf.segment_id[ctx], MAX_SEGMENTS);
    // dav1d keeps the id in 8 bits and takes 0 for one past the last
    // active segment (the specification clips it to that segment) or past
    // 7; with no feature enabled (LastActiveSegId -1) it keeps what it read
    uint8_t id = (uint8_t)neg_deinterleave(diff, pred, P.LastActiveSegId + 1);
    if ((unsigned)id > (unsigned)P.LastActiveSegId) id = 0;
    if (id >= MAX_SEGMENTS) id = 0;
    segment_id = id;
  }

  void read_cdef() {
    if (skip || CodedLossless || !P.enable_cdef || P.allow_intrabc) return;
    int cdefSize4 = 16, cdefMask4 = ~(cdefSize4 - 1);
    int r = MiRow & cdefMask4, c = MiCol & cdefMask4;
    size_t k = mi(r, c);
    if (CdefIdx[k] == -1) {
      CdefIdx[k] = sd.literal(P.cdef_bits);
      int w4 = bw4(MiSize), h4 = bh4(MiSize);
      for (int y = r; y < r + h4; y += cdefSize4)
        for (int x = c; x < c + w4; x += cdefSize4) CdefIdx[mi(y, x)] = CdefIdx[k];
    }
  }

  // delta_q_abs / delta_lf_abs: 0-2, or 3 (DELTA_Q_SMALL / DELTA_LF_SMALL)
  // and the rest in bits
  int read_delta(uint16_t* cdf) {
    int a = sd.symbol(cdf, 4);
    if (a == 3) {
      int n = sd.literal(3) + 1;
      a = sd.literal(n) + (1 << n) + 1;
    }
    return a && sd.literal(1) ? -a : a;
  }
  void read_delta_qindex() {
    int sbSize = P.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if ((MiSize == sbSize && skip) || !ReadDeltas) return;
    int d = read_delta(cdf.delta_q);
    if (d) CurrentQIndex = clip3(1, 255, CurrentQIndex + d * (1 << P.delta_q_res));
  }
  void read_delta_lf() {
    int sbSize = P.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if ((MiSize == sbSize && skip) || !ReadDeltas || !P.delta_lf_present) return;
    int count = P.delta_lf_multi ? (P.NumPlanes > 1 ? 4 : 2) : 1;  // FRAME_LF_COUNT
    for (int i = 0; i < count; i++) {
      int d = read_delta(P.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf);
      if (d) DeltaLF[i] = clip3(-63, 63, DeltaLF[i] + d * (1 << P.delta_lf_res));  // MAX_LOOP_FILTER
    }
  }

  void read_cfl_alphas() {
    int signs = sd.symbol(cdf.cfl_sign, 8);
    int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
    if (signU) {
      int a = sd.symbol(cdf.cfl_alpha[(signU - 1) * 3 + signV], 16);
      CflAlphaU = signU == 1 ? -(1 + a) : 1 + a;
    }
    if (signV) {
      int a = sd.symbol(cdf.cfl_alpha[(signV - 1) * 3 + signU], 16);
      CflAlphaV = signV == 1 ? -(1 + a) : 1 + a;
    }
  }

  int get_palette_cache(int plane, int* cache) {
    int aboveN = 0, leftN = 0;
    if (((MiRow * 4) % 64) && AvailU) aboveN = PaletteSizes[plane][mi(MiRow - 1, MiCol)];
    if (AvailL) leftN = PaletteSizes[plane][mi(MiRow, MiCol - 1)];
    const uint16_t* ac = &PaletteColors[plane][mi(MiRow - 1, MiCol) * 8];
    const uint16_t* lc = &PaletteColors[plane][mi(MiRow, MiCol - 1) * 8];
    int ai = 0, li = 0, n = 0;
    while (ai < aboveN && li < leftN) {
      int aboveC = ac[ai], leftC = lc[li];
      if (leftC < aboveC) {
        if (n == 0 || leftC != cache[n - 1]) cache[n++] = leftC;
        li++;
      } else {
        if (n == 0 || aboveC != cache[n - 1]) cache[n++] = aboveC;
        ai++;
        if (leftC == aboveC) li++;
      }
    }
    while (ai < aboveN) {
      int v = ac[ai++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = v;
    }
    while (li < leftN) {
      int v = lc[li++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = v;
    }
    return n;
  }

  void palette_mode_info() {
    int bsizeCtx = Mi_Width_Log2[MiSize] + Mi_Height_Log2[MiSize] - 2;
    int cache[16];
    if (YMode == DC_PRED) {
      int ctx = 0;
      if (AvailU && PaletteSizes[0][mi(MiRow - 1, MiCol)] > 0) ctx++;
      if (AvailL && PaletteSizes[0][mi(MiRow, MiCol - 1)] > 0) ctx++;
      if (sd.symbol(cdf.palette_y_mode[bsizeCtx][ctx], 2)) {
        PaletteSizeY = sd.symbol(cdf.palette_y_size[bsizeCtx], 7) + 2;
        int cacheN = get_palette_cache(0, cache);
        int idx = 0;
        for (int i = 0; i < cacheN && idx < PaletteSizeY; i++)
          if (sd.literal(1)) palette_colors_y[idx++] = cache[i];
        if (idx < PaletteSizeY) palette_colors_y[idx++] = sd.literal(BitDepth);
        int paletteBits = 0;
        if (idx < PaletteSizeY) paletteBits = BitDepth - 3 + sd.literal(2);
        while (idx < PaletteSizeY) {
          int delta = sd.literal(paletteBits) + 1;
          palette_colors_y[idx] = clip1(palette_colors_y[idx - 1] + delta);
          int range = (1 << BitDepth) - palette_colors_y[idx] - 1;
          paletteBits = imin(paletteBits, ceil_log2(range));
          idx++;
        }
        std::sort(palette_colors_y, palette_colors_y + PaletteSizeY);
      }
    }
    if (HasChroma && UVMode == DC_PRED) {
      int ctx = PaletteSizeY > 0;
      if (sd.symbol(cdf.palette_uv_mode[ctx], 2)) {
        PaletteSizeUV = sd.symbol(cdf.palette_uv_size[bsizeCtx], 7) + 2;
        int cacheN = get_palette_cache(1, cache);
        int idx = 0;
        for (int i = 0; i < cacheN && idx < PaletteSizeUV; i++)
          if (sd.literal(1)) palette_colors_u[idx++] = cache[i];
        if (idx < PaletteSizeUV) palette_colors_u[idx++] = sd.literal(BitDepth);
        int paletteBits = 0;
        if (idx < PaletteSizeUV) paletteBits = BitDepth - 3 + sd.literal(2);
        while (idx < PaletteSizeUV) {
          int delta = sd.literal(paletteBits);
          palette_colors_u[idx] = clip1(palette_colors_u[idx - 1] + delta);
          int range = (1 << BitDepth) - palette_colors_u[idx];
          paletteBits = imin(paletteBits, ceil_log2(range));
          idx++;
        }
        std::sort(palette_colors_u, palette_colors_u + PaletteSizeUV);
        if (sd.literal(1)) {  // delta_encode_palette_colors_v
          int minBits = BitDepth - 4, maxVal = 1 << BitDepth;
          int bits = minBits + sd.literal(2);
          palette_colors_v[0] = sd.literal(BitDepth);
          for (idx = 1; idx < PaletteSizeUV; idx++) {
            int delta = sd.literal(bits);
            if (delta && sd.literal(1)) delta = -delta;
            int val = palette_colors_v[idx - 1] + delta;
            if (val < 0) val += maxVal;
            if (val >= maxVal) val -= maxVal;
            palette_colors_v[idx] = clip1(val);
          }
        } else {
          for (idx = 0; idx < PaletteSizeUV; idx++) palette_colors_v[idx] = sd.literal(BitDepth);
        }
      }
    }
  }

  int palette_color_context(uint8_t (*map)[64], int r, int c, int n, int* order) {
    int scores[8];
    for (int i = 0; i < 8; i++) { scores[i] = 0; order[i] = i; }
    if (c > 0) scores[map[r][c - 1]] += 2;
    if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
    if (r > 0) scores[map[r - 1][c]] += 2;
    for (int i = 0; i < 3; i++) {
      int maxScore = scores[i], maxIdx = i;
      for (int j = i + 1; j < n; j++)
        if (scores[j] > maxScore) { maxScore = scores[j]; maxIdx = j; }
      if (maxIdx != i) {
        maxScore = scores[maxIdx];
        int maxOrder = order[maxIdx];
        for (int k = maxIdx; k > i; k--) { scores[k] = scores[k - 1]; order[k] = order[k - 1]; }
        scores[i] = maxScore;
        order[i] = maxOrder;
      }
    }
    int hash = 0;
    for (int i = 0; i < 3; i++) hash += scores[i] * Palette_Color_Hash_Multipliers[i];
    return Palette_Color_Context[hash];
  }

  void read_color_map(uint8_t (*map)[64], int n, int bw, int bh, int onW, int onH, bool luma) {
    map[0][0] = sd.ns(n);
    int order[8];
    for (int i = 1; i < onH + onW - 1; i++)
      for (int j = imin(i, onW - 1); j >= imax(0, i - onH + 1); j--) {
        int ctx = palette_color_context(map, i - j, j, n, order);
        uint16_t* pc = luma ? cdf.palette_y_color[n - 2][ctx] : cdf.palette_uv_color[n - 2][ctx];
        int idx = sd.symbol(pc, n);
        map[i - j][j] = order[idx];
      }
    for (int i = 0; i < onH; i++)
      for (int j = onW; j < bw; j++) map[i][j] = map[i][onW - 1];
    for (int i = onH; i < bh; i++)
      for (int j = 0; j < bw; j++) map[i][j] = map[onH - 1][j];
  }

  void palette_tokens() {
    int bh = block_height(MiSize), bw = block_width(MiSize);
    int onH = imin(bh, (MiRows - MiRow) * 4), onW = imin(bw, (MiCols - MiCol) * 4);
    if (PaletteSizeY) read_color_map(ColorMapY, PaletteSizeY, bw, bh, onW, onH, true);
    if (PaletteSizeUV) {
      bh >>= P.subsampling_y; bw >>= P.subsampling_x;
      onH >>= P.subsampling_y; onW >>= P.subsampling_x;
      if (bw < 4) { bw += 2; onW += 2; }
      if (bh < 4) { bh += 2; onH += 2; }
      read_color_map(ColorMapUV, PaletteSizeUV, bw, bh, onW, onH, false);
    }
  }

  // ------------------------------------------------------------- tx size
  int get_above_tx_width(int row, int col) {
    if (row == MiRow) {
      if (!AvailU) return 64;
      if (Skips[mi(row - 1, col)] && IsInters[mi(row - 1, col)]) return block_width(MiSizes[mi(row - 1, col)]);
    }
    return tx_w(InterTxSizes[mi(row - 1, col)]);
  }
  int get_left_tx_height(int row, int col) {
    if (col == MiCol) {
      if (!AvailL) return 64;
      if (Skips[mi(row, col - 1)] && IsInters[mi(row, col - 1)]) return block_height(MiSizes[mi(row, col - 1)]);
    }
    return tx_h(InterTxSizes[mi(row, col - 1)]);
  }

  void read_var_tx_size(int row, int col, int txSz, int depth) {
    if (row >= MiRows || col >= MiCols) return;
    int split;
    if (txSz == TX_4X4 || depth == 2) {
      split = 0;
    } else {
      int above = get_above_tx_width(row, col) < tx_w(txSz);
      int left = get_left_tx_height(row, col) < tx_h(txSz);
      int size = imin(64, imax(block_width(MiSize), block_height(MiSize)));
      int maxTxSz = find_tx_size(size, size);
      int txSzSqrUp = tx_sqr_up(txSz);
      int ctx = (txSzSqrUp != maxTxSz) * 3 + (4 - maxTxSz) * 6 + above + left;
      split = sd.symbol(cdf.txfm_split[ctx], 2);
    }
    int w4 = tx_w(txSz) / 4, h4 = tx_h(txSz) / 4;
    if (split) {
      int sub = split_tx_size(txSz);
      int stepW = tx_w(sub) / 4, stepH = tx_h(sub) / 4;
      for (int i = 0; i < h4; i += stepH)
        for (int j = 0; j < w4; j += stepW) read_var_tx_size(row + i, col + j, sub, depth + 1);
    } else {
      for (int i = 0; i < h4; i++)
        for (int j = 0; j < w4; j++)
          if (row + i < MiRows + 32 && col + j < MiStride) InterTxSizes[mi(row + i, col + j)] = txSz;
      TxSize = txSz;
    }
  }

  void read_block_tx_size() {
    int w4 = bw4(MiSize), h4 = bh4(MiSize);
    if (P.TxMode == TX_MODE_SELECT && MiSize > BLOCK_4X4 && is_inter && !skip && !Lossless) {
      int maxTxSz = max_tx_size_rect(MiSize);
      int txW4 = tx_w(maxTxSz) / 4, txH4 = tx_h(maxTxSz) / 4;
      for (int row = MiRow; row < MiRow + h4; row += txH4)
        for (int col = MiCol; col < MiCol + w4; col += txW4) read_var_tx_size(row, col, maxTxSz, 0);
    } else {
      read_tx_size(!skip || !is_inter);
      for (int row = MiRow; row < MiRow + h4; row++)
        for (int col = MiCol; col < MiCol + w4; col++) InterTxSizes[mi(row, col)] = TxSize;
    }
  }

  void read_tx_size(int allowSelect) {
    if (Lossless) { TxSize = TX_4X4; return; }
    int maxRect = max_tx_size_rect(MiSize);
    int maxDepth = Max_Tx_Depth[MiSize];
    TxSize = maxRect;
    if (MiSize > BLOCK_4X4 && allowSelect && P.TxMode == TX_MODE_SELECT) {
      int maxW = tx_w(maxRect), maxH = tx_h(maxRect), aboveW, leftH;
      if (AvailU && IsInters[mi(MiRow - 1, MiCol)]) aboveW = block_width(MiSizes[mi(MiRow - 1, MiCol)]);
      else if (AvailU) aboveW = get_above_tx_width(MiRow, MiCol);
      else aboveW = 0;
      if (AvailL && IsInters[mi(MiRow, MiCol - 1)]) leftH = block_height(MiSizes[mi(MiRow, MiCol - 1)]);
      else if (AvailL) leftH = get_left_tx_height(MiRow, MiCol);
      else leftH = 0;
      int ctx = (aboveW >= maxW) + (leftH >= maxH);
      int depth;
      if (maxDepth == 4) depth = sd.symbol(cdf.tx_64x64[ctx], 3);
      else if (maxDepth == 3) depth = sd.symbol(cdf.tx_32x32[ctx], 3);
      else if (maxDepth == 2) depth = sd.symbol(cdf.tx_16x16[ctx], 3);
      else depth = sd.symbol(cdf.tx_8x8[ctx], 2);
      for (int i = 0; i < depth; i++) TxSize = split_tx_size(TxSize);
    }
  }

  void reset_block_context(int w4, int h4) {
    for (int plane = 0; plane < 1 + 2 * HasChroma; plane++) {
      int sx = ssx(plane), sy = ssy(plane);
      for (int i = MiCol >> sx; i < ((MiCol + w4) >> sx); i++) {
        AboveLevelContext[plane][i] = 0;
        AboveDcContext[plane][i] = 0;
      }
      for (int i = MiRow >> sy; i < ((MiRow + h4) >> sy); i++) {
        LeftLevelContext[plane][i] = 0;
        LeftDcContext[plane][i] = 0;
      }
    }
  }

  // ------------------------------------------------ MV prediction (7.10.2)
  // The stack of candidate vectors for RefFrame[0] (INTRA_FRAME for
  // IntraBC): the neighbours' vectors weighted by the length they share with
  // the block, the nearest rows and columns first, sorted; extra search of
  // other references (their vectors negated where the sign bias differs);
  // then the contexts of the mode symbols and the clamping. Single
  // references only; no temporal candidates (use_ref_frame_mvs raises
  // before the tiles) and no global motion (every GlobalMvs is zero).
  int NumMvFound, NewMvCount, FoundMatch, CloseMatches, TotalMatches;
  int NewMvContext, RefMvContext, ZeroMvContext;
  int RefStackMv[9][2], WeightStack[9], DrlCtxStack[9];

  void lower_mv_precision(int* mv) const {
    if (P.allow_high_precision_mv) return;
    for (int i = 0; i < 2; i++) {
      if (P.force_integer_mv) {
        int a = abs(mv[i]), aInt = (a + 3) >> 3;
        mv[i] = mv[i] > 0 ? (aInt << 3) : -(aInt << 3);
      } else if (mv[i] & 1) {
        mv[i] += mv[i] > 0 ? -1 : 1;
      }
    }
  }
  static bool has_newmv(int mode) {
    return mode == NEWMV || mode == NEW_NEWMV || mode == NEAREST_NEWMV || mode == NEW_NEARESTMV ||
           mode == NEAR_NEWMV || mode == NEW_NEARMV;
  }
  void add_ref_mv_candidate(int r, int c, int weight) {
    size_t k = mi(r, c);
    if (!IsInters[k] || RefFrame0[k] != RefFrame[0]) return;  // list 1 is NONE
    int cand[2] = {MvRow[k], MvCol[k]};
    lower_mv_precision(cand);
    if (has_newmv(YModes[k])) NewMvCount++;
    FoundMatch = 1;
    int idx;
    for (idx = 0; idx < NumMvFound; idx++)
      if (cand[0] == RefStackMv[idx][0] && cand[1] == RefStackMv[idx][1]) break;
    if (idx < NumMvFound) {
      WeightStack[idx] += weight;
    } else if (NumMvFound < 8) {
      RefStackMv[NumMvFound][0] = cand[0];
      RefStackMv[NumMvFound][1] = cand[1];
      WeightStack[NumMvFound] = weight;
      NumMvFound++;
    }
  }
  void scan_row(int deltaRow) {
    int w4 = bw4(MiSize);
    int end4 = imin(imin(w4, MiCols - MiCol), 16);
    int deltaCol = 0;
    int useStep16 = w4 >= 16;
    if (abs(deltaRow) > 1) { deltaRow += MiRow & 1; deltaCol = 1 - (MiCol & 1); }
    int i = 0;
    while (i < end4) {
      int r = MiRow + deltaRow, c = MiCol + deltaCol + i;
      if (!is_inside(r, c)) break;
      int len = imin(w4, bw4(MiSizes[mi(r, c)]));
      if (abs(deltaRow) > 1) len = imax(2, len);
      if (useStep16) len = imax(4, len);
      add_ref_mv_candidate(r, c, len * 2);
      i += len;
    }
  }
  void scan_col(int deltaCol) {
    int h4 = bh4(MiSize);
    int end4 = imin(imin(h4, MiRows - MiRow), 16);
    int deltaRow = 0;
    int useStep16 = h4 >= 16;
    if (abs(deltaCol) > 1) { deltaRow = 1 - (MiRow & 1); deltaCol += MiCol & 1; }
    int i = 0;
    while (i < end4) {
      int r = MiRow + deltaRow + i, c = MiCol + deltaCol;
      if (!is_inside(r, c)) break;
      int len = imin(h4, bh4(MiSizes[mi(r, c)]));
      if (abs(deltaCol) > 1) len = imax(2, len);
      if (useStep16) len = imax(4, len);
      add_ref_mv_candidate(r, c, len * 2);
      i += len;
    }
  }
  void scan_point(int deltaRow, int deltaCol) {
    int r = MiRow + deltaRow, c = MiCol + deltaCol;
    if (is_inside(r, c) && Decoded[mi(r, c)]) add_ref_mv_candidate(r, c, 4);
  }
  void sort_stack(int start, int end) {
    while (end > start) {
      int newEnd = start;
      for (int idx = start + 1; idx < end; idx++)
        if (WeightStack[idx - 1] < WeightStack[idx]) {
          std::swap(WeightStack[idx - 1], WeightStack[idx]);
          std::swap(RefStackMv[idx - 1][0], RefStackMv[idx][0]);
          std::swap(RefStackMv[idx - 1][1], RefStackMv[idx][1]);
          newEnd = idx;
        }
      end = newEnd;
    }
  }
  void add_extra_mv_candidate(int r, int c) {
    size_t k = mi(r, c);
    int candRef = RefFrame0[k];
    if (candRef <= INTRA_FRAME) return;
    int cand[2] = {MvRow[k], MvCol[k]};
    if (P.RefFrameSignBias[candRef] != P.RefFrameSignBias[RefFrame[0]]) {
      cand[0] *= -1;
      cand[1] *= -1;
    }
    int idx;
    for (idx = 0; idx < NumMvFound; idx++)
      if (cand[0] == RefStackMv[idx][0] && cand[1] == RefStackMv[idx][1]) break;
    if (idx == NumMvFound) {
      RefStackMv[idx][0] = cand[0];
      RefStackMv[idx][1] = cand[1];
      WeightStack[idx] = 2;
      NumMvFound++;
    }
  }
  void extra_search() {
    int w4 = imin(imin(16, bw4(MiSize)), MiCols - MiCol), h4 = imin(imin(16, bh4(MiSize)), MiRows - MiRow);
    int num4x4 = imin(w4, h4);
    for (int pass = 0; pass < 2 && NumMvFound < 2; pass++) {
      int idx = 0;
      while (idx < num4x4 && NumMvFound < 2) {
        int r = pass == 0 ? MiRow - 1 : MiRow + idx, c = pass == 0 ? MiCol + idx : MiCol - 1;
        if (!is_inside(r, c)) break;
        add_extra_mv_candidate(r, c);
        idx += pass == 0 ? bw4(MiSizes[mi(r, c)]) : bh4(MiSizes[mi(r, c)]);
      }
    }
    for (int idx = NumMvFound; idx < 2; idx++) RefStackMv[idx][0] = RefStackMv[idx][1] = 0;  // GlobalMvs[0]
  }
  void find_mv_stack() {
    int w4 = bw4(MiSize), h4 = bh4(MiSize);
    NumMvFound = NewMvCount = 0;
    FoundMatch = 0;
    scan_row(-1);
    int foundAboveMatch = FoundMatch;
    FoundMatch = 0;
    scan_col(-1);
    int foundLeftMatch = FoundMatch;
    FoundMatch = 0;
    if (imax(w4, h4) <= 16) scan_point(-1, w4);
    if (FoundMatch) foundAboveMatch = 1;
    CloseMatches = foundAboveMatch + foundLeftMatch;
    int numNearest = NumMvFound, numNew = NewMvCount;
    for (int i = 0; i < numNearest; i++) WeightStack[i] += REF_CAT_LEVEL;
    ZeroMvContext = 0;
    FoundMatch = 0;
    scan_point(-1, -1);
    if (FoundMatch) foundAboveMatch = 1;
    FoundMatch = 0;
    scan_row(-3);
    if (FoundMatch) foundAboveMatch = 1;
    FoundMatch = 0;
    scan_col(-3);
    if (FoundMatch) foundLeftMatch = 1;
    FoundMatch = 0;
    if (h4 > 1) scan_row(-5);
    if (FoundMatch) foundAboveMatch = 1;
    FoundMatch = 0;
    if (w4 > 1) scan_col(-5);
    if (FoundMatch) foundLeftMatch = 1;
    TotalMatches = foundAboveMatch + foundLeftMatch;
    sort_stack(0, numNearest);
    sort_stack(numNearest, NumMvFound);
    if (NumMvFound < 2) extra_search();
    // context_and_clamping (7.10.2.14)
    for (int idx = 0; idx < NumMvFound; idx++) {
      int z = 0;
      if (idx + 1 < NumMvFound) {
        int w0 = WeightStack[idx], w1 = WeightStack[idx + 1];
        if (w0 >= REF_CAT_LEVEL) z = w1 < REF_CAT_LEVEL;
        else z = 2;
      }
      DrlCtxStack[idx] = z;
    }
    for (int idx = 0; idx < NumMvFound; idx++) {
      int border = MV_BORDER + h4 * 4 * 8;
      int toTop = -((MiRow * 4) * 8), toBottom = ((MiRows - h4 - MiRow) * 4) * 8;
      RefStackMv[idx][0] = clip3(toTop - border, toBottom + border, RefStackMv[idx][0]);
      border = MV_BORDER + w4 * 4 * 8;
      int toLeft = -((MiCol * 4) * 8), toRight = ((MiCols - w4 - MiCol) * 4) * 8;
      RefStackMv[idx][1] = clip3(toLeft - border, toRight + border, RefStackMv[idx][1]);
    }
    if (CloseMatches == 0) {
      NewMvContext = imin(TotalMatches, 1);
      RefMvContext = TotalMatches;
    } else if (CloseMatches == 1) {
      NewMvContext = 3 - imin(numNew, 1);
      RefMvContext = 2 + TotalMatches;
    } else {
      NewMvContext = 5 - imin(numNew, 1);
      RefMvContext = 5;
    }
  }

  // IntraBC (5.11.26 with use_intrabc): the stack's first nonzero vector,
  // or a superblock up or left, plus a whole-pel difference
  void find_mv_stack_and_assign() {
    RefFrame[0] = INTRA_FRAME;
    RefFrame[1] = NONE;
    find_mv_stack();
    int pred[2] = {RefStackMv[0][0], RefStackMv[0][1]};
    if (pred[0] == 0 && pred[1] == 0) { pred[0] = RefStackMv[1][0]; pred[1] = RefStackMv[1][1]; }
    if (pred[0] == 0 && pred[1] == 0) {
      int sbSize4 = P.use_128 ? 32 : 16;
      if (MiRow - sbSize4 < MiRowStart) {
        pred[0] = 0;
        pred[1] = -(sbSize4 * 4 + 256) * 8;
      } else {
        pred[0] = -(sbSize4 * 4 * 8);
        pred[1] = 0;
      }
    }
    Mv[0] = pred[0];
    Mv[1] = pred[1];
    read_mv(1);  // MV_INTRABC_CONTEXT, integer precision
    if ((Mv[0] & 7) || (Mv[1] & 7)) fail("IntraBC vector is not whole-pel");
  }
  // read_mv (5.11.32): Mv += the coded difference, at the frame's
  // precision (force_integer_mv, allow_high_precision_mv); MvCtx 0, or 1
  // for IntraBC
  void read_mv(int ctx) {
    int joint = sd.symbol(cdf.mv_joint[ctx], 4);
    if (joint == 2 || joint == 3) Mv[0] += read_mv_component(ctx, 0);
    if (joint == 1 || joint == 3) Mv[1] += read_mv_component(ctx, 1);
  }
  int read_mv_component(int ctx, int comp) {
    int sign = sd.symbol(cdf.mv_sign[ctx][comp], 2);
    int cls = sd.symbol(cdf.mv_class[ctx][comp], 11);
    int mag;
    if (cls == 0) {
      int bit = sd.symbol(cdf.mv_class0_bit[ctx][comp], 2);
      int fr = P.force_integer_mv ? 3 : sd.symbol(cdf.mv_class0_fr[ctx][comp][bit], 4);
      int hp = P.allow_high_precision_mv ? sd.symbol(cdf.mv_class0_hp[ctx][comp], 2) : 1;
      mag = ((bit << 3) | (fr << 1) | hp) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < cls; i++) d |= sd.symbol(cdf.mv_bit[ctx][comp][i], 2) << i;
      mag = 2 << (cls + 2);
      int fr = P.force_integer_mv ? 3 : sd.symbol(cdf.mv_fr[ctx][comp], 4);
      int hp = P.allow_high_precision_mv ? sd.symbol(cdf.mv_hp[ctx][comp], 2) : 1;
      mag += ((d << 3) | (fr << 1) | hp) + 1;
    }
    return sign ? -mag : mag;
  }

  // ---------------------------------------------------------- prediction
  // 7.11.3: an inter block's prediction, per plane: one from the block's
  // own vector, or, for chroma of a block under 8x8 whose neighbours in its
  // 8x8 are all inter, one from each of those luma blocks' vectors and
  // filters (candRow / candCol); IntraBC predicts from the current frame
  void compute_prediction() {
    if (!is_inter) return;  // intra prediction runs per transform block
    for (int plane = 0; plane < 1 + HasChroma * 2; plane++) {
      int planeSz = plane_size(plane);
      int num4x4W = bw4(planeSz), num4x4H = bh4(planeSz);
      int subX = ssx(plane), subY = ssy(plane);
      int baseX = (MiCol >> subX) * 4, baseY = (MiRow >> subY) * 4;
      if (use_intrabc) {
        // the reference is the current frame: its edge is the decoded,
        // 8-aligned MiCols x MiRows area, not the frame size (as dav1d
        // bounds it); the filter is BILINEAR
        predict(F.at(plane, 0, 0), F.stride[plane], ((MiCols * 4) >> subX) - 1, ((MiRows * 4) >> subY) - 1, plane,
                baseX, baseY, num4x4W * 4, num4x4H * 4, Mv, BILINEAR);
        continue;
      }
      int candRow = (MiRow >> subY) << subY, candCol = (MiCol >> subX) << subX;
      int predW = block_width(MiSize) >> subX, predH = block_height(MiSize) >> subY;
      bool someUseIntra = false;
      for (int r = 0; r < (num4x4H << subY); r++)
        for (int c = 0; c < (num4x4W << subX); c++)
          if (RefFrame0[mi(candRow + r, candCol + c)] == INTRA_FRAME) someUseIntra = true;
      if (someUseIntra) {
        predW = num4x4W * 4;
        predH = num4x4H * 4;
        candRow = MiRow;
        candCol = MiCol;
      }
      // references of the frame's own size (others raise before the tiles)
      int refW = (P.UpscaledWidth + subX) >> subX, refH = (P.FrameHeight + subY) >> subY;
      for (int y = 0, r = 0; y < num4x4H * 4; y += predH, r++)
        for (int x = 0, c = 0; x < num4x4W * 4; x += predW, c++) {
          size_t k = mi(candRow + r, candCol + c);
          int mv[2] = {MvRow[k], MvCol[k]};
          predict(RefPlanes[RefFrame0[k]][plane], refW, refW - 1, refH - 1, plane, baseX + x, baseY + y, predW, predH,
                  mv, InterpFilters[k]);
        }
    }
  }

  // motion_vector_scaling (7.11.3.3) for a reference of the frame's size
  // (xScale = yScale = 1 << 14: positions in 1/1024 samples, steps of 1024)
  // and block_inter_prediction (7.11.3.4): the 8-tap filter across, rounded
  // by InterRound0, then down, rounded by InterRound1 to a sample (not
  // compound), reading the reference clamped at (lastX, lastY); a block 4
  // samples wide or high takes the 4-tap filters in that direction
  void predict(const pixel* ref, int refStride, int lastX, int lastY, int plane, int x, int y, int w, int h,
               const int* mv, int filter) {
    int sx = ssx(plane), sy = ssy(plane);
    int startX = ((x << 4) + ((2 * mv[1]) >> sx)) * 64 + 32;
    int startY = ((y << 4) + ((2 * mv[0]) >> sy)) * 64 + 32;
    auto small = [filter](int n) {
      if (n > 4) return filter;
      return filter == EIGHTTAP || filter == EIGHTTAP_SHARP ? 4 : filter == EIGHTTAP_SMOOTH ? 5 : filter;
    };
    int filterX = small(w), filterY = small(h);
    int interH = (((h - 1) * 1024 + 1023) >> 10) + 8;
    int round0 = BitDepth == 12 ? 5 : 3, round1 = BitDepth == 12 ? 9 : 11;  // InterRound0 / 1, not compound
    for (int r = 0; r < interH; r++) {
      const pixel* row = ref + (size_t)clip3(0, lastY, (startY >> 10) + r - 3) * refStride;
      for (int c = 0; c < w; c++) {
        int p = startX + 1024 * c;
        const int16_t* f = Subpel_Filters[filterX][(p >> 6) & 15];
        int s = 0;
        for (int t = 0; t < 8; t++) s += f[t] * row[clip3(0, lastX, (p >> 10) + t - 3)];
        InterBuf[r * w + c] = round2(s, round0);
      }
    }
    for (int r = 0; r < h; r++) {
      int p = (startY & 1023) + 1024 * r;
      const int16_t* f = Subpel_Filters[filterY][(p >> 6) & 15];
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 8; t++) s += f[t] * InterBuf[((p >> 10) + t) * w + c];
        *F.at(plane, y + r, x + c) = clip1(round2(s, round1));
      }
    }
  }

  int get_filter_type(int plane) {
    int aboveSmooth = 0, leftSmooth = 0;
    auto is_smooth = [&](int r, int c, int pl) {
      int mode;
      if (pl == 0) mode = YModes[mi(r, c)];
      else {
        if (RefFrame0[mi(r, c)] > 0) return 0;
        mode = UVModes[mi(r, c)];
      }
      return (int)(mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED);
    };
    if (plane == 0 ? AvailU : AvailUChroma) {
      int r = MiRow - 1, c = MiCol;
      if (plane > 0) {
        if (P.subsampling_x && !(MiCol & 1)) c++;
        if (P.subsampling_y && (MiRow & 1)) r--;
      }
      aboveSmooth = is_smooth(r, c, plane);
    }
    if (plane == 0 ? AvailL : AvailLChroma) {
      int r = MiRow, c = MiCol - 1;
      if (plane > 0) {
        if (P.subsampling_x && (MiCol & 1)) c--;
        if (P.subsampling_y && !(MiRow & 1)) r++;
      }
      leftSmooth = is_smooth(r, c, plane);
    }
    return aboveSmooth || leftSmooth;
  }

  static int edge_strength(int w, int h, int filterType, int delta) {
    int d = abs(delta), blkWh = w + h, s = 0;
    if (filterType == 0) {
      if (blkWh <= 8) { if (d >= 56) s = 1; }
      else if (blkWh <= 12) { if (d >= 40) s = 1; }
      else if (blkWh <= 16) { if (d >= 40) s = 1; }
      else if (blkWh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (blkWh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (blkWh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (blkWh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (blkWh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }
  static int use_upsample(int w, int h, int filterType, int delta) {
    int d = abs(delta), blkWh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filterType == 0 ? blkWh <= 16 : blkWh <= 8;
  }
  static void edge_filter(int* buf, int sz, int strength) {  // buf[-1 ..] in place
    if (!strength) return;
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += Intra_Edge_Kernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }
  void upsample(int* buf, int numPx) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
    dup[numPx + 2] = buf[numPx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numPx; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip1(round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int haveLeft, int haveAbove, int haveAboveRight,
                     int haveBelowLeft, int mode, int log2W, int log2H) {
    int w = 1 << log2W, h = 1 << log2H;
    int maxX = ((MiCols * 4) >> ssx(plane)) - 1, maxY = ((MiRows * 4) >> ssy(plane)) - 1;
    int aboveBuf[320], leftBuf[320];
    int* AboveRow = aboveBuf + 16;
    int* LeftCol = leftBuf + 16;
    int n = w + h;
    if (!haveAbove && haveLeft) {
      int v = *F.at(plane, y, x - 1);
      for (int i = 0; i < n; i++) AboveRow[i] = v;
    } else if (!haveAbove && !haveLeft) {
      for (int i = 0; i < n; i++) AboveRow[i] = (1 << (BitDepth - 1)) - 1;
    } else {
      int aboveLimit = imin(maxX, x + (haveAboveRight ? 2 * w : w) - 1);
      for (int i = 0; i < n; i++) AboveRow[i] = *F.at(plane, y - 1, imin(aboveLimit, x + i));
    }
    if (!haveLeft && haveAbove) {
      int v = *F.at(plane, y - 1, x);
      for (int i = 0; i < n; i++) LeftCol[i] = v;
    } else if (!haveLeft && !haveAbove) {
      for (int i = 0; i < n; i++) LeftCol[i] = (1 << (BitDepth - 1)) + 1;
    } else {
      int leftLimit = imin(maxY, y + (haveBelowLeft ? 2 * h : h) - 1);
      for (int i = 0; i < n; i++) LeftCol[i] = *F.at(plane, imin(leftLimit, y + i), x - 1);
    }
    if (haveAbove && haveLeft) AboveRow[-1] = *F.at(plane, y - 1, x - 1);
    else if (haveAbove) AboveRow[-1] = *F.at(plane, y - 1, x);
    else if (haveLeft) AboveRow[-1] = *F.at(plane, y, x - 1);
    else AboveRow[-1] = 1 << (BitDepth - 1);
    LeftCol[-1] = AboveRow[-1];

    static int pred[64][64];
    if (plane == 0 && use_filter_intra) {
      int w4 = w >> 2, h2 = h >> 1;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int p[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) p[i] = AboveRow[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) p[i] = LeftCol[(i2 << 1) - 1];
              else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0) p[i] = LeftCol[(i2 << 1) + i - 5];
              else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += Filter_Intra_Taps[filter_intra_mode][i][j] * p[j];
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip1(round2signed(pr, 4));
          }
        }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      int angleDelta = plane == 0 ? AngleDeltaY : AngleDeltaUV;
      int pAngle = Mode_To_Angle[mode] + angleDelta * 3;
      int upsampleAbove = 0, upsampleLeft = 0;
      if (P.enable_intra_edge_filter) {
        int filterType = get_filter_type(plane);
        if (pAngle != 90 && pAngle != 180) {
          if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
            int v = round2(LeftCol[0] * 5 + AboveRow[-1] * 6 + AboveRow[0] * 5, 4);
            LeftCol[-1] = AboveRow[-1] = v;
          }
          if (haveAbove) {
            int strength = edge_strength(w, h, filterType, pAngle - 90);
            int numPx = imin(w, maxX - x + 1) + (pAngle < 90 ? h : 0) + 1;
            edge_filter(AboveRow, numPx, strength);
          }
          if (haveLeft) {
            int strength = edge_strength(w, h, filterType, pAngle - 180);
            int numPx = imin(h, maxY - y + 1) + (pAngle > 180 ? w : 0) + 1;
            edge_filter(LeftCol, numPx, strength);
          }
        }
        upsampleAbove = use_upsample(w, h, filterType, pAngle - 90);
        int numPx = w + (pAngle < 90 ? h : 0);
        if (upsampleAbove) upsample(AboveRow, numPx);
        upsampleLeft = use_upsample(w, h, filterType, pAngle - 180);
        numPx = h + (pAngle > 180 ? w : 0);
        if (upsampleLeft) upsample(LeftCol, numPx);
      }
      int dx = 0, dy = 0;
      if (pAngle < 90) dx = Dr_Intra_Derivative[pAngle];
      else if (pAngle > 90 && pAngle < 180) dx = Dr_Intra_Derivative[180 - pAngle];
      if (pAngle > 90 && pAngle < 180) dy = Dr_Intra_Derivative[pAngle - 90];
      else if (pAngle > 180) dy = Dr_Intra_Derivative[270 - pAngle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (pAngle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - upsampleAbove)) + (j << upsampleAbove);
            int shift = ((idx << upsampleAbove) >> 1) & 0x1F;
            int maxBaseX = (w + h - 1) << upsampleAbove;
            if (base < maxBaseX)
              v = round2(AboveRow[base] * (32 - shift) + AboveRow[base + 1] * shift, 5);
            else
              v = AboveRow[maxBaseX];
          } else if (pAngle > 90 && pAngle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - upsampleAbove);
            if (base >= -(1 << upsampleAbove)) {
              int shift = ((idx * (1 << upsampleAbove)) >> 1) & 0x1F;
              v = round2(AboveRow[base] * (32 - shift) + AboveRow[base + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - upsampleLeft);
              int shift = ((idx * (1 << upsampleLeft)) >> 1) & 0x1F;
              v = round2(LeftCol[base] * (32 - shift) + LeftCol[base + 1] * shift, 5);
            }
          } else if (pAngle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - upsampleLeft)) + (i << upsampleLeft);
            int shift = ((idx << upsampleLeft) >> 1) & 0x1F;
            int maxBaseY = (w + h - 1) << upsampleLeft;
            if (base < maxBaseY)
              v = round2(LeftCol[base] * (32 - shift) + LeftCol[base + 1] * shift, 5);
            else
              v = LeftCol[maxBaseY];
          } else if (pAngle == 90) {
            v = AboveRow[j];
          } else {
            v = LeftCol[i];
          }
          pred[i][j] = v;
        }
    } else if (mode == SMOOTH_PRED) {
      const uint8_t* wx = Sm_Weights + (1 << log2W) - 4;
      const uint8_t* wy = Sm_Weights + (1 << log2H) - 4;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int s = wy[i] * AboveRow[j] + (256 - wy[i]) * LeftCol[h - 1] + wx[j] * LeftCol[i] +
                  (256 - wx[j]) * AboveRow[w - 1];
          pred[i][j] = round2(s, 9);
        }
    } else if (mode == SMOOTH_V_PRED) {
      const uint8_t* wy = Sm_Weights + (1 << log2H) - 4;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = round2(wy[i] * AboveRow[j] + (256 - wy[i]) * LeftCol[h - 1], 8);
    } else if (mode == SMOOTH_H_PRED) {
      const uint8_t* wx = Sm_Weights + (1 << log2W) - 4;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = round2(wx[j] * LeftCol[i] + (256 - wx[j]) * AboveRow[w - 1], 8);
    } else if (mode == DC_PRED) {
      int avg;
      if (haveAbove && haveLeft) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += AboveRow[k];
        for (int k = 0; k < h; k++) sum += LeftCol[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (haveAbove) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += AboveRow[k];
        avg = (sum + (w >> 1)) >> log2W;
      } else if (haveLeft) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += LeftCol[k];
        avg = (sum + (h >> 1)) >> log2H;
      } else {
        avg = 1 << (BitDepth - 1);
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = avg;
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = AboveRow[j] + LeftCol[i] - AboveRow[-1];
          int pLeft = abs(base - LeftCol[i]), pTop = abs(base - AboveRow[j]), pTopLeft = abs(base - AboveRow[-1]);
          if (pLeft <= pTop && pLeft <= pTopLeft) pred[i][j] = LeftCol[i];
          else if (pTop <= pTopLeft) pred[i][j] = AboveRow[j];
          else pred[i][j] = AboveRow[-1];
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) *F.at(plane, y + i, x + j) = (pixel)pred[i][j];
  }

  void predict_cfl(int plane, int startX, int startY, int txSz) {
    int w = tx_w(txSz), h = tx_h(txSz);
    int alpha = plane == 1 ? CflAlphaU : CflAlphaV;
    static int L[32][32];
    int subX = P.subsampling_x, subY = P.subsampling_y;
    int64_t lumaAvg = 0;
    for (int i = 0; i < h; i++) {
      int lumaY = imin(startY + i, (MaxLumaH >> subY) - 1) << subY;
      for (int j = 0; j < w; j++) {
        int lumaX = imin(startX + j, (MaxLumaW >> subX) - 1) << subX;
        int t = 0;
        for (int dy = 0; dy <= subY; dy++)
          for (int dx = 0; dx <= subX; dx++) t += *F.at(0, lumaY + dy, lumaX + dx);
        int v = t << (3 - subX - subY);
        L[i][j] = v;
        lumaAvg += v;
      }
    }
    int avg = round2(lumaAvg, Tx_Width_Log2[txSz] + Tx_Height_Log2[txSz]);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        pixel* px = F.at(plane, startY + i, startX + j);
        int scaled = round2signed((int64_t)alpha * (L[i][j] - avg), 6);
        *px = clip1(*px + scaled);
      }
  }

  void predict_palette(int plane, int startX, int startY, int x, int y, int txSz) {
    int w = tx_w(txSz), h = tx_h(txSz);
    const int* pal = plane == 0 ? palette_colors_y : plane == 1 ? palette_colors_u : palette_colors_v;
    uint8_t (*map)[64] = plane == 0 ? ColorMapY : ColorMapUV;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) *F.at(plane, startY + i, startX + j) = pal[map[y * 4 + i][x * 4 + j]];
  }

  // ------------------------------------------------------------ residual
  int get_tx_size(int plane, int txSz) {
    if (plane == 0) return txSz;
    int uvTx = max_tx_size_rect(plane_size(plane));
    if (tx_w(uvTx) == 64 || tx_h(uvTx) == 64) {
      if (tx_w(uvTx) == 16) return TX_16X32;
      if (tx_h(uvTx) == 16) return TX_32X16;
      return TX_32X32;
    }
    return uvTx;
  }

  void residual() {
    int widthChunks = imax(1, block_width(MiSize) >> 6), heightChunks = imax(1, block_height(MiSize) >> 6);
    for (int chunkY = 0; chunkY < heightChunks; chunkY++)
      for (int chunkX = 0; chunkX < widthChunks; chunkX++) {
        int miRowChunk = MiRow + (chunkY << 4), miColChunk = MiCol + (chunkX << 4);
        for (int plane = 0; plane < 1 + HasChroma * 2; plane++) {
          int txSz = Lossless ? TX_4X4 : get_tx_size(plane, TxSize);
          int stepX = tx_w(txSz) >> 2, stepY = tx_h(txSz) >> 2;
          int planeSz = plane_size(plane);
          int num4x4W = bw4(planeSz), num4x4H = bh4(planeSz);
          int sx = ssx(plane), sy = ssy(plane);
          int baseX = (miColChunk >> sx) * 4, baseY = (miRowChunk >> sy) * 4;
          if (is_inter && !Lossless && !plane) {
            int maxTx = max_tx_size_rect(MiSize);
            int tw = tx_w(maxTx), th = tx_h(maxTx);
            int cw = imin(64, num4x4W * 4), ch = imin(64, num4x4H * 4);
            for (int yy = 0; yy < ch; yy += th)
              for (int xx = 0; xx < cw; xx += tw) transform_tree(baseX + xx, baseY + yy, tw, th);
          } else {
            int baseXBlock = (MiCol >> sx) * 4, baseYBlock = (MiRow >> sy) * 4;
            for (int y = 0; y < imin(num4x4H, 16 >> sy); y += stepY)
              for (int x = 0; x < imin(num4x4W, 16 >> sx); x += stepX)
                transform_block(plane, baseXBlock, baseYBlock, txSz, x + ((chunkX << 4) >> sx),
                                y + ((chunkY << 4) >> sy));
          }
        }
      }
  }

  void transform_tree(int startX, int startY, int w, int h) {
    int maxX = MiCols * 4, maxY = MiRows * 4;
    if (startX >= maxX || startY >= maxY) return;
    int row = startY >> 2, col = startX >> 2;
    int txSz = InterTxSizes[mi(row, col)];
    if (w <= tx_w(txSz) && h <= tx_h(txSz)) {
      transform_block(0, startX, startY, find_tx_size(w, h), 0, 0);
    } else if (w > h) {
      transform_tree(startX, startY, w / 2, h);
      transform_tree(startX + w / 2, startY, w / 2, h);
    } else if (w < h) {
      transform_tree(startX, startY, w, h / 2);
      transform_tree(startX, startY + h / 2, w, h / 2);
    } else {
      transform_tree(startX, startY, w / 2, h / 2);
      transform_tree(startX + w / 2, startY, w / 2, h / 2);
      transform_tree(startX, startY + h / 2, w / 2, h / 2);
      transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
    }
  }

  void transform_block(int plane, int baseX, int baseY, int txSz, int x, int y) {
    int startX = baseX + 4 * x, startY = baseY + 4 * y;
    int sx = ssx(plane), sy = ssy(plane);
    int row = (startY << sy) >> 2, col = (startX << sx) >> 2;
    int sbMask = P.use_128 ? 31 : 15;
    int subBlockMiRow = row & sbMask, subBlockMiCol = col & sbMask;
    int stepX = tx_w(txSz) >> 2, stepY = tx_h(txSz) >> 2;
    int maxX = (MiCols * 4) >> sx, maxY = (MiRows * 4) >> sy;
    if (startX >= maxX || startY >= maxY) return;
    if (!is_inter) {
      if ((plane == 0 && PaletteSizeY) || (plane != 0 && PaletteSizeUV)) {
        predict_palette(plane, startX, startY, x, y, txSz);
      } else {
        int isCfl = plane > 0 && UVMode == UV_CFL_PRED;
        int mode = plane == 0 ? YMode : (isCfl ? DC_PRED : UVMode);
        int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
        int by = (subBlockMiRow >> sy), bx = (subBlockMiCol >> sx);
        predict_intra(plane, startX, startY, (plane == 0 ? AvailL : AvailLChroma) || x > 0,
                      (plane == 0 ? AvailU : AvailUChroma) || y > 0,
                      BlockDecoded[plane][by - 1 + 1][bx + stepX + 1], BlockDecoded[plane][by + stepY + 1][bx - 1 + 1],
                      mode, log2W, log2H);
        if (isCfl) predict_cfl(plane, startX, startY, txSz);
      }
      if (plane == 0) {
        MaxLumaW = startX + stepX * 4;
        MaxLumaH = startY + stepY * 4;
      }
    }
    if (!skip) {
      int eob = coeffs(plane, startX, startY, txSz);
      if (eob > 0) reconstruct(plane, startX, startY, txSz);
    }
    for (int i = 0; i < stepY; i++)
      for (int j = 0; j < stepX; j++) {
        int ly = (row >> sy) + i, lx = (col >> sx) + j;
        LfTxSizes[plane][(size_t)ly * lfStride[plane] + lx] = txSz;
        int by = (subBlockMiRow >> sy) + i, bx = (subBlockMiCol >> sx) + j;
        if (by < 33 && bx < 33) BlockDecoded[plane][by + 1][bx + 1] = 1;
      }
  }

  int get_tx_set(int txSz) {
    int sqr = tx_sqr(txSz), sqrUp = tx_sqr_up(txSz);
    if (sqrUp > TX_32X32) return TX_SET_DCTONLY;
    if (is_inter) {
      if (P.reduced_tx_set || sqrUp == TX_32X32) return TX_SET_INTER_3;
      if (sqr == TX_16X16) return TX_SET_INTER_2;
      return TX_SET_INTER_1;
    }
    if (sqrUp == TX_32X32) return TX_SET_DCTONLY;
    if (P.reduced_tx_set) return TX_SET_INTRA_2;
    if (sqr == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }
  bool tx_type_in_set(int set, int t) {
    if (is_inter) {
      switch (set) {
        case TX_SET_DCTONLY: return t == DCT_DCT;
        case TX_SET_INTER_1: return true;
        case TX_SET_INTER_2: return t < V_ADST;
        default: return t == DCT_DCT || t == IDTX;
      }
    }
    switch (set) {
      case TX_SET_DCTONLY: return t == DCT_DCT;
      case TX_SET_INTRA_1: return t <= ADST_ADST || t == IDTX || t == V_DCT || t == H_DCT;
      default: return t <= ADST_ADST || t == IDTX;
    }
  }

  void transform_type(int x4, int y4, int txSz) {
    int set = get_tx_set(txSz);
    int TxType = DCT_DCT;
    // 5.11.47: the frame's qindex, its segment's with segmentation
    if (set > 0 && (P.segmentation_enabled ? get_qidx(1) : P.base_q_idx) > 0) {
      int sqr = tx_sqr(txSz);
      if (is_inter) {
        if (set == TX_SET_INTER_1) TxType = Tx_Type_Inter_Inv_Set1[sd.symbol(cdf.inter_tx_set1[sqr], 16)];
        else if (set == TX_SET_INTER_2) TxType = Tx_Type_Inter_Inv_Set2[sd.symbol(cdf.inter_tx_set2[sqr], 12)];
        else TxType = Tx_Type_Inter_Inv_Set3[sd.symbol(cdf.inter_tx_set3[sqr], 2)];
      } else {
        int intraDir = use_filter_intra ? Filter_Intra_Mode_To_Intra_Dir[filter_intra_mode] : YMode;
        if (set == TX_SET_INTRA_1) TxType = Tx_Type_Intra_Inv_Set1[sd.symbol(cdf.intra_tx_set1[sqr][intraDir], 7)];
        else TxType = Tx_Type_Intra_Inv_Set2[sd.symbol(cdf.intra_tx_set2[sqr][intraDir], 5)];
      }
    }
    for (int i = 0; i < (tx_w(txSz) >> 2); i++)
      for (int j = 0; j < (tx_h(txSz) >> 2); j++) TxTypes[mi(y4 + j, x4 + i)] = TxType;
  }

  int compute_tx_type(int plane, int txSz, int blockX, int blockY) {
    if (Lossless || tx_sqr_up(txSz) > TX_32X32) return DCT_DCT;
    int set = get_tx_set(txSz);
    if (plane == 0) return TxTypes[mi(blockY, blockX)];
    int t;
    if (is_inter) {
      int x4 = imax(MiCol, blockX << P.subsampling_x), y4 = imax(MiRow, blockY << P.subsampling_y);
      t = TxTypes[mi(y4, x4)];
    } else {
      t = Mode_To_Txfm[UVMode];
    }
    return tx_type_in_set(set, t) ? t : DCT_DCT;
  }

  static int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
  }

  // scans: position = row * width + column
  std::vector<int16_t> scans[19][3];  // default, mrow, mcol
  void build_scans() {
    for (int t = 0; t < 19; t++) {
      int w = imin(32, tx_w(t)), h = imin(32, tx_h(t));
      std::vector<int16_t> def, row, colv;
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) row.push_back(r * w + c);
      for (int c = 0; c < w; c++)
        for (int r = 0; r < h; r++) colv.push_back(r * w + c);
      for (int d = 0; d < w + h - 1; d++) {
        std::vector<int16_t> diag;
        // along a diagonal, row increasing
        for (int r = 0; r < h; r++) {
          int c = d - r;
          if (c >= 0 && c < w) diag.push_back(r * w + c);
        }
        bool reverse;
        if (w == h) reverse = (d % 2) == 0;  // zig-zag, starting to the right
        else reverse = w > h;                 // wide: up-right; tall: down-left
        if (reverse) std::reverse(diag.begin(), diag.end());
        def.insert(def.end(), diag.begin(), diag.end());
      }
      scans[t][0] = def;
      scans[t][1] = row;
      scans[t][2] = colv;
    }
  }
  const int16_t* get_scan(int txSz) {
    if (txSz == TX_16X64) return scans[TX_16X32][0].data();
    if (txSz == TX_64X16) return scans[TX_32X16][0].data();
    if (tx_sqr_up(txSz) == TX_64X64) return scans[TX_32X32][0].data();
    if (PlaneTxType == IDTX) return scans[txSz][0].data();
    bool preferRow = PlaneTxType == V_DCT || PlaneTxType == V_ADST || PlaneTxType == V_FLIPADST;
    bool preferCol = PlaneTxType == H_DCT || PlaneTxType == H_ADST || PlaneTxType == H_FLIPADST;
    if (preferRow) return scans[txSz][1].data();
    if (preferCol) return scans[txSz][2].data();
    return scans[txSz][0].data();
  }

  int get_coeff_base_ctx(int txSz, int pos, int c, bool isEob) {
    int adj = adjusted_tx_size(txSz);
    int bwl = Tx_Width_Log2[adj];
    int txw = tx_w(adj), txh = tx_h(adj);
    if (isEob) {
      if (c == 0) return 0;
      if (c <= (txh * txw) / 8) return 1;
      if (c <= (txh * txw) / 4) return 2;
      return 3;
    }
    int cls = tx_class(PlaneTxType);
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int idx = 0; idx < 5; idx++) {
      int rr = row + Sig_Ref_Diff_Offset[cls][idx][0], cc = col + Sig_Ref_Diff_Offset[cls][idx][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl)) mag += imin(abs(Quant[(rr << bwl) + cc]), 3);
    }
    int ctx = imin((mag + 1) >> 1, 4);
    if (cls == TX_CLASS_2D) {
      if (row == 0 && col == 0) return 0;
      int shape = tx_w(txSz) == tx_h(txSz) ? 0 : tx_w(txSz) > tx_h(txSz) ? 1 : 2;
      return ctx + Coeff_Base_Ctx_Offset[shape][imin(row, 4)][imin(col, 4)];
    }
    int idx = cls == TX_CLASS_VERT ? row : col;
    return ctx + Coeff_Base_Pos_Ctx_Offset[imin(idx, 2)];
  }

  int coeff_br_ctx(int txSz, int pos) {
    int adj = adjusted_tx_size(txSz);
    int bwl = Tx_Width_Log2[adj], txw = tx_w(adj), txh = tx_h(adj);
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    int cls = tx_class(PlaneTxType);
    for (int idx = 0; idx < 3; idx++) {
      int rr = row + Mag_Ref_Offset_With_Tx_Class[cls][idx][0];
      int cc = col + Mag_Ref_Offset_With_Tx_Class[cls][idx][1];
      if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl)) mag += imin(Quant[rr * txw + cc], 15);
    }
    mag = imin((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == TX_CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
    if (cls == TX_CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
    return row == 0 ? mag + 7 : mag + 14;
  }

  int coeffs(int plane, int startX, int startY, int txSz) {
    int x4 = startX >> 2, y4 = startY >> 2, w4 = tx_w(txSz) >> 2, h4 = tx_h(txSz) >> 2;
    int txSzCtx = (tx_sqr(txSz) + tx_sqr_up(txSz) + 1) >> 1;
    int ptype = plane > 0;
    int segEob = (txSz == TX_16X64 || txSz == TX_64X16) ? 512 : imin(1024, tx_w(txSz) * tx_h(txSz));
    for (int c = 0; c < segEob; c++) Quant[c] = 0;
    int eob = 0, culLevel = 0, dcCategory = 0;
    int maxX4 = MiCols >> ssx(plane), maxY4 = MiRows >> ssy(plane);
    // all_zero context
    int ctx;
    int w = tx_w(txSz), h = tx_h(txSz);
    int bsize = plane_size(plane);
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < maxX4) top = imax(top, AboveLevelContext[plane][x4 + k]);
      for (int k = 0; k < h4; k++)
        if (y4 + k < maxY4) left = imax(left, LeftLevelContext[plane][y4 + k]);
      top = imin(top, 255);
      left = imin(left, 255);
      if (block_width(bsize) == w && block_height(bsize) == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (imax(top, left) > 3);
      else if (imax(top, left) <= 3) ctx = 4;
      else if (imin(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < maxX4) above |= AboveLevelContext[plane][x4 + i] | AboveDcContext[plane][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < maxY4) left |= LeftLevelContext[plane][y4 + i] | LeftDcContext[plane][y4 + i];
      ctx = (above != 0) + (left != 0) + 7;
      if (block_width(bsize) * block_height(bsize) > w * h) ctx += 3;
    }
    int all_zero = sd.symbol(cdf.txb_skip[txSzCtx][ctx], 2);
    if (all_zero) {
      if (plane == 0)
        for (int i = 0; i < w4; i++)
          for (int j = 0; j < h4; j++) TxTypes[mi(y4 + j, x4 + i)] = DCT_DCT;
    } else {
      if (plane == 0) transform_type(x4, y4, txSz);
      PlaneTxType = compute_tx_type(plane, txSz, x4, y4);
      const int16_t* scan = get_scan(txSz);
      int eobMultisize = imin(Tx_Width_Log2[txSz], 5) + imin(Tx_Height_Log2[txSz], 5) - 4;
      int c2 = tx_class(PlaneTxType) == TX_CLASS_2D ? 0 : 1;
      int eobPt;
      switch (eobMultisize) {
        case 0: eobPt = sd.symbol(cdf.eob_pt16[ptype][c2], 5) + 1; break;
        case 1: eobPt = sd.symbol(cdf.eob_pt32[ptype][c2], 6) + 1; break;
        case 2: eobPt = sd.symbol(cdf.eob_pt64[ptype][c2], 7) + 1; break;
        case 3: eobPt = sd.symbol(cdf.eob_pt128[ptype][c2], 8) + 1; break;
        case 4: eobPt = sd.symbol(cdf.eob_pt256[ptype][c2], 9) + 1; break;
        case 5: eobPt = sd.symbol(cdf.eob_pt512[ptype], 10) + 1; break;
        default: eobPt = sd.symbol(cdf.eob_pt1024[ptype], 11) + 1; break;
      }
      eob = (eobPt < 2) ? eobPt : ((1 << (eobPt - 2)) + 1);
      int eobShift = eobPt - 3;
      if (eobShift >= 0) {
        if (sd.symbol(cdf.eob_extra[txSzCtx][ptype][eobPt - 3], 2)) eob += 1 << eobShift;
        for (int i = 1; i < imax(0, eobPt - 2); i++) {
          eobShift = imax(0, eobPt - 2) - 1 - i;
          if (sd.literal(1)) eob += 1 << eobShift;
        }
      }
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        if (c == eob - 1) {
          level = sd.symbol(cdf.coeff_base_eob[txSzCtx][ptype][get_coeff_base_ctx(txSz, pos, c, true)], 3) + 1;
        } else {
          level = sd.symbol(cdf.coeff_base[txSzCtx][ptype][get_coeff_base_ctx(txSz, pos, c, false)], 4);
        }
        if (level > 2) {
          int bctx = coeff_br_ctx(txSz, pos);
          for (int idx = 0; idx < 4; idx++) {
            int br = sd.symbol(cdf.coeff_br[imin(txSzCtx, TX_32X32)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        Quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (Quant[pos] != 0) {
          if (c == 0) {
            int dcSign = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < maxX4) {
                int s = AboveDcContext[plane][x4 + k];
                if (s == 1) dcSign--; else if (s == 2) dcSign++;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < maxY4) {
                int s = LeftDcContext[plane][y4 + k];
                if (s == 1) dcSign--; else if (s == 2) dcSign++;
              }
            int dctx = dcSign < 0 ? 1 : dcSign > 0 ? 2 : 0;
            sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = sd.literal(1);
          }
        }
        if (Quant[pos] > 14) {
          int length = 0, bit;
          do {
            length++;
            bit = sd.literal(1);
            if (length > 32) { fail("coefficient golomb code too long"); return 0; }
          } while (!bit);
          int x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | sd.literal(1);
          Quant[pos] = x + 14;
        }
        if (pos == 0 && Quant[pos] > 0) dcCategory = sign ? 1 : 2;
        Quant[pos] = Quant[pos] & 0xFFFFF;
        culLevel += Quant[pos];
        if (sign) Quant[pos] = -Quant[pos];
      }
      culLevel = imin(63, culLevel);
    }
    for (int i = 0; i < w4; i++) {
      AboveLevelContext[plane][x4 + i] = culLevel;
      AboveDcContext[plane][x4 + i] = dcCategory;
    }
    for (int i = 0; i < h4; i++) {
      LeftLevelContext[plane][y4 + i] = culLevel;
      LeftDcContext[plane][y4 + i] = dcCategory;
    }
    return eob;
  }

  // get_qidx(ignoreDeltaQ, segment_id) (7.12.2): the block's qindex with
  // delta q, else the frame's, and its segment's SEG_LVL_ALT_Q on top
  int get_qidx(int ignoreDeltaQ) const {
    int q = !ignoreDeltaQ && P.delta_q_present ? CurrentQIndex : P.base_q_idx;
    if (seg_feature_active(SEG_LVL_ALT_Q)) return clip3(0, 255, q + P.FeatureData[segment_id][SEG_LVL_ALT_Q]);
    return q;
  }
  int dc_q(int plane) {
    int d = plane == 0 ? P.DeltaQYDc : plane == 1 ? P.DeltaQUDc : P.DeltaQVDc;
    return Dc_Qlookup[(BitDepth - 8) >> 1][clip3(0, 255, get_qidx(0) + d)];
  }
  int ac_q(int plane) {
    int d = plane == 0 ? 0 : plane == 1 ? P.DeltaQUAc : P.DeltaQVAc;
    return Ac_Qlookup[(BitDepth - 8) >> 1][clip3(0, 255, get_qidx(0) + d)];
  }

  void reconstruct(int plane, int x, int y, int txSz) {
    int pels = tx_w(txSz) * tx_h(txSz);
    int dqShift = (pels > 256) + (pels > 1024);  // dqDenom 2 above 256 samples, 4 above 1024
    int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
    int w = 1 << log2W, h = 1 << log2H;
    int tw = imin(32, w), th = imin(32, h);
    int flipUD = PlaneTxType == FLIPADST_DCT || PlaneTxType == FLIPADST_ADST || PlaneTxType == V_FLIPADST ||
                 PlaneTxType == FLIPADST_FLIPADST;
    int flipLR = PlaneTxType == DCT_FLIPADST || PlaneTxType == ADST_FLIPADST || PlaneTxType == H_FLIPADST ||
                 PlaneTxType == FLIPADST_FLIPADST;
    int dcq = dc_q(plane), acq = ac_q(plane);
    // the quantizer matrix of the plane's level (15, flat, where the frame
    // is lossless or has none) scales a 2-D transform's steps; a 64-point
    // size takes its 32-point matrix
    int qmLevel = (Lossless || !P.using_qmatrix) ? 15 : plane == 0 ? P.qm_y : plane == 1 ? P.qm_u : P.qm_v;
    const uint8_t* qm = qmLevel < 15 && PlaneTxType < IDTX ? Quantizer_Matrix[qmLevel][plane > 0] + Qm_Offset[txSz]
                                                            : nullptr;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) Dequant[i][j] = 0;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        int32_t qv = Quant[i * tw + j];
        if (!qv) continue;
        int q = (i == 0 && j == 0) ? dcq : acq;
        if (qm) q = round2((int64_t)q * qm[j * th + i], 5);  // AOM_QM_BITS; the matrix runs column by column
        int64_t dq = ((int64_t)abs(qv) * q) & 0xFFFFFF;
        dq = dq >> dqShift;
        if (qv < 0) dq = -dq;
        Dequant[i][j] = clip3(-(1 << (7 + BitDepth)), (1 << (7 + BitDepth)) - 1, (int)dq);
      }
    inverse_transform_2d(txSz, log2W, log2H);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int xx = flipLR ? (w - j - 1) : j, yy = flipUD ? (h - i - 1) : i;
        pixel* px = F.at(plane, y + yy, x + xx);
        *px = clip1(*px + Residual[i][j]);
      }
  }

  void inverse_transform_2d(int txSz, int log2W, int log2H) {
    int w = 1 << log2W, h = 1 << log2H;
    int rowShift = Lossless ? 0 : Transform_Row_Shift[txSz];
    int colShift = Lossless ? 0 : 4;
    int rowR = BitDepth + 8, colR = imax(BitDepth + 6, 16);
    int vt, ht;
    tx_types_1d(PlaneTxType, &vt, &ht);
    int32_t T[64];
    for (int i = 0; i < h; i++) {
      if (i >= 32 && !Lossless) {
        for (int j = 0; j < w; j++) Residual[i][j] = 0;
        continue;
      }
      bool nz = false;
      for (int j = 0; j < w; j++) {
        T[j] = (i < 32 && j < 32) ? Dequant[i][j] : 0;
        nz |= T[j] != 0;
      }
      if (!nz && !Lossless) {
        for (int j = 0; j < w; j++) Residual[i][j] = 0;
        continue;
      }
      if (abs(log2W - log2H) == 1)
        for (int j = 0; j < w; j++) T[j] = round2((int64_t)T[j] * 2896, 12);
      if (Lossless) {
        iwht(T, 2);
      } else {
        for (int j = 0; j < w; j++) T[j] = clampr(T[j], rowR);
        inverse_1d(T, w, ht, rowR);
      }
      for (int j = 0; j < w; j++) Residual[i][j] = round2(T[j], rowShift);
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        if (!Lossless) Residual[i][j] = clampr(Residual[i][j], colR);
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) T[i] = Residual[i][j];
      if (Lossless) iwht(T, 0);
      else inverse_1d(T, h, vt, colR);
      for (int i = 0; i < h; i++) Residual[i][j] = round2(T[i], colShift);
    }
  }

  // ------------------------------------------------------ loop filter
  void loop_filter() {
    if (P.lf_level[0] == 0 && P.lf_level[1] == 0) return;
    for (int plane = 0; plane < P.NumPlanes; plane++) {
      if (plane > 0 && !P.lf_level[1 + plane]) continue;
      for (int pass = 0; pass < 2; pass++) {
        int rowStep = 1 << ssy(plane), colStep = 1 << ssx(plane);
        for (int row = 0; row < MiRows; row += rowStep)
          for (int col = 0; col < MiCols; col += colStep) edge_loop_filter(plane, pass, row, col);
      }
    }
  }
  // 7.14.4: the level of the block at (row, col) for a plane and direction,
  // from the frame's level, the block's delta lf (one, or one per edge
  // direction and plane with delta_lf_multi), its segment's
  // SEG_LVL_ALT_LF_Y_V + i, and the deltas of its reference frame and of
  // its inter mode
  int filter_level(int row, int col, int plane, int pass) {
    int i = plane == 0 ? pass : plane + 1;
    int deltaLF = DeltaLFs[mi(row, col) * 4 + (P.delta_lf_multi ? i : 0)];
    int lvlSeg = clip3(0, 63, deltaLF + P.lf_level[i]);
    int segment = SegmentIds[mi(row, col)], feature = SEG_LVL_ALT_LF_Y_V + i;
    if (P.segmentation_enabled && P.FeatureEnabled[segment][feature])
      lvlSeg = clip3(0, 63, lvlSeg + P.FeatureData[segment][feature]);
    if (P.lf_delta_enabled) {
      int nShift = lvlSeg >> 5;
      int ref = RefFrame0[mi(row, col)];
      lvlSeg += P.lf_ref_deltas[ref] * (1 << nShift);
      if (ref > INTRA_FRAME) {  // modeType 1 but for GLOBALMV
        int mode = YModes[mi(row, col)];
        lvlSeg += P.lf_mode_deltas[mode >= NEARESTMV && mode != GLOBALMV && mode != GLOBAL_GLOBALMV] * (1 << nShift);
      }
      lvlSeg = clip3(0, 63, lvlSeg);
    }
    return lvlSeg;
  }
  void filter_strength(int lvlSeg, int* limit, int* blimit, int* thresh) {
    int shift = P.lf_sharpness > 4 ? 2 : P.lf_sharpness > 0 ? 1 : 0;
    *limit = P.lf_sharpness > 0 ? clip3(1, 9 - P.lf_sharpness, lvlSeg >> shift) : imax(1, lvlSeg >> shift);
    *blimit = 2 * (lvlSeg + 2) + *limit;
    *thresh = lvlSeg >> 4;
  }
  void edge_loop_filter(int plane, int pass, int row, int col) {
    int sx = ssx(plane), sy = ssy(plane);
    int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
    int x = col * 4, y = row * 4;
    row |= sy;
    col |= sx;
    int onScreen;
    if (x >= P.FrameWidth) onScreen = 0;
    else if (y >= P.FrameHeight) onScreen = 0;
    else if (pass == 0 && x == 0) onScreen = 0;
    else if (pass == 1 && y == 0) onScreen = 0;
    else onScreen = 1;
    if (!onScreen) return;
    int xP = x >> sx, yP = y >> sy;
    int prevRow = row - (dy << sy), prevCol = col - (dx << sx);
    int miSize = MiSizes[mi(row, col)];
    int txSz = LfTxSizes[plane][(size_t)(row >> sy) * lfStride[plane] + (col >> sx)];
    int planeSize = subsampled_size(miSize, sx, sy);
    int sk = Skips[mi(row, col)];
    int isIntra = RefFrame0[mi(row, col)] <= 0;
    int prevTxSz = LfTxSizes[plane][(size_t)(prevRow >> sy) * lfStride[plane] + (prevCol >> sx)];
    int isBlockEdge = pass == 0 ? (xP % block_width(planeSize) == 0) : (yP % block_height(planeSize) == 0);
    int isTxEdge = pass == 0 ? (xP % tx_w(txSz) == 0) : (yP % tx_h(txSz) == 0);
    // a transform edge inside a block is filtered unless the block is a
    // skipped inter block (7.14.2; libaom and dav1d filter it in every
    // intra block, skipped or not)
    if (!isTxEdge || !(isBlockEdge || !sk || isIntra)) return;  // applyFilter
    int baseSize = pass == 0 ? imin(tx_w(prevTxSz), tx_w(txSz)) : imin(tx_h(prevTxSz), tx_h(txSz));
    int filterSize = plane == 0 ? imin(16, baseSize) : imin(8, baseSize);
    // a block of level 0 takes the previous block's (7.14.2), which differs
    // from it only with delta lf
    int lvl = filter_level(row, col, plane, pass);
    if (lvl == 0) lvl = filter_level(prevRow, prevCol, plane, pass);
    if (lvl == 0) return;
    int limit, blimit, thresh;
    filter_strength(lvl, &limit, &blimit, &thresh);
    for (int i = 0; i < 4; i++)
      sample_filter(xP + dy * i, yP + dx * i, plane, limit, blimit, thresh, dx, dy, filterSize);
  }
  void sample_filter(int x, int y, int plane, int limit, int blimit, int thresh, int dx, int dy, int filterSize) {
    auto S = [&](int k) -> pixel* { return F.at(plane, y + dy * k, x + dx * k); };
    int q0 = *S(0), q1 = *S(1), q2 = *S(2), q3 = *S(3), p0 = *S(-1), p1 = *S(-2), p2 = *S(-3), p3 = *S(-4);
    int shift = BitDepth - 8, one = 1 << shift;  // the flatness threshold
    limit <<= shift;
    blimit <<= shift;
    thresh <<= shift;
    int hevMask = (abs(p1 - p0) > thresh) | (abs(q1 - q0) > thresh);
    int filterLen = filterSize == 4 ? 4 : plane != 0 ? 6 : filterSize == 8 ? 8 : 16;
    int mask = 0;
    mask |= abs(p1 - p0) > limit;
    mask |= abs(q1 - q0) > limit;
    mask |= abs(p0 - q0) * 2 + abs(p1 - q1) / 2 > blimit;
    if (filterLen >= 6) { mask |= abs(p2 - p1) > limit; mask |= abs(q2 - q1) > limit; }
    if (filterLen >= 8) { mask |= abs(p3 - p2) > limit; mask |= abs(q3 - q2) > limit; }
    if (mask) return;
    int flatMask = 0, flatMask2 = 0;
    if (filterSize >= 8) {
      int f = 0;
      f |= abs(p1 - p0) > one; f |= abs(q1 - q0) > one; f |= abs(p2 - p0) > one; f |= abs(q2 - q0) > one;
      if (filterLen >= 8) { f |= abs(p3 - p0) > one; f |= abs(q3 - q0) > one; }
      flatMask = !f;
    }
    if (filterSize >= 16) {
      int q4 = *S(4), q5 = *S(5), q6 = *S(6), p4 = *S(-5), p5 = *S(-6), p6 = *S(-7);
      int f = 0;
      f |= abs(p6 - p0) > one; f |= abs(p5 - p0) > one; f |= abs(p4 - p0) > one;
      f |= abs(q4 - q0) > one; f |= abs(q5 - q0) > one; f |= abs(q6 - q0) > one;
      flatMask2 = !f;
    }
    if (filterSize == 4 || !flatMask) {
      narrow_filter(hevMask, S);
    } else if (filterSize == 8 || !flatMask2) {
      wide_filter(plane, S, 3);
    } else {
      wide_filter(plane, S, 4);
    }
  }
  template <class Fn>
  void narrow_filter(int hevMask, Fn S) {
    int half = 1 << (BitDepth - 1);
    auto c4 = [half](int v) { return clip3(-half, half - 1, v); };
    int q0 = *S(0), q1 = *S(1), p0 = *S(-1), p1 = *S(-2);
    int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
    int filter = hevMask ? c4(ps1 - qs1) : 0;
    filter = c4(filter + 3 * (qs0 - ps0));
    int filter1 = c4(filter + 4) >> 3, filter2 = c4(filter + 3) >> 3;
    *S(0) = c4(qs0 - filter1) + half;
    *S(-1) = c4(ps0 + filter2) + half;
    if (!hevMask) {
      filter = round2(filter1, 1);
      *S(1) = c4(qs1 - filter) + half;
      *S(-2) = c4(ps1 + filter) + half;
    }
  }
  template <class Fn>
  void wide_filter(int plane, Fn S, int log2Size) {
    int n = log2Size == 4 ? 6 : plane == 0 ? 3 : 2;
    int n2 = (log2Size == 3 && plane == 0) ? 0 : 1;
    int Fv[16], F2[16];
    for (int i = -(n + 1); i <= n; i++) Fv[i + 8] = *S(i);
    for (int i = -n; i < n; i++) {
      int t = 0;
      for (int j = -n; j <= n; j++) {
        int p = clip3(-(n + 1), n, i + j);
        int tap = abs(j) <= n2 ? 2 : 1;
        t += Fv[p + 8] * tap;
      }
      F2[i + 8] = round2(t, log2Size);
    }
    for (int i = -n; i < n; i++) *S(i) = F2[i + 8];
  }

  // -------------------------------------------------- loop restoration syntax
  static int count_units_in_frame(int unitSize, int frameSize) {
    return imax((frameSize + (unitSize >> 1)) / unitSize, 1);
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }
  int decode_subexp_bool(int numSyms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (numSyms <= mk + 3 * a) return sd.ns(numSyms - mk) + mk;
      if (!sd.literal(1)) return sd.literal(b2) + mk;
      i++;
      mk += a;
    }
  }
  int decode_signed_subexp_with_ref_bool(int low, int high, int k, int r) {
    int mx = high - low;
    r -= low;
    int v = decode_subexp_bool(mx, k);
    int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
  }

  void read_lr(int r, int c, int bSize) {
    if (P.allow_intrabc) return;
    int w = bw4(bSize), h = bh4(bSize);
    for (int plane = 0; plane < P.NumPlanes; plane++) {
      if (P.FrameRestorationType[plane] == RESTORE_NONE) continue;
      int sx = ssx(plane), sy = ssy(plane);
      int unitSize = P.LoopRestorationSize[plane];
      int unitRows = LrUnitRows[plane], unitCols = LrUnitCols[plane];
      int unitRowStart = (r * (4 >> sy) + unitSize - 1) / unitSize;
      int unitRowEnd = imin(unitRows, ((r + h) * (4 >> sy) + unitSize - 1) / unitSize);
      // columns map through the upscaling: units lie on the upscaled width
      int numerator = (4 >> sx) * P.SuperresDenom, denominator = unitSize * 8;
      int unitColStart = (c * numerator + denominator - 1) / denominator;
      int unitColEnd = imin(unitCols, ((c + w) * numerator + denominator - 1) / denominator);
      for (int unitRow = unitRowStart; unitRow < unitRowEnd; unitRow++)
        for (int unitCol = unitColStart; unitCol < unitColEnd; unitCol++) read_lr_unit(plane, unitRow, unitCol);
    }
  }

  void read_lr_unit(int plane, int unitRow, int unitCol) {
    int type;
    int frameType = P.FrameRestorationType[plane];
    if (frameType == RESTORE_WIENER) type = sd.symbol(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (frameType == RESTORE_SGRPROJ) type = sd.symbol(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else type = sd.symbol(cdf.restoration_type, 3);
    size_t u = (size_t)unitRow * LrUnitCols[plane] + unitCol;
    LrType[plane][u] = type;
    if (type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        int firstCoeff = 0;
        if (plane) {
          firstCoeff = 1;
          LrWiener[plane][u * 6 + pass * 3] = 0;
        }
        for (int j = firstCoeff; j < 3; j++) {
          int v = decode_signed_subexp_with_ref_bool(Wiener_Taps_Min[j], Wiener_Taps_Max[j] + 1, Wiener_Taps_K[j],
                                                     RefLrWiener[plane][pass][j]);
          LrWiener[plane][u * 6 + pass * 3 + j] = v;
          RefLrWiener[plane][pass][j] = v;
        }
      }
    } else if (type == RESTORE_SGRPROJ) {
      int set = sd.literal(4);
      LrSgrSet[plane][u] = set;
      for (int i = 0; i < 2; i++) {
        int radius = Sgr_Params[set][i * 2], mn = Sgrproj_Xqd_Min[i], mx = Sgrproj_Xqd_Max[i];
        int v = 0;
        if (radius) v = decode_signed_subexp_with_ref_bool(mn, mx + 1, 4, RefSgrXqd[plane][i]);
        else if (i == 1) v = clip3(mn, mx, (1 << 7) - RefSgrXqd[plane][0]);
        LrSgrXqd[plane][u * 2 + i] = v;
        RefSgrXqd[plane][i] = v;
      }
    }
  }

  // ----------------------------------------------------------------- CDEF
  // 7.15: each 8x8 luma block (and its chroma) of a 64x64 with a cdef_idx,
  // not all skipped, filtered along its direction; reads the deblocked
  // frame, writes F
  Frame<pixel> deblocked;
  int CdefAvailable;

  void cdef() {
    bool any = false;  // zero strengths leave every sample as it is
    for (int i = 0; i < (1 << P.cdef_bits); i++)
      any |= P.cdef_y_pri[i] || P.cdef_y_sec[i] || P.cdef_uv_pri[i] || P.cdef_uv_sec[i];
    if (!P.enable_cdef || !any) return;
    for (int r = 0; r < MiRows; r += 2)
      for (int c = 0; c < MiCols; c += 2) {
        int idx = CdefIdx[mi(r & ~15, c & ~15)];
        if (idx == -1) continue;
        cdef_block(r, c, idx);
      }
  }

  void cdef_block(int r, int c, int idx) {
    int skipAll = Skips[mi(r, c)] && Skips[mi(r + 1, c)] && Skips[mi(r, c + 1)] && Skips[mi(r + 1, c + 1)];
    if (skipAll) return;
    int var;
    int yDir = cdef_direction(r, c, &var);
    int coeffShift = BitDepth - 8;
    int priStr = P.cdef_y_pri[idx] << coeffShift, secStr = P.cdef_y_sec[idx] << coeffShift;
    int dir = priStr == 0 ? 0 : yDir;
    int varStr = (var >> 6) ? imin(floor_log2(var >> 6), 12) : 0;
    priStr = var ? (priStr * (4 + varStr) + 8) >> 4 : 0;
    cdef_filter(0, r, c, priStr, secStr, P.CdefDamping + coeffShift, dir);
    if (P.NumPlanes == 1) return;
    priStr = P.cdef_uv_pri[idx] << coeffShift;
    secStr = P.cdef_uv_sec[idx] << coeffShift;
    dir = priStr == 0 ? 0 : Cdef_Uv_Dir[P.subsampling_x][P.subsampling_y][yDir];
    cdef_filter(1, r, c, priStr, secStr, P.CdefDamping + coeffShift - 1, dir);
    cdef_filter(2, r, c, priStr, secStr, P.CdefDamping + coeffShift - 1, dir);
  }

  int cdef_direction(int r, int c, int* var) {
    int cost[8] = {0}, partial[8][15] = {{0}};
    int x0 = c << 2, y0 = r << 2;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int x = (*deblocked.at(0, y0 + i, x0 + j) >> (BitDepth - 8)) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    for (int i = 0; i < 8; i++) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= Div_Table[8];
    cost[6] *= Div_Table[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * Div_Table[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * Div_Table[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * Div_Table[8];
    cost[4] += partial[4][7] * partial[4][7] * Div_Table[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= Div_Table[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * Div_Table[2 * j + 2];
    }
    int bestCost = 0, yDir = 0;
    for (int i = 0; i < 8; i++)
      if (cost[i] > bestCost) { bestCost = cost[i]; yDir = i; }
    *var = (bestCost - cost[(yDir + 4) & 7]) >> 10;
    return yDir;
  }

  static int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int dampingAdj = imax(0, damping - floor_log2(threshold));
    int val = imin(abs(diff), imax(0, threshold - (abs(diff) >> dampingAdj)));
    return diff < 0 ? -val : val;
  }

  int cdef_get_at(int plane, int x0, int y0, int i, int j, int subX, int subY) {
    int y = y0 + i, x = x0 + j;
    int candR = (y << subY) >> 2, candC = (x << subX) >> 2;
    if (candC >= 0 && candC < MiCols && candR >= 0 && candR < MiRows) {  // is_inside_filter_region
      CdefAvailable = 1;
      return *deblocked.at(plane, y, x);
    }
    CdefAvailable = 0;
    return 0;
  }

  void cdef_filter(int plane, int r, int c, int priStr, int secStr, int damping, int dir) {
    int subX = ssx(plane), subY = ssy(plane);
    int x0 = (c * 4) >> subX, y0 = (r * 4) >> subY;
    int w = 8 >> subX, h = 8 >> subY;
    int tapSet = (priStr >> (BitDepth - 8)) & 1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int x = *deblocked.at(plane, y0 + i, x0 + j);
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; k++)
          for (int sign = -1; sign <= 1; sign += 2) {
            int p = cdef_get_at(plane, x0, y0, i + sign * Cdef_Directions[dir][k][0],
                                j + sign * Cdef_Directions[dir][k][1], subX, subY);
            if (CdefAvailable) {
              sum += Cdef_Pri_Taps[tapSet][k] * constrain(p - x, priStr, damping);
              mx = imax(p, mx);
              mn = imin(p, mn);
            }
            for (int dirOff = -2; dirOff <= 2; dirOff += 4) {
              int d2 = (dir + dirOff) & 7;
              int s = cdef_get_at(plane, x0, y0, i + sign * Cdef_Directions[d2][k][0],
                                  j + sign * Cdef_Directions[d2][k][1], subX, subY);
              if (CdefAvailable) {
                sum += Cdef_Sec_Taps[tapSet][k] * constrain(s - x, secStr, damping);
                mx = imax(s, mx);
                mn = imin(s, mn);
              }
            }
          }
        *F.at(plane, y0 + i, x0 + j) = clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
      }
  }

  // -------------------------------------------------------------- superres
  // 7.16: each row of each plane upscaled from the downscaled width to the
  // upscaled one by 8-tap filters at 1/64 phases, stepping in 1/16384
  // units; the source is read up to the padded width (MiCols * 4 luma
  // samples), clamped there and at 0
  Frame<pixel> upscaled(Frame<pixel>& src) {
    Frame<pixel> dst;
    int padW = ((P.UpscaledWidth + 7) & ~7) + 256;
    for (int p = 0; p < P.NumPlanes; p++) {
      int sx = ssx(p);
      int downW = round2(P.FrameWidth, sx), upW = round2(P.UpscaledWidth, sx);
      int stepX = ((downW << 14) + (upW / 2)) / upW;
      int err = upW * stepX - (downW << 14);
      int x0 = (-((upW - downW) << 13) + upW / 2) / upW + (1 << 7) - err / 2;
      x0 &= (1 << 14) - 1;
      int maxX = ((MiCols >> sx) << 2) - 1;
      dst.stride[p] = padW >> sx;
      dst.ph[p] = src.ph[p];
      dst.p[p].assign((size_t)dst.stride[p] * dst.ph[p], 0);
      for (int y = 0; y < src.ph[p]; y++) {
        pixel* row = src.at(p, y, 0);
        for (int x = 0; x < upW; x++) {
          int xPos = x0 + x * stepX;
          const int16_t* f = Upscale_Filter[(xPos & ((1 << 14) - 1)) >> 8];
          int sum = 0;
          for (int k = 0; k < 8; k++) sum += f[k] * row[clip3(0, maxX, (xPos >> 14) + k - 4)];
          *dst.at(p, y, x) = clip1(round2(sum, 7));
        }
      }
    }
    return dst;
  }

  // ------------------------------------------------------ loop restoration
  // 7.17: each 4x4 (luma) unit of the frame through its restoration unit's
  // Wiener or self-guided filter; the input is the CDEF output (F), but rows
  // outside the 64-row stripe (offset 8 up) come from the deblocked frame
  // before CDEF (`deblocked`); writes `lr`
  Frame<pixel> lr;
  int StripeStartY, StripeEndY, PlaneEndX, PlaneEndY;

  void loop_restoration() {
    bool any = false;
    for (int p = 0; p < P.NumPlanes; p++) any |= P.FrameRestorationType[p] != RESTORE_NONE;
    if (!any) return;
    lr = F;
    for (int y = 0; y < P.FrameHeight; y += 4)
      for (int x = 0; x < P.UpscaledWidth; x += 4)
        for (int plane = 0; plane < P.NumPlanes; plane++)
          if (P.FrameRestorationType[plane] != RESTORE_NONE) loop_restore_block(plane, y >> 2, x >> 2);
    std::swap(F, lr);
  }

  void loop_restore_block(int plane, int row, int col) {
    int lumaY = row * 4;
    int stripeNum = (lumaY + 8) / 64;
    int subX = ssx(plane), subY = ssy(plane);
    StripeStartY = (-8 + stripeNum * 64) >> subY;
    StripeEndY = StripeStartY + (64 >> subY) - 1;
    int unitSize = P.LoopRestorationSize[plane];
    int unitRow = imin(LrUnitRows[plane] - 1, ((row * 4 + 8) >> subY) / unitSize);
    int unitCol = imin(LrUnitCols[plane] - 1, ((col * 4) >> subX) / unitSize);
    PlaneEndX = round2(P.UpscaledWidth, subX) - 1;
    PlaneEndY = round2(P.FrameHeight, subY) - 1;
    int x = (col * 4) >> subX, y = (row * 4) >> subY;
    int w = imin(4 >> subX, PlaneEndX - x + 1), h = imin(4 >> subY, PlaneEndY - y + 1);
    size_t u = (size_t)unitRow * LrUnitCols[plane] + unitCol;
    int type = LrType[plane][u];
    if (type == RESTORE_WIENER) wiener_filter(plane, u, x, y, w, h);
    else if (type == RESTORE_SGRPROJ) self_guided_filter(plane, u, x, y, w, h);
  }

  int get_source_sample(int plane, int x, int y) {
    x = imax(0, imin(PlaneEndX, x));
    y = imax(0, imin(PlaneEndY, y));
    if (y < StripeStartY) return *deblocked.at(plane, imax(StripeStartY - 2, y), x);
    if (y > StripeEndY) return *deblocked.at(plane, imin(StripeEndY + 2, y), x);
    return *F.at(plane, y, x);
  }

  void wiener_filter(int plane, size_t u, int x, int y, int w, int h) {
    int round0 = BitDepth == 12 ? 5 : 3, round1 = BitDepth == 12 ? 9 : 11;  // InterRound0 / 1, not compound
    int vfilter[7], hfilter[7];
    for (int pass = 0; pass < 2; pass++) {
      int* f = pass == 0 ? vfilter : hfilter;
      f[3] = 128;
      for (int i = 0; i < 3; i++) {
        int c = LrWiener[plane][u * 6 + pass * 3 + i];
        f[i] = f[6 - i] = c;
        f[3] -= 2 * c;
      }
    }
    int offset = 1 << (BitDepth + 7 - round0 - 1), limit = (1 << (BitDepth + 1 + 7 - round0)) - 1;
    int inter[10][4];
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += hfilter[t] * get_source_sample(plane, x + c + t - 3, y + r - 3);
        inter[r][c] = clip3(-offset, limit - offset, round2(s, round0));
      }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += vfilter[t] * inter[r + t][c];
        *lr.at(plane, y + r, x + c) = clip1(round2(s, round1));
      }
  }

  void box_filter(int plane, int x, int y, int w, int h, int set, int pass, int flt[4][4]) {
    int r = Sgr_Params[set][pass * 2], s = Sgr_Params[set][pass * 2 + 1];  // the scale, from eps
    int n = (2 * r + 1) * (2 * r + 1);
    int oneOverN = ((1 << 12) + (n / 2)) / n;
    int A[6][6], B[6][6];
    for (int i = -1; i < h + 1; i++)
      for (int j = -1; j < w + 1; j++) {
        int64_t a = 0;
        int b = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            int c = get_source_sample(plane, x + j + dx, y + i + dy);
            a += c * c;
            b += c;
          }
        a = round2(a, 2 * (BitDepth - 8));
        int64_t d = round2(b, BitDepth - 8);
        int64_t p = std::max<int64_t>(0, a * n - d * d);
        int z = round2(p * s, 20);
        int a2 = z >= 255 ? 256 : z == 0 ? 1 : ((z << 8) + (z / 2)) / (z + 1);
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * oneOverN;
        A[i + 1][j + 1] = a2;
        B[i + 1][j + 1] = round2(b2, 12);
      }
    for (int i = 0; i < h; i++) {
      int shift = (pass == 0 && (i & 1)) ? 4 : 5;
      for (int j = 0; j < w; j++) {
        int a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int weight;
            if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else weight = (dx == 0 || dy == 0) ? 4 : 3;
            a += weight * A[i + dy + 1][j + dx + 1];
            b += weight * B[i + dy + 1][j + dx + 1];
          }
        int v = a * *F.at(plane, y + i, x + j) + b;
        flt[i][j] = round2(v, 8 + shift - 4);
      }
    }
  }

  void self_guided_filter(int plane, size_t u, int x, int y, int w, int h) {
    int set = LrSgrSet[plane][u];
    int flt0[4][4], flt1[4][4];
    int r0 = Sgr_Params[set][0], r1 = Sgr_Params[set][2];
    if (r0) box_filter(plane, x, y, w, h, set, 0, flt0);
    if (r1) box_filter(plane, x, y, w, h, set, 1, flt1);
    int w0 = LrSgrXqd[plane][u * 2], w1 = LrSgrXqd[plane][u * 2 + 1];
    int w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int uu = *F.at(plane, y + i, x + j) << 4;
        int v = w1 * uu;
        v += w0 * (r0 ? flt0[i][j] : uu);
        v += w2 * (r1 ? flt1[i][j] : uu);
        *lr.at(plane, y + i, x + j) = clip1(round2(v, 4 + 7));
      }
  }

  // ---------------------------------------------------- film grain (7.18.3)
  // Synthesised noise added to the output planes after loop restoration:
  // grain templates of Gaussian_Sequence through an auto-regressive
  // filter, cut at random offsets into 32 x 32 luma blocks in 32-row
  // stripes, blended where blocks and stripes overlap, scaled by a
  // piecewise-linear function of the sample (chroma: of the luma beside it
  // or a mix of both) and clipped.
  int RandomRegister;
  int LumaGrain[73][82], CbGrain[73][82], CrGrain[73][82];
  int ScalingLut[3][256];

  int get_random_number(int bits) {
    int r = RandomRegister;
    int bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    r = (r >> 1) | (bit << 15);
    RandomRegister = r;
    return (r >> (16 - bits)) & ((1 << bits) - 1);
  }
  int scale_lut(int plane, int index) const {
    int shift = BitDepth - 8, x = index >> shift, rem = index - (x << shift);
    if (BitDepth == 8 || x == 255) return ScalingLut[plane][x];
    int start = ScalingLut[plane][x], end = ScalingLut[plane][x + 1];
    return start + round2((int64_t)(end - start) * rem, shift);
  }

  void generate_grain(int grainMin, int grainMax) {
    int shift = 12 - BitDepth + P.grain_scale_shift, lag = P.ar_coeff_lag, arShift = P.ar_coeff_shift_minus_6 + 6;
    int subX = P.subsampling_x, subY = P.subsampling_y;
    RandomRegister = P.grain_seed;
    for (int y = 0; y < 73; y++)
      for (int x = 0; x < 82; x++)
        LumaGrain[y][x] = P.num_y_points ? round2(Gaussian_Sequence[get_random_number(11)], shift) : 0;
    for (int y = 3; y < 73; y++)
      for (int x = 3; x < 82 - 3; x++) {
        int sum = 0, pos = 0;
        for (int dr = -lag; dr <= 0; dr++)
          for (int dc = -lag; dc <= lag; dc++) {
            if (dr == 0 && dc == 0) break;
            sum += LumaGrain[y + dr][x + dc] * (P.ar_coeffs_y_plus_128[pos++] - 128);
          }
        LumaGrain[y][x] = clip3(grainMin, grainMax, LumaGrain[y][x] + round2(sum, arShift));
      }
    if (P.NumPlanes == 1) return;
    int chromaW = subX ? 44 : 82, chromaH = subY ? 38 : 73;
    bool cb = P.num_cb_points || P.chroma_scaling_from_luma, cr = P.num_cr_points || P.chroma_scaling_from_luma;
    RandomRegister = P.grain_seed ^ 0xb524;
    for (int y = 0; y < chromaH; y++)
      for (int x = 0; x < chromaW; x++) CbGrain[y][x] = cb ? round2(Gaussian_Sequence[get_random_number(11)], shift) : 0;
    RandomRegister = P.grain_seed ^ 0x49d8;
    for (int y = 0; y < chromaH; y++)
      for (int x = 0; x < chromaW; x++) CrGrain[y][x] = cr ? round2(Gaussian_Sequence[get_random_number(11)], shift) : 0;
    for (int y = 3; y < chromaH; y++)
      for (int x = 3; x < chromaW - 3; x++) {
        int sum0 = 0, sum1 = 0, pos = 0;
        for (int dr = -lag; dr <= 0; dr++)
          for (int dc = -lag; dc <= lag; dc++) {
            int c0 = P.ar_coeffs_cb_plus_128[pos] - 128, c1 = P.ar_coeffs_cr_plus_128[pos] - 128;
            if (dr == 0 && dc == 0) {
              if (P.num_y_points) {  // the luma grain under this sample, averaged
                int luma = 0, lumaX = ((x - 3) << subX) + 3, lumaY = ((y - 3) << subY) + 3;
                for (int i = 0; i <= subY; i++)
                  for (int j = 0; j <= subX; j++) luma += LumaGrain[lumaY + i][lumaX + j];
                luma = round2(luma, subX + subY);
                sum0 += luma * c0;
                sum1 += luma * c1;
              }
              break;
            }
            sum0 += c0 * CbGrain[y + dr][x + dc];
            sum1 += c1 * CrGrain[y + dr][x + dc];
            pos++;
          }
        if (cb) CbGrain[y][x] = clip3(grainMin, grainMax, CbGrain[y][x] + round2(sum0, arShift));
        if (cr) CrGrain[y][x] = clip3(grainMin, grainMax, CrGrain[y][x] + round2(sum1, arShift));
      }
  }

  void scaling_lookup_init() {
    for (int plane = 0; plane < P.NumPlanes; plane++) {
      const int *value, *scaling;
      int n;
      if (plane == 0 || P.chroma_scaling_from_luma) { n = P.num_y_points; value = P.point_y_value; scaling = P.point_y_scaling; }
      else if (plane == 1) { n = P.num_cb_points; value = P.point_cb_value; scaling = P.point_cb_scaling; }
      else { n = P.num_cr_points; value = P.point_cr_value; scaling = P.point_cr_scaling; }
      int* lut = ScalingLut[plane];
      if (n == 0) {
        for (int i = 0; i < 256; i++) lut[i] = 0;
        continue;
      }
      for (int i = 0; i < value[0]; i++) lut[i] = scaling[0];
      for (int i = 0; i < n - 1; i++) {
        int deltaY = scaling[i + 1] - scaling[i], deltaX = value[i + 1] - value[i];
        int delta = deltaY * ((65536 + (deltaX >> 1)) / deltaX);
        for (int x = 0; x < deltaX; x++) lut[value[i] + x] = scaling[i] + ((x * delta + 32768) >> 16);
      }
      for (int i = value[n - 1]; i < 256; i++) lut[i] = scaling[n - 1];
    }
  }

  void film_grain() {
    if (!P.apply_grain) return;
    int w = P.UpscaledWidth, h = P.FrameHeight, subX = P.subsampling_x, subY = P.subsampling_y;
    int grainCenter = 128 << (BitDepth - 8), grainMin = -grainCenter;
    int grainMax = (256 << (BitDepth - 8)) - 1 - grainCenter;
    generate_grain(grainMin, grainMax);
    scaling_lookup_init();
    // add_noise (7.18.3.5): each 32-row stripe's noise, 34 rows and a
    // 34-column block every 32 columns, each block at its own offset
    int stripes = (((h + 1) / 2) + 15) / 16, stripeW = w + 68;
    std::vector<int> noiseStripe((size_t)stripes * 3 * 34 * stripeW, 0);
    auto NS = [&](int n, int plane, int i, int x) -> int& {
      return noiseStripe[(((size_t)n * 3 + plane) * 34 + i) * stripeW + x];
    };
    int lumaNum = 0;
    for (int y = 0; y < (h + 1) / 2; y += 16, lumaNum++) {
      RandomRegister = P.grain_seed;
      RandomRegister ^= ((lumaNum * 37 + 178) & 255) << 8;
      RandomRegister ^= (lumaNum * 173 + 105) & 255;
      for (int x = 0; x < (w + 1) / 2; x += 16) {
        int rand = get_random_number(8), offsetX = rand >> 4, offsetY = rand & 15;
        for (int plane = 0; plane < P.NumPlanes; plane++) {
          int psx = ssx(plane), psy = ssy(plane);
          int planeOffsetX = psx ? 6 + offsetX : 9 + offsetX * 2, planeOffsetY = psy ? 6 + offsetY : 9 + offsetY * 2;
          int (*grain)[82] = plane == 0 ? LumaGrain : plane == 1 ? CbGrain : CrGrain;
          for (int i = 0; i < (34 >> psy); i++)
            for (int j = 0; j < (34 >> psx); j++) {
              int g = grain[planeOffsetY + i][planeOffsetX + j];
              if (psx == 0) {
                if (j < 2 && P.overlap_flag && x > 0) {
                  int old = NS(lumaNum, plane, i, x * 2 + j);
                  g = j == 0 ? old * 27 + g * 17 : old * 17 + g * 27;
                  g = clip3(grainMin, grainMax, round2(g, 5));
                }
                NS(lumaNum, plane, i, x * 2 + j) = g;
              } else {
                if (j == 0 && P.overlap_flag && x > 0) {
                  int old = NS(lumaNum, plane, i, x + j);
                  g = clip3(grainMin, grainMax, round2(old * 23 + g * 22, 5));
                }
                NS(lumaNum, plane, i, x + j) = g;
              }
            }
        }
      }
    }
    // the noise image: each stripe's rows, the first (two, or one
    // subsampled) blended with the stripe above
    std::vector<int> noise[3];
    for (int plane = 0; plane < P.NumPlanes; plane++) {
      int psx = ssx(plane), psy = ssy(plane), pw = (w + psx) >> psx, ph = (h + psy) >> psy;
      noise[plane].assign((size_t)pw * ph, 0);
      for (int y = 0; y < ph; y++) {
        int n = y >> (5 - psy), i = y - (n << (5 - psy));
        for (int x = 0; x < pw; x++) {
          int g = NS(n, plane, i, x);
          if (psy == 0) {
            if (i < 2 && n > 0 && P.overlap_flag) {
              int old = NS(n - 1, plane, i + 32, x);
              g = i == 0 ? old * 27 + g * 17 : old * 17 + g * 27;
              g = clip3(grainMin, grainMax, round2(g, 5));
            }
          } else if (i < 1 && n > 0 && P.overlap_flag) {
            int old = NS(n - 1, plane, i + 16, x);
            g = clip3(grainMin, grainMax, round2(old * 23 + g * 22, 5));
          }
          noise[plane][(size_t)y * pw + x] = g;
        }
      }
    }
    // blend: chroma first, from the luma before its noise
    int minValue = 0, maxLuma = PixelMax, maxChroma = PixelMax;
    if (P.clip_to_restricted_range) {
      minValue = 16 << (BitDepth - 8);
      maxLuma = 235 << (BitDepth - 8);
      maxChroma = P.matrix_coefficients == 0 ? maxLuma : 240 << (BitDepth - 8);  // MC_IDENTITY
    }
    int scalingShift = P.grain_scaling_minus_8 + 8;
    if (P.NumPlanes > 1) {
      int pw = (w + subX) >> subX, ph = (h + subY) >> subY;
      const int mult[2][3] = {{P.cb_mult, P.cb_luma_mult, P.cb_offset}, {P.cr_mult, P.cr_luma_mult, P.cr_offset}};
      for (int y = 0; y < ph; y++)
        for (int x = 0; x < pw; x++) {
          int lumaX = x << subX, lumaY = y << subY, lumaNextX = imin(lumaX + 1, w - 1);
          int averageLuma = subX ? round2(*F.at(0, lumaY, lumaX) + *F.at(0, lumaY, lumaNextX), 1)
                                 : *F.at(0, lumaY, lumaX);
          for (int plane = 1; plane < 3; plane++) {
            int points = plane == 1 ? P.num_cb_points : P.num_cr_points;
            if (!points && !P.chroma_scaling_from_luma) continue;
            pixel* px = F.at(plane, y, x);
            int orig = *px, merged;
            if (P.chroma_scaling_from_luma) {
              merged = averageLuma;
            } else {
              const int* m = mult[plane - 1];
              int combined = averageLuma * (m[1] - 128) + orig * (m[0] - 128);
              merged = clip1((combined >> 6) + (m[2] - 256) * (1 << (BitDepth - 8)));
            }
            int n = round2((int64_t)scale_lut(plane, merged) * noise[plane][(size_t)y * pw + x], scalingShift);
            *px = clip3(minValue, maxChroma, orig + n);
          }
        }
    }
    if (P.num_y_points)
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          pixel* px = F.at(0, y, x);
          int n = round2((int64_t)scale_lut(0, *px) * noise[0][(size_t)y * w + x], scalingShift);
          *px = clip3(minValue, maxLuma, *px + n);
        }
  }

  // --------------------------------------------------------------- tile
  void clear_block_decoded_flags(int r, int c, int sbSize4) {
    for (int plane = 0; plane < P.NumPlanes; plane++) {
      int sx = ssx(plane), sy = ssy(plane);
      int sbWidth4 = (MiColEnd - c) >> sx, sbHeight4 = (MiRowEnd - r) >> sy;
      for (int y = -1; y <= (sbSize4 >> sy); y++)
        for (int x = -1; x <= (sbSize4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbWidth4) v = 1;
          else if (x < 0 && y < sbHeight4) v = 1;
          else v = 0;
          BlockDecoded[plane][y + 1][x + 1] = v;
        }
      BlockDecoded[plane][(sbSize4 >> sy) + 1][0] = 0;
    }
  }

  void decode_tile(const uint8_t* data, int64_t size) {
    cdf.init(P.base_q_idx);  // the coefficient CDFs' set stays on base_q_idx with delta q
    sd.init(data, size, P.disable_cdf_update);
    CurrentQIndex = P.base_q_idx;  // each tile starts from the frame's qindex and no lf deltas
    for (int i = 0; i < 4; i++) DeltaLF[i] = 0;
    for (int p = 0; p < 3; p++) {
      std::fill(AboveLevelContext[p].begin(), AboveLevelContext[p].end(), 0);
      std::fill(AboveDcContext[p].begin(), AboveDcContext[p].end(), 0);
      for (int pass = 0; pass < 2; pass++) {
        RefSgrXqd[p][pass] = Sgrproj_Xqd_Mid[pass];
        for (int i = 0; i < 3; i++) RefLrWiener[p][pass][i] = Wiener_Taps_Mid[i];
      }
    }
    int sbSize = P.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    int sbSize4 = bw4(sbSize);
    for (int r = MiRowStart; r < MiRowEnd; r += sbSize4) {
      for (int p = 0; p < 3; p++) {
        std::fill(LeftLevelContext[p].begin(), LeftLevelContext[p].end(), 0);
        std::fill(LeftDcContext[p].begin(), LeftDcContext[p].end(), 0);
      }
      for (int c = MiColStart; c < MiColEnd; c += sbSize4) {
        ReadDeltas = P.delta_q_present;
        for (int y = r; y < r + sbSize4; y += 16)
          for (int x = c; x < c + sbSize4; x += 16) CdefIdx[mi(y, x)] = -1;
        clear_block_decoded_flags(r, c, sbSize4);
        read_lr(r, c, sbSize);
        decode_partition(r, c, sbSize);
        if (failed) return;
      }
      // dav1d fails the frame once its symbol decoder has read too far past
      // the tile's data at the end of a superblock row: 15 bits or more in
      // SymbolMaxBits, pinned on tiles cut a byte at a time against PIL
      if (sd.max_bits <= -OVERREAD_BITS) {
        fail("symbol decoder overread");
        return;
      }
    }
  }

  void setup(const int32_t* prm) {
    failed = false;
    err[0] = 0;
    memcpy(&P, prm, sizeof P);
    BitDepth = sizeof(pixel) == 1 ? 8 : P.BitDepth;
    PixelMax = (1 << BitDepth) - 1;
  }

  // film grain (7.18.3) added to a frame's planes, in place: a decoded
  // frame's output, or a slot's frame shown again with its grain
  void grain(const int32_t* prm, pixel* oy, pixel* ou, pixel* ov) {
    setup(prm);
    pixel* planes[3] = {oy, ou, ov};
    int padW = (P.UpscaledWidth + 255) & ~127, padH = (P.FrameHeight + 255) & ~127;
    for (int p = 0; p < P.NumPlanes; p++) {
      F.stride[p] = padW >> ssx(p);
      F.ph[p] = padH >> ssy(p);
      F.p[p].assign((size_t)F.stride[p] * F.ph[p], 0);
    }
    copy_planes(planes, false);
    film_grain();
    copy_planes(planes, true);
  }
  void copy_planes(pixel* const* planes, bool out) {
    for (int p = 0; p < P.NumPlanes; p++) {
      int pw = (P.UpscaledWidth + ssx(p)) >> ssx(p), ph = (P.FrameHeight + ssy(p)) >> ssy(p);
      for (int y = 0; y < ph; y++) {
        pixel* a = planes[p] + (size_t)y * pw;
        if (out) memcpy(a, F.at(p, y, 0), pw * sizeof(pixel));
        else memcpy(F.at(p, y, 0), a, pw * sizeof(pixel));
      }
    }
  }

  // decode one frame into oy / ou / ov before film grain; an inter frame
  // predicts from `refs` (7 x 3 planes, LAST_FRAME first, each of the
  // frame's size); where given, mode_info receives each 4x4's RefFrame[0],
  // vector, YMode, transform size, block size and interpolation filter
  // (MODE_INFO_FIELDS int16 a 4x4, row-major over MiRows x MiCols), segments
  // its segment id, and cdfs the frame's end-of-frame CDFs (7.20)
  int run(const int32_t* prm, const uint8_t* data, const int64_t* tiles, int ntiles, pixel* oy, pixel* ou,
          pixel* ov, const void* const* refs, int16_t* mode_info, uint8_t* segments, Cdfs* cdfs) {
    setup(prm);
    for (int r = 0; r < 8; r++)
      for (int p = 0; p < 3; p++)
        RefPlanes[r][p] = r > 0 && refs ? (const pixel*)refs[3 * (r - 1) + p] : nullptr;
    MiCols = 2 * ((P.FrameWidth + 7) >> 3);
    MiRows = 2 * ((P.FrameHeight + 7) >> 3);
    CodedLossless = true;
    for (segment_id = 0; segment_id < MAX_SEGMENTS; segment_id++) {
      LosslessArray[segment_id] = get_qidx(1) == 0 && P.DeltaQYDc == 0 && P.DeltaQUAc == 0 && P.DeltaQUDc == 0 &&
                                  P.DeltaQVAc == 0 && P.DeltaQVDc == 0;
      if (!LosslessArray[segment_id]) CodedLossless = false;
    }
    segment_id = 0;
    MiStride = MiCols + 40;
    size_t nmi = (size_t)(MiRows + 40) * MiStride;
    for (auto* v : {&MiSizes, &YModes, &UVModes, &IsInters, &Skips, &InterTxSizes, &PaletteSizes[0],
                    &PaletteSizes[1], &Decoded, &TxTypes, &InterpFilters})
      v->assign(nmi, 0);
    RefFrame0.assign(nmi, 0);
    SegmentIds.assign(nmi, 0);
    PaletteColors[0].assign(nmi * 8, 0);
    PaletteColors[1].assign(nmi * 8, 0);
    MvRow.assign(nmi, 0);
    MvCol.assign(nmi, 0);
    CdefIdx.assign(nmi, -1);
    DeltaLFs.assign(nmi * 4, 0);
    for (int p = 0; p < 3; p++) {
      lfStride[p] = (MiStride >> ssx(p)) + 40;
      LfTxSizes[p].assign((size_t)((MiRows + 40) >> ssy(p)) * lfStride[p] + 64, 0);
      AboveLevelContext[p].assign(MiStride + 64, 0);
      AboveDcContext[p].assign(MiStride + 64, 0);
      LeftLevelContext[p].assign(MiRows + 104, 0);
      LeftDcContext[p].assign(MiRows + 104, 0);
    }
    int padW = (MiCols * 4 + 255) & ~127, padH = (MiRows * 4 + 255) & ~127;
    for (int p = 0; p < P.NumPlanes; p++) {
      F.stride[p] = padW >> ssx(p);
      F.ph[p] = padH >> ssy(p);
      F.p[p].assign((size_t)F.stride[p] * F.ph[p], 0);
    }
    for (int p = 0; p < P.NumPlanes; p++) {
      if (P.FrameRestorationType[p] == RESTORE_NONE) continue;
      int unitSize = P.LoopRestorationSize[p];
      LrUnitRows[p] = count_units_in_frame(unitSize, round2(P.FrameHeight, ssy(p)));
      LrUnitCols[p] = count_units_in_frame(unitSize, round2(P.UpscaledWidth, ssx(p)));
      size_t n = (size_t)LrUnitRows[p] * LrUnitCols[p];
      LrType[p].assign(n, RESTORE_NONE);
      LrSgrSet[p].assign(n, 0);
      LrWiener[p].assign(n * 6, 0);
      LrSgrXqd[p].assign(n * 2, 0);
    }
    build_scans();
    if (ntiles != P.TileCols * P.TileRows) { fail("tile count mismatch"); return 1; }
    if (cdfs) cdfs->init(P.base_q_idx);  // what the frame keeps under disable_frame_end_update_cdf
    for (int t = 0; t < ntiles && !failed; t++) {
      int tileRow = t / P.TileCols, tileCol = t % P.TileCols;
      MiRowStart = P.MiRowStarts[tileRow];
      MiRowEnd = P.MiRowStarts[tileRow + 1];
      MiColStart = P.MiColStarts[tileCol];
      MiColEnd = P.MiColStarts[tileCol + 1];
      decode_tile(data + tiles[2 * t], tiles[2 * t + 1]);
      if (cdfs && t == P.context_update_tile_id && !P.disable_frame_end_update_cdf) *cdfs = cdf;
    }
    if (failed) return 1;
    for (int r = 0; r < MiRows; r++)
      for (int c = 0; c < MiCols; c++) {
        size_t k = mi(r, c), o = (size_t)r * MiCols + c;
        if (mode_info) {
          int16_t* m = mode_info + MODE_INFO_FIELDS * o;
          m[0] = RefFrame0[k];
          m[1] = MvRow[k];
          m[2] = MvCol[k];
          m[3] = YModes[k];
          m[4] = InterTxSizes[k];
          m[5] = MiSizes[k];
          m[6] = InterpFilters[k];
        }
        if (segments) segments[o] = SegmentIds[k];
      }
    if (!P.allow_intrabc && !CodedLossless) loop_filter();
    deblocked = F;  // CDEF's input, and loop restoration's outside its stripe
    if (!P.allow_intrabc && !CodedLossless) cdef();
    if (P.UpscaledWidth != P.FrameWidth) {
      F = upscaled(F);
      deblocked = upscaled(deblocked);
    }
    if (!P.allow_intrabc) loop_restoration();  // none where the header read AllLossless
    pixel* out[3] = {oy, ou, ov};
    copy_planes(out, true);
    return 0;
  }
};

template <typename pixel>
int decode_as(const int32_t* params, const uint8_t* data, const int64_t* tiles, int ntiles, void* y, void* u,
              void* v, const void* const* refs, int16_t* mode_info, uint8_t* segments, void* cdfs, char* err,
              int errlen) {
  Decoder<pixel>* d = new Decoder<pixel>();
  int rc = d->run(params, data, tiles, ntiles, (pixel*)y, (pixel*)u, (pixel*)v, refs, mode_info, segments,
                  (Cdfs*)cdfs);
  if (rc && err && errlen > 0) snprintf(err, errlen, "%s", d->err);
  delete d;
  return rc;
}

}  // namespace

extern "C" {

// The number of int32 frame parameters av1_decode_frame reads.
int av1_param_count(void) { return (int)(sizeof(Params) / sizeof(int32_t)); }

// The bytes of the CDFs av1_decode_frame keeps for a frame.
int av1_cdf_bytes(void) { return (int)sizeof(Cdfs); }

// Decode one frame: `params` (Params, in order), the tiles' bytes in `data`
// at (offset, size) pairs `tiles`, into Y (H x W) and U, V ((H + ssy) >> ssy
// x (W + ssx) >> ssx each; not written for a monochrome frame, where they
// may be null): uint8_t samples where Params.BitDepth is 8, uint16_t at 10
// and 12, the frame before film grain (av1_film_grain adds it). An inter
// frame reads `refs`, 21 planes of the same layout (LAST_FRAME's Y, U, V,
// then LAST2_FRAME's, .. ALTREF_FRAME's; null in an intra frame). Where not
// null, `mode_info` (MiRows x MiCols x 7 int16: RefFrame[0], the vector's
// row and column, YMode, the transform size, MiSize, the interpolation
// filter), `segments` (MiRows x MiCols) and `cdfs`
// (av1_cdf_bytes()) receive what the frame leaves for later frames.
// Returns 0, or 1 with the reason in `err`.
int av1_decode_frame(const int32_t* params, const uint8_t* data, const int64_t* tiles, int ntiles, void* y,
                     void* u, void* v, const void* const* refs, int16_t* mode_info, uint8_t* segments, void* cdfs,
                     char* err, int errlen) {
  int depth = ((const Params*)params)->BitDepth;
  if (depth == 8)
    return decode_as<uint8_t>(params, data, tiles, ntiles, y, u, v, refs, mode_info, segments, cdfs, err, errlen);
  if (depth == 10 || depth == 12)
    return decode_as<uint16_t>(params, data, tiles, ntiles, y, u, v, refs, mode_info, segments, cdfs, err, errlen);
  if (err && errlen > 0) snprintf(err, errlen, "bit depth %d is not 8, 10 or 12", depth);
  return 1;
}

// Add the film grain of `params` (apply_grain set) to a frame's Y, U, V in
// place, laid out as av1_decode_frame writes them.
void av1_film_grain(const int32_t* params, void* y, void* u, void* v) {
  int depth = ((const Params*)params)->BitDepth;
  if (depth == 8) {
    Decoder<uint8_t>* d = new Decoder<uint8_t>();
    d->grain(params, (uint8_t*)y, (uint8_t*)u, (uint8_t*)v);
    delete d;
  } else {
    Decoder<uint16_t>* d = new Decoder<uint16_t>();
    d->grain(params, (uint16_t*)y, (uint16_t*)u, (uint16_t*)v);
    delete d;
  }
}

// One 1-D inverse transform (0 DCT, 1 ADST, 3 identity) of n values, for
// the tests.
void av1_inverse_1d(int32_t* t, int n, int type) { inverse_1d(t, n, type, 16); }
}
