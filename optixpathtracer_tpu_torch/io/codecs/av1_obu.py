"""AV1 OBUs and headers (AV1 Bitstream & Decoding Process Specification,
section 5): the OBU headers, the sequence header (the reduced still-picture
form and the full one), the uncompressed header of every frame type (the
inter frame's references, size, interpolation filter, order hints,
segmentation, loop filter deltas, reference mode, skip mode, global motion
and film grain against its references) and the tile groups' tile offsets
and sizes, then the tile decode in C++ (`csrc/host/av1_dec.cpp`, built by
utils/host_build).

`decode(obus)` takes the OBUs of an AVIF item (`[TD], SEQ, FRAME` as aom
writes them, or a frame header and tile groups) and returns the Y / U / V
planes of the first frame it shows (4:2:0, 4:2:2, 4:4:4; U and V None for
a monochrome frame; uint8 at 8 bits, uint16 at 10 and 12: profiles 0-2)
and the sequence header; the frame's quantizer matrix levels, delta q /
delta lf, segmentation, CDEF, superres, loop restoration and inter
parameters go to the native decoder with the rest (superres upscales after
CDEF), and film grain is added to the frame shown after loop restoration,
as dav1d adds it.

libavif hands the item to dav1d and keeps the first picture dav1d outputs;
dav1d decodes every frame of the item, and so does the port. Frames are
decoded into the reference slots their refresh_frame_flags name (spec 7.20:
each slot keeps the frame before film grain and what later frames read of
it); a show_existing_frame outputs its slot's frame with the grain that
frame carries (load_grain_params), and fails where the slot is empty
(ROADMAP C.17), as does an inter frame that refers to an empty slot. Tile
list OBUs are skipped, as dav1d skips them.

Inter frames (AVIF step 7) decode with single references of the frame's
own size, translational motion (NEWMV, NEARESTMV, NEARMV, GLOBALMV of an
identity model), a fixed or per-block interpolation filter, intra blocks
among them, and CDFs from the defaults (primary_ref_frame none). What the
port does not decode yet raises NotImplementedError naming ROADMAP A.1
and the tool, and no tile of that frame is decoded: motion-field
projection, OBMC and local warped motion, global motion and the dual filter
(AVIF step 8); compound prediction, skip mode, inter-intra prediction, CDFs
loaded from a reference and scaled references (AVIF step 9).

Every failure inside the AV1 stream (an OBU or header read past its data,
a tile size past its tile group, tile groups out of order, the symbol
decoder's overread that dav1d checks at the end of each superblock row,
no frame shown, a reference dav1d refuses) is dav1d's, and libavif reports
each as "Decoding of color planes failed" (ROADMAP C.19); avif.py turns it
into its alpha message for the alpha item. There is no Python tile
decoder: under OPTIX_TPU_NO_NATIVE=1 the decode raises naming the
switch."""
from __future__ import annotations

import ctypes

import numpy as np

from ...utils import host_build
from ._common import DecodeError, unported

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER, OBU_TILE_GROUP = 1, 2, 3, 4
OBU_FRAME = 6  # the others (metadata, padding, tile lists, ...) are skipped, as dav1d skips them
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
NUM_REF_FRAMES, REFS_PER_FRAME = 8, 7
# libavif's message for every failure dav1d reports, as PIL raises it
COLOR_FAILED = "Failed to decode frame 0: Decoding of color planes failed"
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = 0, 1, 2, 3
REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
SELECT = 2  # SELECT_SCREEN_CONTENT_TOOLS / SELECT_INTEGER_MV
MAX_SEGMENTS, SEG_LVL_ALT_Q, SEG_LVL_REF_FRAME = 8, 0, 5
# Segmentation_Feature_Bits / _Signed / _Max (5.9.14): alt Q, alt LF in four
# slots, reference frame, skip, global MV
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


def unsupported(what: str) -> NotImplementedError:
    """A variant of AVIF that the port does not decode ("AVIF of AV1 film grain")."""
    return unported(f"AVIF of {what}")


class Bits:
    """An MSB-first bit reader over bytes (the spec's f(n), su, ns, leb128,
    uvlc); reading past the end fails as dav1d fails it."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.bit = pos * 8

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.bit >> 3
            if byte >= len(self.data):
                raise DecodeError(COLOR_FAILED)
            x = (x << 1) | (self.data[byte] >> (7 - (self.bit & 7))) & 1
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def byte_align(self) -> None:
        self.bit = (self.bit + 7) & ~7

    @property
    def pos(self) -> int:
        return self.bit >> 3


def leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise DecodeError(COLOR_FAILED)
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            break
    return value, pos


def obus(data: bytes):
    """(obu_type, payload) of each OBU, read one at a time as dav1d reads
    them (an OBU without obu_has_size_field runs to the end)."""
    pos = 0
    while pos < len(data):
        h = data[pos]
        if h & 0x80:  # obu_forbidden_bit
            raise DecodeError(COLOR_FAILED)
        kind, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        pos += 1 + ext
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise DecodeError(COLOR_FAILED)
        yield kind, data[pos:pos + size]
        pos += size


def split_obus(data: bytes) -> list[tuple[int, bytes]]:
    """(obu_type, payload) of every OBU."""
    return list(obus(data))


def sequence_header(payload) -> dict:
    """A sequence header OBU's payload (bytes, or a Bits at its start)."""
    b = payload if isinstance(payload, Bits) else Bits(payload)
    s = {"profile": b.f(3), "still_picture": b.f(1), "reduced": b.f(1)}
    s["decoder_model_info_present"] = 0
    s["equal_picture_interval"] = 0
    s["operating_point_idc"] = [0]
    s["decoder_model_present_for_op"] = [0]
    if s["reduced"]:
        b.f(5)  # seq_level_idx[0]
    else:
        if b.f(1):  # timing_info_present_flag
            b.f(32)
            b.f(32)
            s["equal_picture_interval"] = b.f(1)
            if s["equal_picture_interval"]:
                b.uvlc()
            s["decoder_model_info_present"] = b.f(1)
            if s["decoder_model_info_present"]:
                s["buffer_delay_length"] = b.f(5) + 1
                b.f(32)
                s["buffer_removal_time_length"] = b.f(5) + 1
                s["frame_presentation_time_length"] = b.f(5) + 1
        initial_display_delay_present = b.f(1)
        count = b.f(5) + 1
        s["operating_point_idc"], s["decoder_model_present_for_op"] = [], []
        for _ in range(count):
            s["operating_point_idc"].append(b.f(12))
            level = b.f(5)
            if level > 7:
                b.f(1)
            present = 0
            if s["decoder_model_info_present"]:
                present = b.f(1)
                if present:
                    n = s["buffer_delay_length"]
                    b.f(n)
                    b.f(n)
                    b.f(1)
            s["decoder_model_present_for_op"].append(present)
            if initial_display_delay_present and b.f(1):
                b.f(4)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    s["max_width"], s["max_height"] = b.f(wbits) + 1, b.f(hbits) + 1
    s["frame_width_bits"], s["frame_height_bits"] = wbits, hbits
    s["frame_id_numbers_present"] = 0 if s["reduced"] else b.f(1)
    if s["frame_id_numbers_present"]:
        s["delta_frame_id_length"] = b.f(4) + 2
        s["frame_id_length"] = b.f(3) + 1 + s["delta_frame_id_length"]
    s["use_128"] = b.f(1)
    s["enable_filter_intra"] = b.f(1)
    s["enable_intra_edge_filter"] = b.f(1)
    s["order_hint_bits"] = 0
    for key in ("enable_interintra_compound", "enable_masked_compound", "enable_warped_motion", "enable_dual_filter",
                "enable_jnt_comp", "enable_ref_frame_mvs"):
        s[key] = 0
    if s["reduced"]:
        s["force_screen_content_tools"] = SELECT
        s["force_integer_mv"] = SELECT
    else:
        s["enable_interintra_compound"] = b.f(1)
        s["enable_masked_compound"] = b.f(1)
        s["enable_warped_motion"] = b.f(1)
        s["enable_dual_filter"] = b.f(1)
        enable_order_hint = b.f(1)
        if enable_order_hint:
            s["enable_jnt_comp"] = b.f(1)
            s["enable_ref_frame_mvs"] = b.f(1)
        s["force_screen_content_tools"] = SELECT if b.f(1) else b.f(1)
        if s["force_screen_content_tools"] > 0:
            s["force_integer_mv"] = SELECT if b.f(1) else b.f(1)
        else:
            s["force_integer_mv"] = SELECT
        if enable_order_hint:
            s["order_hint_bits"] = b.f(3) + 1
    s["enable_superres"], s["enable_cdef"], s["enable_restoration"] = b.f(1), b.f(1), b.f(1)
    # color_config
    high = b.f(1)
    bit_depth = 8
    if s["profile"] == 2 and high:
        bit_depth = 12 if b.f(1) else 10
    elif s["profile"] <= 2:
        bit_depth = 10 if high else 8
    s["bit_depth"] = bit_depth
    s["mono"] = 0 if s["profile"] == 1 else b.f(1)
    cp = tc = mc = 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    s["color"] = (cp, tc, mc)
    if s["mono"]:
        s["color_range"] = b.f(1)
        s["ss"] = (1, 1)
        s["separate_uv_delta_q"] = 0
    elif cp == 1 and tc == 13 and mc == 0:
        s["color_range"] = 1
        s["ss"] = (0, 0)
        s["separate_uv_delta_q"] = b.f(1)
    else:
        s["color_range"] = b.f(1)
        if s["profile"] == 0:
            s["ss"] = (1, 1)
        elif s["profile"] == 1:
            s["ss"] = (0, 0)
        elif bit_depth == 12:
            sx = b.f(1)
            s["ss"] = (sx, b.f(1) if sx else 0)
        else:
            s["ss"] = (1, 0)
        if s["ss"] == (1, 1):
            s["chroma_sample_position"] = b.f(2)
        s["separate_uv_delta_q"] = b.f(1)
    s["film_grain_params_present"] = b.f(1)
    return s


def check_sequence(s: dict) -> None:
    """Raise for a profile above 2 (reserved), as dav1d fails it."""
    if s["profile"] > 2:
        raise DecodeError(COLOR_FAILED)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header(b: Bits, s: dict, slots: list | None = None) -> dict:
    """The uncompressed header of a frame (5.9.2-5.9.30); b stops at its
    last bit. `slots` are the reference slots filled so far in the item
    (None where empty; each a dict of what the frame in it left, see
    `decode`): a show_existing_frame returns only {"show_existing_frame":
    1, "frame_to_show": slot}, and fails on an empty slot; an inter or
    switch frame fails where a slot it refers to is empty, as dav1d fails
    it, and reads its size, order hints, loop filter deltas, segmentation,
    global motion and film grain against its references (the defaults
    where primary_ref_frame is none)."""
    slots = [None] * NUM_REF_FRAMES if slots is None else slots
    h = {"show_existing_frame": 0}
    if s["reduced"]:
        frame_type, show_frame, showable = KEY_FRAME, 1, 0
        error_resilient = 1
    else:
        if b.f(1):  # show_existing_frame
            slot = b.f(3)
            if s["decoder_model_info_present"] and not s["equal_picture_interval"]:
                b.f(s["frame_presentation_time_length"])
            if slots[slot] is None:
                raise DecodeError(COLOR_FAILED)  # no frame fills the slot: dav1d fails it (C.17)
            return {"show_existing_frame": 1, "frame_to_show": slot}
        frame_type = b.f(2)
        show_frame = b.f(1)
        if show_frame and s["decoder_model_info_present"] and not s["equal_picture_interval"]:
            b.f(s["frame_presentation_time_length"])
        showable = frame_type != KEY_FRAME if show_frame else b.f(1)
        error_resilient = 1 if frame_type == SWITCH_FRAME or (frame_type == KEY_FRAME and show_frame) else b.f(1)
    intra = frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)
    if not intra and all(slot is None for slot in slots):
        raise DecodeError(COLOR_FAILED)  # an inter frame with no frame before it in the item (C.17)
    h["frame_type"], h["show_frame"], h["showable"] = frame_type, show_frame, showable
    h["error_resilient_mode"] = error_resilient
    h["disable_cdf_update"] = b.f(1)
    sct = b.f(1) if s["force_screen_content_tools"] == SELECT else s["force_screen_content_tools"]
    h["allow_screen_content_tools"] = sct
    fim = 0
    if sct:
        fim = b.f(1) if s["force_integer_mv"] == SELECT else s["force_integer_mv"]
    h["force_integer_mv"] = 1 if intra else fim  # 1 for intra frames whatever it says
    if s["frame_id_numbers_present"]:
        b.f(s["frame_id_length"])
    frame_size_override = 0 if s["reduced"] else 1 if frame_type == SWITCH_FRAME else b.f(1)
    h["order_hint"] = b.f(s["order_hint_bits"])
    h["primary_ref_frame"] = PRIMARY_REF_NONE
    if not (intra or error_resilient):
        h["primary_ref_frame"] = b.f(3)
    if s["decoder_model_info_present"]:
        if b.f(1):  # buffer_removal_time_present_flag
            for op, present in enumerate(s["decoder_model_present_for_op"]):
                if present:
                    idc = s["operating_point_idc"][op]
                    if idc == 0 or (idc & 1 and idc >> 8 & 1):
                        b.f(s["buffer_removal_time_length"])
    refresh = 0xFF if frame_type == SWITCH_FRAME or (frame_type == KEY_FRAME and show_frame) else b.f(8)
    h["refresh_frame_flags"] = refresh
    if (not intra or refresh != 0xFF) and error_resilient and s["order_hint_bits"]:
        for _ in range(NUM_REF_FRAMES):
            b.f(s["order_hint_bits"])  # ref_order_hint, which dav1d reads and ignores
    found = False
    if not intra:
        h["ref_frame_idx"] = _inter_refs(b, s, slots, h["order_hint"])
        if frame_size_override and not error_resilient:
            found = _found_ref(b, h, slots)
    # frame_size, superres_params, render_size
    if found:
        pass
    elif frame_size_override:
        h["width"] = b.f(s["frame_width_bits"]) + 1
        h["height"] = b.f(s["frame_height_bits"]) + 1
    else:
        h["width"], h["height"] = s["max_width"], s["max_height"]
    h["upscaled_width"], h["superres_denom"] = h["width"], 8
    if s["enable_superres"] and b.f(1):  # use_superres
        denom = h["superres_denom"] = b.f(3) + 9
        h["width"] = max((h["upscaled_width"] * 8 + denom // 2) // denom, min(16, h["upscaled_width"]))
    if not found and b.f(1):  # render_and_frame_size_different
        b.f(16)
        b.f(16)
    h["allow_intrabc"] = b.f(1) if intra and sct and h["upscaled_width"] == h["width"] else 0
    if not intra:
        _inter_fields(b, s, h, slots)
    # disable_frame_end_update_cdf
    h["disable_frame_end_update_cdf"] = 1
    if not (s["reduced"] or h["disable_cdf_update"]):
        h["disable_frame_end_update_cdf"] = b.f(1)
    prev = None if h["primary_ref_frame"] == PRIMARY_REF_NONE else slots[h["ref_frame_idx"][h["primary_ref_frame"]]]
    mi_cols, mi_rows = 2 * ((h["width"] + 7) >> 3), 2 * ((h["height"] + 7) >> 3)
    h["mi_cols"], h["mi_rows"] = mi_cols, mi_rows
    _tile_info(b, s, h)
    # quantization_params
    h["base_q_idx"] = b.f(8)

    def delta_q():
        return b.su(7) if b.f(1) else 0
    h["dq_y_dc"] = delta_q()
    h["dq_u_dc"] = h["dq_u_ac"] = h["dq_v_dc"] = h["dq_v_ac"] = 0
    if not s["mono"]:
        diff_uv = b.f(1) if s["separate_uv_delta_q"] else 0
        h["dq_u_dc"], h["dq_u_ac"] = delta_q(), delta_q()
        h["dq_v_dc"], h["dq_v_ac"] = (delta_q(), delta_q()) if diff_uv else (h["dq_u_dc"], h["dq_u_ac"])
    # quantizer matrices (5.9.12): a level per plane, 15 (flat) where off
    h["using_qmatrix"] = b.f(1)
    h["qm_y"] = h["qm_u"] = h["qm_v"] = 15
    if h["using_qmatrix"]:
        h["qm_y"], h["qm_u"] = b.f(4), b.f(4)
        h["qm_v"] = b.f(4) if s["separate_uv_delta_q"] else h["qm_u"]
    if prev is None:
        segmentation_params(b, h)
    else:
        segmentation_params(b, h, prev)
    # delta_q_params / delta_lf_params (5.9.17-5.9.18)
    h["delta_q_present"] = b.f(1) if h["base_q_idx"] > 0 else 0
    h["delta_q_res"] = b.f(2) if h["delta_q_present"] else 0
    h["delta_lf_present"] = h["delta_lf_res"] = h["delta_lf_multi"] = 0
    if h["delta_q_present"]:
        if not h["allow_intrabc"]:
            h["delta_lf_present"] = b.f(1)
        if h["delta_lf_present"]:
            h["delta_lf_res"], h["delta_lf_multi"] = b.f(2), b.f(1)
    # CodedLossless: every segment's qindex 0 and no DC / AC deltas
    deltas = any(h[k] for k in ("dq_y_dc", "dq_u_dc", "dq_u_ac", "dq_v_dc", "dq_v_ac"))
    h["coded_lossless"] = coded_lossless = not deltas and not any(get_qidx(h, i) for i in range(MAX_SEGMENTS))
    # loop_filter_params: the deltas start from the primary reference's
    # (setup_past_independence's defaults without one)
    h["lf_level"] = [0, 0, 0, 0]
    h["lf_sharpness"], h["lf_delta_enabled"] = 0, 1
    h["lf_ref_deltas"] = list(prev["lf_ref_deltas"]) if prev else [1, 0, 0, 0, -1, 0, -1, -1]
    h["lf_mode_deltas"] = list(prev["lf_mode_deltas"]) if prev else [0, 0]
    if not (coded_lossless or h["allow_intrabc"]):
        h["lf_level"][0], h["lf_level"][1] = b.f(6), b.f(6)
        if not s["mono"] and (h["lf_level"][0] or h["lf_level"][1]):
            h["lf_level"][2], h["lf_level"][3] = b.f(6), b.f(6)
        h["lf_sharpness"] = b.f(3)
        h["lf_delta_enabled"] = b.f(1)
        if h["lf_delta_enabled"] and b.f(1):
            for i in range(8):
                if b.f(1):
                    h["lf_ref_deltas"][i] = b.su(7)
            for i in range(2):
                if b.f(1):
                    h["lf_mode_deltas"][i] = b.su(7)
    # cdef_params: strengths per index, a secondary strength of 3 meaning 4
    h["cdef_bits"], h["enable_cdef"], h["cdef_damping"] = 0, 0, 3
    h["cdef_strengths"] = [[0] * 8 for _ in range(4)]  # y pri, y sec, uv pri, uv sec
    if not (coded_lossless or h["allow_intrabc"]) and s["enable_cdef"]:
        h["enable_cdef"] = 1
        h["cdef_damping"] = b.f(2) + 3
        h["cdef_bits"] = b.f(2)
        for i in range(1 << h["cdef_bits"]):
            for k in range(2 if s["mono"] else 4):
                v = b.f(4 if k % 2 == 0 else 2)
                h["cdef_strengths"][k][i] = 4 if k % 2 and v == 3 else v
    # lr_params
    h["lr_type"], h["lr_size"] = [RESTORE_NONE] * 3, [0] * 3
    all_lossless = coded_lossless and h["upscaled_width"] == h["width"]
    if not (all_lossless or h["allow_intrabc"]) and s["enable_restoration"]:
        planes = 1 if s["mono"] else 3
        h["lr_type"][:planes] = [REMAP_LR_TYPE[b.f(2)] for _ in range(planes)]
        if any(h["lr_type"]):
            shift = b.f(1)
            if s["use_128"]:
                shift += 1
            elif shift:
                shift += b.f(1)
            size = 256 >> (2 - shift)
            uv_shift = b.f(1) if s["ss"] == (1, 1) and any(h["lr_type"][1:]) else 0
            h["lr_size"] = [size, size >> uv_shift, size >> uv_shift]
    # read_tx_mode
    h["tx_mode"] = 0 if coded_lossless else (2 if b.f(1) else 1)
    # frame_reference_mode, skip_mode_params, allow_warped_motion (5.9.23,
    # 5.9.22): nothing read in an intra frame
    h["reference_select"] = h["skip_mode_present"] = h["allow_warped_motion"] = 0
    if not intra:
        h["reference_select"] = b.f(1)
        if _skip_mode_allowed(s, h, slots):
            h["skip_mode_present"] = b.f(1)
        if not error_resilient and s["enable_warped_motion"]:
            h["allow_warped_motion"] = b.f(1)
    h["reduced_tx_set"] = b.f(1)
    global_motion_params(b, h, prev)
    h["grain"] = film_grain_params(b, s, h, slots)
    return h


PRIMARY_REF_NONE = 7
# av1_dec.cpp's mode_info of each 4x4: RefFrame[0], the vector's row and
# column, YMode, the transform size, MiSize, the interpolation filter
MODE_INFO_FIELDS = 7
SWITCHABLE = 4  # interpolation_filter: EIGHTTAP, SMOOTH, SHARP, BILINEAR, SWITCHABLE
LAST_FRAME, GOLDEN_FRAME, BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME = 1, 4, 5, 6, 7
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3
WARPEDMODEL_PREC_BITS = 16
DEFAULT_GM_PARAMS = (0, 0, 1 << WARPEDMODEL_PREC_BITS, 0, 0, 1 << WARPEDMODEL_PREC_BITS)


def relative_dist(s: dict, a: int, b: int) -> int:
    """get_relative_dist (7.12.3): a - b in order hints, wrapped."""
    if not s["order_hint_bits"]:
        return 0
    diff, m = a - b, 1 << (s["order_hint_bits"] - 1)
    return (diff & (m - 1)) - (diff & m)


def _inter_refs(b: Bits, s: dict, slots: list, order_hint: int) -> list:
    """ref_frame_idx of an inter or switch frame (5.9.2), set_frame_refs
    (7.8) under frame_refs_short_signaling: an empty slot fails the frame
    as dav1d fails it."""
    if s["order_hint_bits"] and b.f(1):  # frame_refs_short_signaling: LAST and GOLDEN named
        last, gold = b.f(3), b.f(3)
        if slots[last] is None or slots[gold] is None:
            raise DecodeError(COLOR_FAILED)
        refs = _set_frame_refs(s, slots, order_hint, last, gold)
        if s["frame_id_numbers_present"]:
            for _ in range(REFS_PER_FRAME):
                b.f(s["delta_frame_id_length"])
    else:
        refs = []
        for _ in range(REFS_PER_FRAME):
            refs.append(b.f(3))
            if s["frame_id_numbers_present"]:
                b.f(s["delta_frame_id_length"])
    if any(slots[i] is None for i in refs):
        raise DecodeError(COLOR_FAILED)
    return refs


def _set_frame_refs(s: dict, slots: list, order_hint: int, last: int, gold: int) -> list:
    """set_frame_refs (7.8): the five references short signaling leaves
    out, chosen by their slots' order hints."""
    refs = [-1] * REFS_PER_FRAME
    refs[0], refs[GOLDEN_FRAME - LAST_FRAME] = last, gold
    used = [0] * NUM_REF_FRAMES
    used[last] = used[gold] = 1
    cur = 1 << (s["order_hint_bits"] - 1)
    hints = [cur + relative_dist(s, slot["order_hint"] if slot else 0, order_hint) for slot in slots]

    def pick(backward: bool, latest: bool) -> int:
        ref, best = -1, 0
        for i in range(NUM_REF_FRAMES):
            hint = hints[i]
            if not used[i] and (hint >= cur) == backward and (
                    ref < 0 or (hint >= best if latest else hint < best)):
                ref, best = i, hint
        if ref >= 0:
            used[ref] = 1
        return ref
    for frame, backward, latest in ((ALTREF_FRAME, True, True), (BWDREF_FRAME, True, False),
                                    (ALTREF2_FRAME, True, False)):
        ref = pick(backward, latest)
        if ref >= 0:
            refs[frame - LAST_FRAME] = ref
    for frame in (2, 3, BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME):  # Ref_Frame_List
        if refs[frame - LAST_FRAME] < 0:
            ref = pick(False, True)
            if ref >= 0:
                refs[frame - LAST_FRAME] = ref
    earliest = min(range(NUM_REF_FRAMES), key=lambda i: (hints[i], i))
    return [earliest if r < 0 else r for r in refs]


def _found_ref(b: Bits, h: dict, slots: list) -> bool:
    """frame_size_with_refs (5.9.7): found_ref takes a reference's
    (upscaled) width and height; False where none is found."""
    for i in range(REFS_PER_FRAME):
        if b.f(1):  # found_ref
            slot = slots[h["ref_frame_idx"][i]]
            h["width"], h["height"] = slot["upscaled_width"], slot["height"]
            return True
    return False


def _inter_fields(b: Bits, s: dict, h: dict, slots: list) -> None:
    """The inter frame's fields after its size (5.9.2): the MV precision,
    the interpolation filter (5.9.10), is_motion_mode_switchable,
    use_ref_frame_mvs, and each reference's order hint and sign bias."""
    h["allow_high_precision_mv"] = 0 if h["force_integer_mv"] else b.f(1)
    h["interpolation_filter"] = SWITCHABLE if b.f(1) else b.f(2)
    h["is_motion_mode_switchable"] = b.f(1)
    h["use_ref_frame_mvs"] = 0
    if not h["error_resilient_mode"] and s["enable_ref_frame_mvs"]:
        h["use_ref_frame_mvs"] = b.f(1)
    h["order_hints"] = [h["order_hint"]] + [slots[i]["order_hint"] for i in h["ref_frame_idx"]]
    h["ref_frame_sign_bias"] = [0] + [int(relative_dist(s, hint, h["order_hint"]) > 0) for hint in h["order_hints"][1:]]


def _skip_mode_allowed(s: dict, h: dict, slots: list) -> bool:
    """skipModeAllowed (5.9.22), and SkipModeFrame where it holds: the
    nearest forward and backward references, or the two nearest forward."""
    if not (h["reference_select"] and s["order_hint_bits"]):
        return False
    hints = h["order_hints"][1:]
    fwd = bwd = -1
    for i, hint in enumerate(hints):
        d = relative_dist(s, hint, h["order_hint"])
        if d < 0 and (fwd < 0 or relative_dist(s, hint, hints[fwd]) > 0):
            fwd = i
        elif d > 0 and (bwd < 0 or relative_dist(s, hint, hints[bwd]) < 0):
            bwd = i
    if fwd < 0:
        return False
    if bwd < 0:
        for i, hint in enumerate(hints):
            if relative_dist(s, hint, hints[fwd]) < 0 and (bwd < 0 or relative_dist(s, hint, hints[bwd]) > 0):
                bwd = i
        if bwd < 0:
            return False
    h["skip_mode_frame"] = [LAST_FRAME + min(fwd, bwd), LAST_FRAME + max(fwd, bwd)]
    return True


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _signed_subexp_with_ref(b: Bits, low: int, high: int, r: int) -> int:
    """decode_signed_subexp_with_ref (5.9.26-5.9.28), k = 3."""
    mx, r = high - low, r - low
    i = mk = 0
    while True:
        b2 = 3 + i - 1 if i else 3
        a = 1 << b2
        if mx <= mk + 3 * a:
            v = b.ns(mx - mk) + mk
            break
        if not b.f(1):  # subexp_more_bits
            v = b.f(b2) + mk
            break
        i += 1
        mk += a
    x = _inverse_recenter(r, v) if (r << 1) <= mx else mx - 1 - _inverse_recenter(mx - 1 - r, v)
    return x + low


def global_motion_params(b: Bits, h: dict, prev: dict | None) -> None:
    """5.9.24: each reference's warp model type and parameters, coded
    against the primary reference's (PrevGmParams; the defaults without
    one). Nothing is read in an intra frame."""
    h["gm_type"] = [IDENTITY] * 8
    h["gm_params"] = [list(DEFAULT_GM_PARAMS) for _ in range(8)]
    if h["frame_type"] in (KEY_FRAME, INTRA_ONLY_FRAME):
        return
    prev_params = prev["gm_params"] if prev else h["gm_params"]
    for ref in range(LAST_FRAME, ALTREF_FRAME + 1):
        typ = IDENTITY
        if b.f(1):  # is_global
            typ = ROTZOOM if b.f(1) else TRANSLATION if b.f(1) else AFFINE
        h["gm_type"][ref] = typ
        params = h["gm_params"][ref]

        def read(idx):
            abs_bits, prec_bits = 12, 15  # GM_ABS_ALPHA_BITS, GM_ALPHA_PREC_BITS
            if idx < 2:
                hp = 1 - h["allow_high_precision_mv"]
                abs_bits, prec_bits = (9 - hp, 3 - hp) if typ == TRANSLATION else (12, 6)
            diff = WARPEDMODEL_PREC_BITS - prec_bits
            rnd = (1 << WARPEDMODEL_PREC_BITS) if idx % 3 == 2 else 0
            sub = (1 << prec_bits) if idx % 3 == 2 else 0
            mx = 1 << abs_bits
            r = (prev_params[ref][idx] >> diff) - sub
            params[idx] = (_signed_subexp_with_ref(b, -mx, mx + 1, r) << diff) + rnd
        if typ >= ROTZOOM:
            read(2)
            read(3)
            if typ == AFFINE:
                read(4)
                read(5)
            else:
                params[4], params[5] = -params[3], params[2]
        if typ >= TRANSLATION:
            read(0)
            read(1)


GRAIN_POINTS = COLOR_FAILED  # scaling points dav1d refuses


def film_grain_params(b: Bits, s: dict, h: dict, slots: list | None = None) -> dict:
    """5.9.30: the grain of a shown or showable frame of a sequence with
    film grain; {"apply_grain": 0} where there is none. An inter frame
    may take a reference's parameters (update_grain 0,
    load_grain_params) with a seed of its own; the slot must be one of
    its references, as dav1d requires. Scaling points that
    break the spec's rules (more than 14 luma or 10 chroma points, values
    not increasing, one chroma plane of 4:2:0 with points and the other
    without) fail the frame, as dav1d fails it (PIL: RuntimeError)."""
    g = {"apply_grain": 0}
    if not s["film_grain_params_present"] or not (h["show_frame"] or h["showable"]):
        return g
    g["apply_grain"] = b.f(1)
    if not g["apply_grain"]:
        return g
    g["grain_seed"] = b.f(16)
    if h["frame_type"] == INTER_FRAME and not b.f(1):  # update_grain
        idx = b.f(3)  # film_grain_params_ref_idx
        if idx not in h["ref_frame_idx"] or slots[idx] is None:
            raise DecodeError(COLOR_FAILED)
        g = dict(slots[idx]["grain"], apply_grain=1, grain_seed=g["grain_seed"])
        if "y_points" not in g:  # a reference without grain: dav1d's zeroed parameters
            g.update(y_points=[], chroma_scaling_from_luma=0, cb_points=[], cr_points=[], grain_scaling_minus_8=0,
                     ar_coeff_lag=0, ar_coeffs_y_plus_128=[], ar_coeffs_cb_plus_128=[], ar_coeffs_cr_plus_128=[],
                     ar_coeff_shift_minus_6=0, grain_scale_shift=0, cb_mult=0, cb_luma_mult=0, cb_offset=0,
                     cr_mult=0, cr_luma_mult=0, cr_offset=0, overlap_flag=0, clip_to_restricted_range=0)
        return g

    def points(most: int):
        pts = [(b.f(8), b.f(8)) for _ in range(b.f(4))]
        if len(pts) > most or any(q[0] <= p[0] for p, q in zip(pts, pts[1:])):
            raise DecodeError(GRAIN_POINTS)
        return pts
    g["y_points"] = points(14)
    g["chroma_scaling_from_luma"] = 0 if s["mono"] else b.f(1)
    g["cb_points"] = g["cr_points"] = []
    if not (s["mono"] or g["chroma_scaling_from_luma"] or (s["ss"] == (1, 1) and not g["y_points"])):
        g["cb_points"] = points(10)
        g["cr_points"] = points(10)
        if s["ss"] == (1, 1) and bool(g["cb_points"]) != bool(g["cr_points"]):
            raise DecodeError(GRAIN_POINTS)
    g["grain_scaling_minus_8"] = b.f(2)
    lag = g["ar_coeff_lag"] = b.f(2)
    n_luma = 2 * lag * (lag + 1)
    n_chroma = n_luma + 1 if g["y_points"] else n_luma
    g["ar_coeffs_y_plus_128"] = [b.f(8) for _ in range(n_luma)] if g["y_points"] else []
    g["ar_coeffs_cb_plus_128"] = [b.f(8) for _ in range(n_chroma)] \
        if g["chroma_scaling_from_luma"] or g["cb_points"] else []
    g["ar_coeffs_cr_plus_128"] = [b.f(8) for _ in range(n_chroma)] \
        if g["chroma_scaling_from_luma"] or g["cr_points"] else []
    g["ar_coeff_shift_minus_6"] = b.f(2)
    g["grain_scale_shift"] = b.f(2)
    g["cb_mult"] = g["cb_luma_mult"] = g["cb_offset"] = g["cr_mult"] = g["cr_luma_mult"] = g["cr_offset"] = 0
    if g["cb_points"]:
        g["cb_mult"], g["cb_luma_mult"], g["cb_offset"] = b.f(8), b.f(8), b.f(9)
    if g["cr_points"]:
        g["cr_mult"], g["cr_luma_mult"], g["cr_offset"] = b.f(8), b.f(8), b.f(9)
    g["overlap_flag"] = b.f(1)
    g["clip_to_restricted_range"] = b.f(1)
    return g


def segmentation_params(b: Bits, h: dict, prev: dict | None = None) -> None:
    """5.9.14: each segment's enabled features and their clipped values,
    SegIdPreSkip, and LastActiveSegId (-1 where no feature is enabled:
    dav1d's, where the specification has 0). Without a primary reference
    the map and the data are always updated; with one,
    segmentation_update_map, segmentation_temporal_update and
    segmentation_update_data are read, and data not updated is the primary
    reference's."""
    h["segmentation_enabled"] = b.f(1)
    h["segmentation_update_map"], h["segmentation_temporal_update"] = 1, 0
    enabled = [[0] * 8 for _ in range(MAX_SEGMENTS)]
    data = [[0] * 8 for _ in range(MAX_SEGMENTS)]
    if h["segmentation_enabled"]:
        update_data = 1
        if prev is not None:
            h["segmentation_update_map"] = b.f(1)
            if h["segmentation_update_map"]:
                h["segmentation_temporal_update"] = b.f(1)
            update_data = b.f(1)
        if update_data:
            for i in range(MAX_SEGMENTS):
                for j in range(8):
                    enabled[i][j] = b.f(1)
                    if enabled[i][j]:
                        bits, limit = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                        if SEG_FEATURE_SIGNED[j]:
                            data[i][j] = min(max(b.su(1 + bits), -limit), limit)
                        else:
                            data[i][j] = min(b.f(bits), limit)
        else:
            enabled = [list(r) for r in prev["seg_feature_enabled"]]
            data = [list(r) for r in prev["seg_feature_data"]]
    h["seg_feature_enabled"], h["seg_feature_data"] = enabled, data
    active = [i for i in range(MAX_SEGMENTS) if any(enabled[i])]
    h["last_active_seg_id"] = active[-1] if active else -1
    h["seg_id_pre_skip"] = int(any(enabled[i][j] for i in range(MAX_SEGMENTS) for j in range(SEG_LVL_REF_FRAME, 8)))


def get_qidx(h: dict, segment: int) -> int:
    """get_qidx(1, segment) (7.12.2): the frame's qindex with the segment's
    SEG_LVL_ALT_Q."""
    if h["segmentation_enabled"] and h["seg_feature_enabled"][segment][SEG_LVL_ALT_Q]:
        return min(max(h["base_q_idx"] + h["seg_feature_data"][segment][SEG_LVL_ALT_Q], 0), 255)
    return h["base_q_idx"]


def _tile_info(b: Bits, s: dict, h: dict) -> None:
    sb_shift = 5 if s["use_128"] else 4
    sb_cols = (h["mi_cols"] + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (h["mi_rows"] + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    cols, rows = [], []
    if b.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and b.f(1):
            cols_log2 += 1
        w = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        cols = [i << sb_shift for i in range(0, sb_cols, w)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and b.f(1):
            rows_log2 += 1
        hh = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        rows = [i << sb_shift for i in range(0, sb_rows, hh)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            cols.append(start << sb_shift)
            size = b.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(cols))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles > 0 else sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            rows.append(start << sb_shift)
            start += b.ns(min(sb_rows - start, max_h)) + 1
        rows_log2 = _tile_log2(1, len(rows))
    h["mi_col_starts"] = cols + [h["mi_cols"]]
    h["mi_row_starts"] = rows + [h["mi_rows"]]
    h["tile_cols_log2"], h["tile_rows_log2"] = cols_log2, rows_log2
    h["tile_size_bytes"] = 4
    h["context_update_tile_id"] = 0
    if cols_log2 or rows_log2:
        h["context_update_tile_id"] = b.f(cols_log2 + rows_log2)
        h["tile_size_bytes"] = b.f(2) + 1


def tile_group(payload: bytes, pos: int, h: dict, tiles: list) -> None:
    """Append (offset, size) of each tile of a tile group OBU (its tile data
    starting at byte `pos` of `payload`) to `tiles`, in tile order."""
    num_tiles = (len(h["mi_col_starts"]) - 1) * (len(h["mi_row_starts"]) - 1)
    b = Bits(payload, pos)
    start, end = 0, num_tiles - 1
    if num_tiles > 1 and b.f(1):
        bits = h["tile_cols_log2"] + h["tile_rows_log2"]
        start, end = b.f(bits), b.f(bits)
    b.byte_align()
    at = b.pos
    if start != len(tiles) or end < start or end >= num_tiles:
        raise DecodeError(COLOR_FAILED)  # tile groups out of order
    for t in range(start, end + 1):
        if t == end:
            size = len(payload) - at
        else:
            n = h["tile_size_bytes"]
            if at + n > len(payload):
                raise DecodeError(COLOR_FAILED)
            size = int.from_bytes(payload[at:at + n], "little") + 1
            at += n
        if size <= 0 or at + size > len(payload):
            raise DecodeError(COLOR_FAILED)  # a tile past its tile group
        tiles.append((payload, at, size))
        at += size


_SIG = None


def _native():
    global _SIG
    if not host_build.native_enabled():
        raise NotImplementedError("AVIF decoding needs the native AV1 tile decoder (csrc/host/av1_dec.cpp), "
                                  "which OPTIX_TPU_NO_NATIVE=1 turns off; there is no Python tile decoder")
    lib = host_build.load("av1_dec")
    if _SIG is None:
        f = lib.av1_decode_frame
        f.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        f.restype = ctypes.c_int
        lib.av1_param_count.restype = ctypes.c_int
        _SIG = (f, lib.av1_param_count())
    return _SIG


def _lib_fn(name: str, argtypes: list, restype):
    """A function of the (loaded) native decoder with its signature."""
    f = getattr(host_build.load("av1_dec"), name)
    f.argtypes, f.restype = argtypes, restype
    return f


def _params(s: dict, h: dict) -> np.ndarray:
    cols, rows = h["mi_col_starts"], h["mi_row_starts"]
    vals = [h["width"], h["height"], s["use_128"], s["enable_filter_intra"], s["enable_intra_edge_filter"],
            h["allow_screen_content_tools"], h["allow_intrabc"], h["base_q_idx"], h["dq_y_dc"], h["dq_u_dc"],
            h["dq_u_ac"], h["dq_v_dc"], h["dq_v_ac"], h["tx_mode"], h["reduced_tx_set"], h["disable_cdf_update"],
            *h["lf_level"], h["lf_sharpness"], h["lf_delta_enabled"], *h["lf_ref_deltas"], *h["lf_mode_deltas"],
            h["enable_cdef"], h["cdef_bits"], len(cols) - 1, len(rows) - 1]
    vals += cols + [0] * (65 - len(cols)) + rows + [0] * (65 - len(rows))
    vals += [*s["ss"], 1 if s["mono"] else 3, h["cdef_damping"], *sum(h["cdef_strengths"], []), *h["lr_type"],
             *h["lr_size"], s["bit_depth"]]
    vals += [h[k] for k in ("using_qmatrix", "qm_y", "qm_u", "qm_v", "delta_q_present", "delta_q_res",
                            "delta_lf_present", "delta_lf_res", "delta_lf_multi")]
    vals += [s["color"][2]] + _grain_params(h["grain"])
    vals += [h["segmentation_enabled"], h["seg_id_pre_skip"], h["last_active_seg_id"],
             *sum(h["seg_feature_enabled"], []), *sum(h["seg_feature_data"], [])]
    vals += [h["upscaled_width"], h["superres_denom"]]
    intra = h["frame_type"] in (KEY_FRAME, INTRA_ONLY_FRAME)
    vals += [int(intra), h.get("interpolation_filter", 0), h.get("allow_high_precision_mv", 0),
             h["force_integer_mv"], *h.get("ref_frame_sign_bias", [0] * 8), h["context_update_tile_id"],
             h["disable_frame_end_update_cdf"]]
    return np.array(vals, np.int32)


def _padded(values: list, n: int) -> list:
    return list(values) + [0] * (n - len(values))


GRAIN_SLOTS = 160  # av1_dec.cpp's Params from apply_grain to clip_to_restricted_range


def _grain_params(g: dict) -> list:
    """film_grain_params in av1_dec.cpp's order (zeros without grain)."""
    if not g["apply_grain"]:
        return [0] * GRAIN_SLOTS
    out = [1, g["grain_seed"]]
    for key, most in (("y_points", 14), ("cb_points", 10), ("cr_points", 10)):
        pts = g[key]
        out += [len(pts), *_padded([v for v, _ in pts], most), *_padded([sc for _, sc in pts], most)]
        if key == "y_points":
            out.append(g["chroma_scaling_from_luma"])
    out += [g["grain_scaling_minus_8"], g["ar_coeff_lag"], *_padded(g["ar_coeffs_y_plus_128"], 24),
            *_padded(g["ar_coeffs_cb_plus_128"], 25), *_padded(g["ar_coeffs_cr_plus_128"], 25),
            g["ar_coeff_shift_minus_6"], g["grain_scale_shift"]]
    out += [g[k] for k in ("cb_mult", "cb_luma_mult", "cb_offset", "cr_mult", "cr_luma_mult", "cr_offset",
                           "overlap_flag", "clip_to_restricted_range")]
    return out


def inter_unported(s: dict, h: dict, slots: list) -> str | None:
    """The inter tool of a frame that AVIF steps 8 and 9 will decode (ROADMAP
    A.1.1), or None: what AVIF step 7 decodes is an inter frame of single
    references of its own size, translational motion with a fixed or
    per-block filter, and CDFs from the defaults. A reference that dav1d
    refuses (a size more than twice or under a sixteenth of the frame's,
    another depth or layout) fails the frame as it fails in dav1d."""
    if h["frame_type"] in (KEY_FRAME, INTRA_ONLY_FRAME):
        return None
    for i in h["ref_frame_idx"]:
        slot = slots[i]
        if (2 * h["width"] < slot["upscaled_width"] or 2 * h["height"] < slot["height"]
                or h["width"] > 16 * slot["upscaled_width"] or h["height"] > 16 * slot["height"]
                or slot["seq"]["bit_depth"] != s["bit_depth"] or slot["seq"]["ss"] != s["ss"]
                or slot["seq"]["mono"] != s["mono"]):
            raise DecodeError(COLOR_FAILED)
    if h["use_ref_frame_mvs"]:
        return "AV1 motion-field projection (use_ref_frame_mvs; AVIF step 8)"
    if h["is_motion_mode_switchable"]:
        return "AV1 OBMC / local warped motion (is_motion_mode_switchable; AVIF step 8)"
    if any(h["gm_type"][1:]):
        return "AV1 global motion (is_global; AVIF step 8)"
    if s["enable_dual_filter"] and h["interpolation_filter"] == SWITCHABLE:
        return "AV1 dual filter (enable_dual_filter with a switchable filter; AVIF step 8)"
    if h["reference_select"]:
        return "AV1 compound prediction (reference_select; AVIF step 9)"
    if h["skip_mode_present"]:
        return "AV1 skip mode (skip_mode_present; AVIF step 9)"
    if s["enable_interintra_compound"]:
        return "AV1 inter-intra prediction (enable_interintra_compound; AVIF step 9)"
    if h["primary_ref_frame"] != PRIMARY_REF_NONE:
        return "AV1 CDFs loaded from a reference (primary_ref_frame; AVIF step 9)"
    if any(slots[i]["upscaled_width"] != h["width"] or slots[i]["height"] != h["height"] for i in h["ref_frame_idx"]):
        return "AV1 scaled references (a reference of another size; AVIF step 9)"
    return None


def decode(data: bytes, frames: list | None = None):
    """The OBUs of an AV1 item -> the first frame dav1d shows: (Y (H, W),
    U, V ((H + ssy) >> ssy, (W + ssx) >> ssx), uint8 at 8 bits and uint16
    at 10 and 12, or None for a monochrome frame; the sequence header). W
    is the upscaled width under superres. Every frame of the item is
    decoded, as dav1d decodes them, so that a failure after the shown
    frame fails the item too.

    The reference store (7.20, 7.21): each slot a refreshed frame fills
    keeps its planes before film grain, its header (size, order hint,
    frame type, the OrderHints of its own references, loop filter deltas,
    segmentation, global motion and film grain parameters), its segment
    map, its per-4x4 references and vectors and its end-of-frame CDFs; a
    shown frame, or a slot shown again by show_existing_frame, gets the
    grain its header carries. Each decoded frame's slot record is appended
    to `frames` where given.

    A frame whose inter tools the port does not decode (`inter_unported`)
    raises A.1 naming the tool once the item's OBUs are read: that frame
    and the ones after it are parsed (headers and tile groups) but not
    decoded, so that a failure of the stream after it fails as dav1d
    fails it."""
    seq, cur, shown, slots = None, None, None, [None] * NUM_REF_FRAMES
    pending = None  # the tool of the first frame the port does not decode
    for kind, payload in obus(data):
        if kind == OBU_SEQUENCE_HEADER:
            seq = sequence_header(payload)
            check_sequence(seq)
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME):
            if cur is not None:
                if kind == OBU_FRAME_HEADER and payload == cur[0]:
                    continue  # a copy of the frame header
                raise DecodeError(COLOR_FAILED)  # a new frame before the last one's tiles
            if seq is None:
                raise DecodeError(COLOR_FAILED)  # a frame before a sequence header
            b = Bits(payload)
            hdr = frame_header(b, seq, slots)
            if hdr["show_existing_frame"]:
                slot = slots[hdr["frame_to_show"]]
                if shown is None and pending is None:
                    shown = _with_grain(slot)
                if slot["frame_type"] == KEY_FRAME:  # showing a key frame refreshes every slot
                    slots = [slot] * NUM_REF_FRAMES
                continue
            pending = pending or inter_unported(seq, hdr, slots)
            cur = (payload, hdr, [])
            if kind == OBU_FRAME:
                b.byte_align()
                tile_group(payload, b.pos, hdr, cur[2])
        elif kind == OBU_TILE_GROUP:
            if cur is None:
                raise DecodeError(COLOR_FAILED)  # a tile group before a frame header
            tile_group(payload, 0, cur[1], cur[2])
        if cur is not None and len(cur[2]) == (len(cur[1]["mi_col_starts"]) - 1) * (len(cur[1]["mi_row_starts"]) - 1):
            _, hdr, tiles = cur
            if pending is None:
                frame = _decode_frame(seq, hdr, tiles, slots)
                if frames is not None:
                    frames.append(frame)
                if hdr["show_frame"] and shown is None:
                    shown = _with_grain(frame)
            else:  # from the first frame not decoded on, headers alone: a later failure is still dav1d's
                frame = _slot(seq, hdr)
            refresh(slots, hdr, frame)
            cur = None
    if pending is not None:
        raise unsupported(pending)
    if shown is None:
        raise DecodeError(COLOR_FAILED)  # no frame shown
    y, u, v, seq = shown
    return y, u, v, seq


def _with_grain(frame: dict):
    """(Y, U, V, sequence header) of a decoded frame as shown: its planes
    with the film grain of its header added (load_grain_params for a
    show_existing_frame)."""
    y, u, v = frame["planes"]
    if frame["hdr"]["grain"]["apply_grain"]:
        y, u, v = y.copy(), None if u is None else u.copy(), None if v is None else v.copy()
        grain = _lib_fn("av1_film_grain", [ctypes.POINTER(ctypes.c_int32)] + [ctypes.c_void_p] * 3, None)
        grain(_params(frame["seq"], frame["hdr"]).ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), y.ctypes.data,
              None if u is None else u.ctypes.data, None if v is None else v.ctypes.data)
    return y, u, v, frame["seq"]


def _decode_frame(seq: dict, hdr: dict, tiles: list, slots: list) -> dict:
    """One frame's tiles through the native decoder -> the reference slot
    it leaves: its planes before film grain and what later frames read of
    it (see `decode`)."""
    fn, n_params = _native()
    params = _params(seq, hdr)
    assert len(params) == n_params, (len(params), n_params)
    blob = b"".join(p[at:at + size] for p, at, size in tiles)
    offsets, at = [], 0
    for _, _, size in tiles:
        offsets += [at, size]
        at += size
    offs = np.array(offsets, np.int64)
    w, h = hdr["upscaled_width"], hdr["height"]
    sx, sy = seq["ss"]
    dtype = np.uint8 if seq["bit_depth"] == 8 else np.uint16
    y = np.zeros((h, w), dtype)
    u = v = None
    uv = [None, None]
    if not seq["mono"]:
        u = np.zeros(((h + sy) >> sy, (w + sx) >> sx), dtype)
        v = np.zeros_like(u)
        uv = [u.ctypes.data, v.ctypes.data]
    refs = None
    if "ref_frame_idx" in hdr:
        planes = [p for i in hdr["ref_frame_idx"] for p in slots[i]["planes"]]
        refs = (ctypes.c_void_p * 21)(*[None if p is None else p.ctypes.data for p in planes])
    mode_info = np.zeros((hdr["mi_rows"], hdr["mi_cols"], MODE_INFO_FIELDS), np.int16)
    segments = np.zeros((hdr["mi_rows"], hdr["mi_cols"]), np.uint8)
    cdfs = ctypes.create_string_buffer(_lib_fn("av1_cdf_bytes", [], ctypes.c_int)())
    err = ctypes.create_string_buffer(256)
    rc = fn(params.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), blob,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(tiles), y.ctypes.data, *uv, refs,
            mode_info.ctypes.data, segments.ctypes.data, cdfs, err, 256)
    if rc:
        raise DecodeError(COLOR_FAILED)  # the tiles fail in dav1d as here (err.value says why)
    return dict(_slot(seq, hdr), planes=(y, u, v), segment_ids=segments, mode_info=mode_info, cdfs=cdfs.raw)


def _slot(seq: dict, hdr: dict) -> dict:
    """What a reference slot keeps of a frame's headers (7.20)."""
    return {"seq": seq, "hdr": hdr, "frame_type": hdr["frame_type"], "order_hint": hdr["order_hint"],
            "upscaled_width": hdr["upscaled_width"], "height": hdr["height"],
            "order_hints": hdr.get("order_hints", [hdr["order_hint"]] * NUM_REF_FRAMES), "grain": hdr["grain"],
            "lf_ref_deltas": hdr["lf_ref_deltas"], "lf_mode_deltas": hdr["lf_mode_deltas"],
            "seg_feature_enabled": hdr["seg_feature_enabled"], "seg_feature_data": hdr["seg_feature_data"],
            "gm_params": hdr["gm_params"]}


def frame_headers(data: bytes) -> list:
    """The frame headers of an AV1 item in order (a show_existing_frame's
    too), each read against the slots the frames before it fill: what
    `decode` reads before each frame's tiles, with no tile decoded."""
    seq, out, slots = None, [], [None] * NUM_REF_FRAMES
    for kind, payload in obus(data):
        if kind == OBU_SEQUENCE_HEADER:
            seq = sequence_header(payload)
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME) and not (out and kind == OBU_FRAME_HEADER and
                                                             payload == out[-1][1]):
            hdr = frame_header(Bits(payload), seq, slots)
            out.append((hdr, payload))
            if hdr["show_existing_frame"]:
                if slots[hdr["frame_to_show"]]["frame_type"] == KEY_FRAME:
                    slots = [slots[hdr["frame_to_show"]]] * NUM_REF_FRAMES
                continue
            refresh(slots, hdr, _slot(seq, hdr))
    return [hdr for hdr, _ in out]


def refresh(slots: list, hdr: dict, frame: dict) -> None:
    """The reference update (7.20): `frame` into each slot of the header's
    refresh_frame_flags."""
    for i in range(NUM_REF_FRAMES):
        if hdr["refresh_frame_flags"] >> i & 1:
            slots[i] = frame
