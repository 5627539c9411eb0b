"""Port parity, AVIF step 6's frames: ROADMAP C.18 (dav1d's symbol-decoder
overread), C.19 (PIL's message for every failure inside the AV1 stream)
and the first frame an item shows (io/codecs/av1_obu.py's decode,
csrc/host/av1_dec.cpp's overread check).

- C.18: the frame_type of good-quality stills (a full sequence header,
  `single=False`) flipped to intra-only, over 8, 10 and 12 bits, three
  sizes and two layouts: each decodes equal to PIL or fails with PIL's
  message; two of them read far past their tile's data, which dav1d fails
  and the port decoded before.
- The overread threshold, pinned on tiles cut a byte at a time
  (make_textures.avif_tile_cut): each cut reads 8 more bits past the
  tile's data, and the port fails from the same cut as PIL, at each depth
  and in an inner tile of a 2 x 2-tile still.
- C.19: a file for each failure of the AV1 stream (make_textures' OBU and
  header edits) fails with PIL's message, "Decoding of color planes
  failed", or "Decoding of alpha plane failed" in the alpha item.
- The first shown frame (make_textures.avif_frames, key_frame_as,
  show_existing_frame): a hidden key frame shown by show_existing_frame
  with its film grain, a hidden key frame and a shown intra-only frame,
  a shown frame with more frames and OBUs after it (dav1d decodes them
  all and keeps the first picture; a failure in them fails the item), a
  show_existing_frame of an empty slot. Planes equal to dav1d's, RGB to
  PIL's; each failure PIL's message.
- An inter frame shown first that uses AVIF step 8's motion-field
  projection raises A.1 naming it.

The oracle cases skip where PIL ships no libavif, the encodes where OpenCV
ships none.
"""
import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_codecs_avif_tools import _fixture
import torch_codec_encoders as enc
from torch_codec_encoders import avif_still, pil_bytes, pil_rgb, photo, yuv_photo
from torch_fixtures import make_textures as mt

needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")
COLOR_FAILED = mt.COLOR_FAILED
ALPHA_FAILED = "Failed to decode frame 0: Decoding of alpha plane failed"


def _as_pil(data: bytes):
    """The port decodes `data` equal to PIL, planes equal to dav1d's, or
    fails with PIL's message -> PIL's message or None."""
    try:
        want = pil_rgb(data)
    except (RuntimeError, SyntaxError) as e:
        with pytest.raises(codecs.DecodeError) as got:
            codecs.rgb8(data)
        assert str(got.value) == str(e)
        return str(e)
    np.testing.assert_array_equal(codecs.rgb8(data), want)
    _assert_planes_equal(data)
    return None


def _good(h: int, w: int, depth: int, fmt: int, seed: int, **kw) -> bytes:
    return oracle.encode_hbd(yuv_photo(h, w, seed, depth, fmt), depth, fmt, single=False, **kw)


@needs_encoder
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("size", [(48, 64), (96, 96), (128, 160)])
@pytest.mark.parametrize("fmt", [1, 3])
def test_intra_only_flip_as_pil(depth, size, fmt):
    """C.18 / C.19: frame_type flipped from key to intra-only (bit 1 of the
    frame header): the port decodes it equal to PIL or fails as PIL
    fails."""
    data = mt.avif_frame_bit_flipped(_good(*size, depth, fmt, 20 + depth), 1)
    message = _as_pil(data)
    assert message in (None, COLOR_FAILED)


@needs_encoder
@pytest.mark.parametrize("case", [(12, (96, 96), 1), (12, (128, 160), 3)])
def test_overread_fails_as_pil(case):
    """C.18: the two flips whose symbol decoder reads hundreds of bits past
    its tile (SymbolMaxBits -1251 and -527 at the end of a superblock
    row): dav1d fails them, and so does the port, with PIL's message."""
    depth, size, fmt = case
    data = mt.avif_frame_bit_flipped(_good(*size, depth, fmt, 20 + depth), 1)
    with pytest.raises(RuntimeError, match=COLOR_FAILED):
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError, match=COLOR_FAILED):
        codecs.rgb8(data)


# (depth, layout, (height, width), tiles (rows, cols) as log2, the tile cut)
CUTS = [(8, 3, (64, 64), (0, 0), -1), (10, 1, (48, 64), (0, 0), -1), (12, 3, (64, 80), (0, 0), -1),
        (12, 1, (96, 96), (0, 0), -1), (8, 3, (128, 128), (1, 1), 0), (8, 3, (128, 128), (1, 1), 1),
        (10, 4, (128, 128), (1, 1), 2)]


@needs_encoder
@pytest.mark.parametrize("case", CUTS)
def test_overread_threshold_pinned_by_tile_cuts(case):
    """dav1d fails a frame once its symbol decoder has read 15 bits or
    more past a tile's data at the end of a superblock row (SymbolMaxBits
    -15): each byte cut off the tile's end moves that by 8 bits. The
    uncut still decodes (its tile ends at -8 to -14) and the port fails
    from the same cut as PIL, in the last tile and in an inner one."""
    depth, fmt, size, tiles, tile = case
    data = _good(*size, depth, fmt, 30 + depth, tiles_log2=tiles)
    first = {}
    for who, decode in (("pil", pil_rgb), ("port", codecs.rgb8)):
        for cut in range(4):
            try:
                decode(mt.avif_tile_cut(data, cut, tile))
            except (RuntimeError, codecs.DecodeError) as e:
                assert str(e) == COLOR_FAILED
                first[who] = cut
                break
    assert first["pil"] == first["port"] == 1


def _frame_parts(depth: int = 8, grain: bool = True):
    """Two good-quality stills of one sequence header (film grain where
    asked) -> (the first still, the sequence header, its frame payload,
    the second's)."""
    kw = {"options": {"film-grain-test": 1}} if grain else {}
    a = _good(48, 64, depth, 3, 143, **kw)
    b = _good(48, 64, depth, 3, 144, **({"options": {"film-grain-test": 2}} if grain else {}))
    seq, key_a = mt.frame_payload(a)
    return a, seq, key_a, mt.frame_payload(b)[1], b


def _leb_cut(payload: bytes) -> bytes:
    """An OBU whose size field runs past the data."""
    return bytes([av1_obu.OBU_FRAME << 3 | 2]) + mt.leb128(len(payload) + 10) + payload


@needs_encoder
@pytest.mark.parametrize("site", ["forbidden_bit", "obu_past_the_data", "leb128_cut", "header_past_its_payload",
                                  "profile_3", "frame_before_sequence_header", "tile_group_before_frame_header",
                                  "tile_groups_out_of_order", "tile_size_field_past_the_group", "tile_past_its_group",
                                  "no_frame_shown", "new_frame_before_tiles", "existing_empty_slot",
                                  "inter_empty_slot", "overread"])
def test_every_stream_failure_as_pil(site):
    """C.19: each failure av1_obu.py and the tile decoder report inside the
    AV1 stream, tripped by a file of its own: PIL's message, "Decoding of
    color planes failed", and the port's the same."""
    a, seq, key, _, _ = _frame_parts(grain=False)
    head = mt.obu(av1_obu.OBU_SEQUENCE_HEADER, avif_seq(a))
    hidden = mt.key_frame_as(key, seq, show_frame=0, refresh=0x01)
    frames = {
        "forbidden_bit": [(b"\x80\x00",)],
        "obu_past_the_data": [(_leb_cut(key),)],
        "leb128_cut": [(bytes([av1_obu.OBU_FRAME << 3 | 2, 0x80]),)],
        "header_past_its_payload": [key[:3]],
        "tile_group_before_frame_header": [(mt.obu(av1_obu.OBU_TILE_GROUP, key[10:]),)],
        "no_frame_shown": [hidden],
        "existing_empty_slot": [hidden, (mt.show_existing_frame(5),)],
        "overread": [key[:len(key) - 2]],
    }
    if site in frames:
        data = mt.avif_frames(a, frames[site])
    elif site == "frame_before_sequence_header":
        _, av1c, colr = mt.avif_parts(a)
        data = avif_still(mt.obu(av1_obu.OBU_FRAME, key) + head, (64, 48), av1c, colr=colr)
    elif site == "profile_3":
        data = mt.avif_frames(a, [key])
        at = data.rindex(head) + 2  # seq_profile: the payload's first 3 bits, in the item (not av1C's copy)
        data = data[:at] + bytes([data[at] & 0x1F | 0x60]) + data[at + 1:]
    elif site == "inter_empty_slot":
        data = _inter_after(a, seq, key)
    else:
        data = _tiled_edit(site)
    assert _as_pil(data) == COLOR_FAILED


def avif_seq(data: bytes) -> bytes:
    """The sequence header OBU's payload of a one-item still."""
    obus, _, _ = mt.avif_parts(data)
    return next(p for k, p in av1_obu.split_obus(obus) if k == av1_obu.OBU_SEQUENCE_HEADER)


def _intra_only_all(key: bytes, seq: dict) -> bytes:
    """A shown key frame rewritten as an intra-only frame refreshing every
    slot, which the specification forbids and dav1d decodes."""
    fh = av1_obu.frame_header
    h, log, end = mt._logged_reads(fh, key, seq)
    ft_at = mt._reads_at(log, mt._line(fh, "frame_type = b.f(2)"))[0][0]
    shown_at = mt._reads_at(log, mt._line(fh, "show_frame = b.f(1)"))[0][0]
    at = min(r[0] for r in log if r[3] > mt._line(fh, "# frame_size, superres_params, render_size"))
    bits = mt._edited(mt._bits(key, end), [(ft_at, 2, [1, 0]), (shown_at + 1, 0, [0]), (at, 0, [1] * 8)])
    return mt._bytes(bits) + key[(end + 7) // 8:]


def _inter_after(a: bytes, seq: dict, key: bytes) -> bytes:
    """A hidden key frame in slot 0, then an inter frame header (shown,
    error resilient, refreshing nothing) naming slot 5 among its
    references."""
    assert not (seq["reduced"] or seq["decoder_model_info_present"] or seq["frame_id_numbers_present"])
    ohb = seq["order_hint_bits"]
    # show_existing_frame 0, INTER_FRAME, show_frame, error_resilient_mode, disable_cdf_update 0
    bits = [0, 0, 1, 1, 1, 0] + ([0] if seq["force_screen_content_tools"] == av1_obu.SELECT else [])
    bits += [0] + [0] * ohb + [0] * 8 + [0] * 8 * ohb  # frame_size_override, order_hint, refresh, ref_order_hint
    bits += [0] if ohb else []  # frame_refs_short_signaling
    bits += [1, 0, 1] + [0, 0, 0] * 6  # ref_frame_idx: slot 5, then slot 0
    return mt.avif_frames(a, [mt.key_frame_as(key, seq, show_frame=0, refresh=0x01),
                              (mt.obu(av1_obu.OBU_FRAME_HEADER, mt._bytes(bits + [1])),)])


def _tiled_edit(site: str) -> bytes:
    """A 2 x 2-tile still as a frame header OBU and tile group OBUs, edited
    so that the tile groups fail."""
    data = _good(128, 128, 8, 3, 39, tiles_log2=(1, 1))
    seq, payload = mt.frame_payload(data)
    b = av1_obu.Bits(payload)
    h = av1_obu.frame_header(b, seq)
    end = b.bit
    b.byte_align()
    tiles = []
    av1_obu.tile_group(payload, b.pos, h, tiles)
    header = mt.obu(av1_obu.OBU_FRAME_HEADER, mt._bytes(mt._bits(payload, end) + [1]))
    n = h["tile_size_bytes"]
    bits = h["tile_cols_log2"] + h["tile_rows_log2"]

    def group(first: int, last: int, sizes=None) -> bytes:
        out = mt._uint_bits(1, 1) + mt._uint_bits(first, bits) + mt._uint_bits(last, bits)
        body = mt._bytes(out)
        for t in range(first, last + 1):
            _, at, size = tiles[t]
            if t < last:
                body += ((sizes or {}).get(t, size) - 1).to_bytes(n, "little")
            body += payload[at:at + size]
        return mt.obu(av1_obu.OBU_TILE_GROUP, body)
    if site == "tile_groups_out_of_order":
        obus = header + group(2, 3) + group(0, 1)
    elif site == "tile_size_field_past_the_group":  # two of tile 0's size bytes, then the group ends
        obus = header + mt.obu(av1_obu.OBU_TILE_GROUP, group(0, 1)[2:][:1 + 2]) + group(2, 3)
    elif site == "tile_past_its_group":
        obus = header + group(0, 1, {0: 1 << (8 * n)}) + group(2, 3)
    else:  # another frame header before the first frame's last tile group
        obus = header + group(0, 1) + mt.obu(av1_obu.OBU_FRAME_HEADER, mt._bytes(mt._bits(payload, end) + [1, 1]))
    obus = mt.obu(av1_obu.OBU_SEQUENCE_HEADER, avif_seq(data)) + obus
    _, av1c, colr = mt.avif_parts(data)
    return avif_still(obus, (128, 128), av1c, colr=colr)


@needs_encoder
def test_alpha_item_failure_is_the_alpha_message():
    """A failure inside the alpha item's AV1 stream is PIL's alpha message:
    an RGBA still whose alpha item's frame OBU runs past the item."""
    from PIL import Image

    data = pil_bytes(Image.fromarray(photo(40, 48, 10, 4), "RGBA"), "AVIF")
    colour, av1c, colr = mt.avif_parts(data)
    _, off, ln = mt._iloc(data)[2]
    parts = dict(av1_obu.split_obus(data[off:off + ln]))
    meta, _ = mt._primary(data)
    alpha_av1c = [data[s - 8:e] for k, s, e in meta.props if k == b"av1C"][1]
    alpha = mt.obu(av1_obu.OBU_SEQUENCE_HEADER, parts[av1_obu.OBU_SEQUENCE_HEADER]) + _leb_cut(parts[av1_obu.OBU_FRAME])
    edited = avif_still(colour, (48, 40), av1c, colr=colr, alpha=(alpha, alpha_av1c))
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(edited)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(edited)
    assert str(got.value) == str(pil_error.value) == ALPHA_FAILED


@needs_encoder
@pytest.mark.parametrize("grain", [True, False])
@pytest.mark.parametrize("case", ["hidden_key_existing", "hidden_unshowable_existing", "hidden_key_intra_only",
                                  "two_hidden_existing_second", "shown_then_second", "shown_then_padding",
                                  "shown_then_temporal_delimiter", "shown_then_metadata", "hidden_existing_then_shown",
                                  "shown_existing_after", "intra_only_shown_existing_after",
                                  "intra_only_refreshing_every_slot"])
def test_first_shown_frame_as_pil(case, grain):
    """The first frame an item shows is its picture, with the grain of the
    frame shown (load_grain_params: a hidden key frame shown by
    show_existing_frame carries its own); frames and OBUs after it are read
    and decoded but do not change it."""
    a, seq, key, second, b = _frame_parts(grain=grain)
    hidden = mt.key_frame_as(key, seq, show_frame=0, refresh=0x04)
    frames = {
        "hidden_key_existing": [hidden, (mt.show_existing_frame(2),)],
        "hidden_unshowable_existing": [mt.key_frame_as(key, seq, show_frame=0, refresh=0x04, showable=0),
                                       (mt.show_existing_frame(2),)],
        "hidden_key_intra_only": [hidden, mt.key_frame_as(second, seq, frame_type=2, refresh=0x01)],
        "two_hidden_existing_second": [hidden, mt.key_frame_as(second, seq, show_frame=0, refresh=0x10),
                                       (mt.show_existing_frame(4),)],
        "shown_then_second": [key, second],
        "shown_then_padding": [key, (mt.obu(15, b"\xff\x00junk"),)],
        "shown_then_temporal_delimiter": [key, (mt.obu(av1_obu.OBU_TEMPORAL_DELIMITER, b""),)],
        "shown_then_metadata": [key, (mt.obu(5, b"\xff\x00junk"),)],
        "hidden_existing_then_shown": [hidden, (mt.show_existing_frame(2),), second],
        "shown_existing_after": [key, (mt.show_existing_frame(3),)],
        "intra_only_shown_existing_after": [mt.key_frame_as(key, seq, frame_type=2, refresh=0x01),
                                            (mt.show_existing_frame(0),)],
        "intra_only_refreshing_every_slot": [_intra_only_all(key, seq)],
    }[case]
    data = mt.avif_frames(a, frames)
    assert _as_pil(data) is None
    want = pil_rgb(b if case in ("hidden_key_intra_only", "two_hidden_existing_second") else a)
    if case == "hidden_unshowable_existing" and grain:  # a frame not showable carries no grain to show
        assert not np.array_equal(codecs.rgb8(data), want)
    else:
        np.testing.assert_array_equal(codecs.rgb8(data), want)


@needs_encoder
@pytest.mark.parametrize("case", ["shown_then_junk", "shown_then_cut_obu", "shown_then_cut_tiles",
                                  "shown_then_hidden_cut_tiles", "existing_then_cut_tiles", "shown_then_bad_header",
                                  "intra_only_existing_empty_after"])
def test_failure_after_the_shown_frame_fails_as_pil(case):
    """dav1d decodes every frame of the item: a failure after the shown
    frame (junk, an OBU running past the data, tiles cut short, a frame
    header that cannot be read, a show_existing_frame of an empty slot)
    fails the item as PIL fails it."""
    a, seq, key, second, _ = _frame_parts(grain=False)
    cut = second[:len(second) - 20]
    frames = {
        "shown_then_junk": ([key], b"\xff\x00junk"),
        "shown_then_cut_obu": ([key, (mt.obu(av1_obu.OBU_FRAME, second)[:40],)], b""),
        "shown_then_cut_tiles": ([key, cut], b""),
        "shown_then_hidden_cut_tiles": ([key, mt.key_frame_as(cut, seq, show_frame=0, refresh=0x02)], b""),
        "existing_then_cut_tiles": ([mt.key_frame_as(key, seq, show_frame=0, refresh=0x01),
                                     (mt.show_existing_frame(0),), cut], b""),
        "shown_then_bad_header": ([key, (mt.obu(av1_obu.OBU_FRAME_HEADER, b"\x12\x34\x56"),)], b""),
        "intra_only_existing_empty_after": ([mt.key_frame_as(key, seq, frame_type=2, refresh=0x01),
                                             (mt.show_existing_frame(5),)], b""),
    }[case]
    assert _as_pil(mt.avif_frames(a, *frames)) == COLOR_FAILED


@needs_encoder
@pytest.mark.parametrize("depth", [10, 12])
def test_hidden_key_frame_at_high_depth(depth):
    """A hidden key frame with film grain shown by show_existing_frame, and
    one followed by a shown intra-only frame, at 10 and 12 bits."""
    a, seq, key, second, b = _frame_parts(depth)
    for frames, want in (([mt.key_frame_as(key, seq, show_frame=0, refresh=0x80), (mt.show_existing_frame(7),)], a),
                         ([mt.key_frame_as(key, seq, show_frame=0, refresh=0x80),
                           mt.key_frame_as(second, seq, frame_type=2, refresh=0x01)], b)):
        data = mt.avif_frames(a, frames)
        assert _as_pil(data) is None
        np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(want))


STEP6_FRAMES = ["avif_hidden_key_shown.avif", "avif10_hidden_key_intra_only.avif", "avif_shown_then_more.avif"]


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
@pytest.mark.parametrize("name", STEP6_FRAMES)
def test_frame_fixtures(name):
    """The committed fixtures: more than one frame in the item, the first
    hidden or shown as named; planes equal to dav1d's, RGB to PIL's."""
    data = _fixture(name)
    obus, _ = avif.parse(data)
    kinds = [k for k, _ in av1_obu.split_obus(obus) if k in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER)]
    assert len(kinds) >= 2
    assert _as_pil(data) is None


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
def test_inter_frame_shown_first_raises_a1():
    """A hidden key frame then PIL's sequence's inter frame, shown first,
    which aom at PIL's settings writes with AVIF step 8's motion-field
    projection. PIL reads it; the port raises A.1 naming that tool, and the
    same inter frame after a shown frame raises it too (AVIF step 7 decodes
    the inter frames without it: test_torch_codecs_avif_inter.py)."""
    from torch_fixtures.make_textures import AVIF_RAISES

    with open(f"{AVIF_RAISES}/avif_inter_shown_first.avif", "rb") as f:
        data = f.read()
    assert pil_rgb(data).shape == (32, 48, 3)
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*step 8.*ROADMAP A.1"):
        codecs.rgb8(data)
    seq_file = mt._sequence(enc, (40, 41))
    seq, key = mt.frame_payload(seq_file)
    after = mt.avif_frames(seq_file, [key, (mt.avif_track_samples(seq_file)[1],)])
    assert pil_rgb(after).shape == (32, 48, 3)
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*A.1"):
        codecs.rgb8(after)
