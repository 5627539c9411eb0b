"""Port parity, AVIF step 7: AV1 inter frames with single references and
translational motion (io/codecs/av1_obu.py's inter frame header and
reference store, csrc/host/av1_dec.cpp's inter mode info, MV prediction and
sub-pixel prediction), decoded as dav1d decodes them.

- Each step-7 fixture (make_textures.STEP7: a hidden key frame, then an
  image sequence's inter frames as aom writes them with the tools of steps
  8 and 9 off) reads the header the fixture stands for: inter frames
  without a primary reference frame, OBMC, motion-field projection, global
  motion or compound prediction, a fixed or switchable filter, references
  in the past and the future; its planes equal dav1d's and, through
  `load_image`, its RGB equals PIL's and the JAX loader's.
- Together the fixtures reach NEWMV, NEARESTMV and NEARMV blocks,
  fractional and 1/8-sample vectors on both axes, intra blocks in inter
  frames, var-tx splits, vectors past the frame's edge, sub-8x8 inter
  blocks with subsampled chroma and more than one per-block filter.
- Film grain: the reference slots keep each frame before its grain (spec
  7.20); a store of grained frames does not decode the inter frames as
  dav1d does.
- A sequence's inter frames after the first, predicting from an inter
  frame in the store, each equal to PIL's read of that frame of the track.
- The frame after the shown one is decoded as dav1d decodes it; each inter
  tool of steps 8 and 9 an encoder here writes raises A.1 naming it, and
  no tile of its frame is decoded; a failure of the stream after it fails
  as PIL fails.
- set_frame_refs (short signaling) and skip_mode_params on hand-made
  slots, against the specification's rules.

Skips where PIL ships no libavif, the sequence encodes where OpenCV ships
none.
"""
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

import torch_avif_oracle as oracle
import torch_codec_encoders as enc
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
from test_torch_codecs_avif_planes import _assert_planes_equal
from torch_codec_encoders import assert_like_pil, avif_still, pil_rgb
from torch_fixtures import make_textures as mt
from torch_fixtures.make_textures import AVIF_RAISES, AVIF_RAISES_EXPECTED, OUT, STEP7, avif_inter_item, inter_sequence

needs_oracle = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")
FIXTURES = sorted(STEP7) + ["avif_inter_after_shown.avif"]
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
# Max_Tx_Size_Rect of each block size (BLOCK_4X4 .. BLOCK_64X16), TX_* numbers
MAX_TX_RECT = [0, 5, 6, 1, 7, 8, 2, 9, 10, 3, 11, 12, 4, 4, 4, 4, 13, 14, 15, 16, 17, 18]
SUB8X8 = [0, 1, 2, 16, 17]  # BLOCK_4X4, 4X8, 8X4, 4X16, 16X4


def _fixture(name: str) -> bytes:
    with open(os.path.join(OUT, name), "rb") as f:
        return f.read()


def _frames(data: bytes) -> list:
    frames = []
    av1_obu.decode(avif.parse(data)[0], frames)
    return frames


@pytest.mark.parametrize("name", FIXTURES)
def test_inter_headers_read_as_the_fixture_says(name):
    """The item's frames: a key frame (hidden, or shown for the frame after
    the shown one), then inter frames as aom writes them with the tools of
    steps 8 and 9 off: no primary reference frame (default CDFs),
    is_motion_mode_switchable, use_ref_frame_mvs, reference_select,
    skip_mode_present 0, no global motion, no segmentation; 1/8-sample
    vectors allowed but at 1024 x 1024, where aom turns them off; a switchable filter at speed 0, EIGHTTAP at speed 6; the
    ALTREF item's hidden inter frame, then the shown frame with a
    reference in the future (sign bias 1)."""
    headers = av1_obu.frame_headers(avif.parse(_fixture(name))[0])
    key, inter = headers[0], headers[1:]
    assert key["frame_type"] == av1_obu.KEY_FRAME and key["show_frame"] == (name == "avif_inter_after_shown.avif")
    assert [h["frame_type"] for h in inter] == [av1_obu.INTER_FRAME] * len(inter)
    for h in inter:
        assert h["primary_ref_frame"] == av1_obu.PRIMARY_REF_NONE
        assert (h["is_motion_mode_switchable"], h["use_ref_frame_mvs"], h["reference_select"],
                h["skip_mode_present"], h["segmentation_enabled"]) == (0, 0, 0, 0, 0)
        assert h["gm_type"] == [0] * 8 and h["force_integer_mv"] == 0
        assert h["allow_high_precision_mv"] == int(name != "avif_inter_1024.avif")
        assert h["interpolation_filter"] == (av1_obu.SWITCHABLE if "speed0" in name else 0)
    arf = "_arf_" in name
    assert [h["show_frame"] for h in inter] == ([0, 1] if arf else [1])
    assert max(inter[-1]["ref_frame_sign_bias"]) == int(arf)
    grain = [h["grain"]["apply_grain"] for h in headers]
    assert grain == ([1] * len(headers) if "grain" in name or "denoise" in name else [0] * len(headers))


@needs_oracle
@pytest.mark.parametrize("name", FIXTURES)
def test_inter_fixture_as_dav1d_and_pil(name, tmp_path):
    """Planes equal to dav1d's; `load_image` equal to PIL's convert("RGB")
    and to the JAX package's loader."""
    data = _fixture(name)
    _assert_planes_equal(data)
    assert_like_pil(data, tmp_path, "t.avif")


def test_block_types_the_fixtures_reach():
    """What the tile decoder's inter paths meet in the fixtures' inter
    frames (read from each frame's per-4x4 mode info): NEWMV, NEARESTMV and
    NEARMV blocks (aom writes no GLOBALMV here), vectors with a fractional
    part on each axis and of 1/8 sample, intra blocks, var-tx splits of
    inter blocks, vectors whose 8-tap footprint reaches past the frame's
    edge, blocks predicting from a future reference, inter blocks under
    8 x 8 with subsampled chroma (predicted from each luma block's vector),
    and a switchable filter that picks more than one filter."""
    seen = {k: 0 for k in ("new", "nearest", "near", "frac_row", "frac_col", "eighth", "intra", "split", "edge",
                           "future_ref", "small_subsampled")}
    filters = set()
    for name in FIXTURES:
        for f in _frames(_fixture(name)):
            if f["frame_type"] != av1_obu.INTER_FRAME:
                continue
            m = f["mode_info"].astype(np.int64)
            rows, cols = np.mgrid[0:m.shape[0], 0:m.shape[1]]
            on = (rows * 4 < f["height"]) & (cols * 4 < f["upscaled_width"])
            ref, mv_r, mv_c, mode, tx, size, filt = (m[..., i][on] for i in range(av1_obu.MODE_INFO_FIELDS))
            inter = ref > 0
            seen["new"] += (mode == NEWMV).sum()
            seen["nearest"] += (mode == NEARESTMV).sum()
            seen["near"] += (mode == NEARMV).sum()
            seen["frac_row"] += (inter & (mv_r % 8 != 0)).sum()
            seen["frac_col"] += (inter & (mv_c % 8 != 0)).sum()
            seen["eighth"] += (inter & ((mv_r | mv_c) % 2 != 0)).sum()
            seen["intra"] += (~inter).sum()
            seen["split"] += (inter & (tx != np.take(MAX_TX_RECT, size))).sum()
            y0, x0 = rows[on] * 4 + (mv_r >> 3) - 3, cols[on] * 4 + (mv_c >> 3) - 3
            seen["edge"] += (inter & ((y0 < 0) | (x0 < 0) | (y0 + 11 >= f["height"]) |
                                      (x0 + 11 >= f["upscaled_width"]))).sum()
            if f["seq"]["ss"] != (0, 0) and not f["seq"]["mono"]:
                seen["small_subsampled"] += (inter & np.isin(size, SUB8X8)).sum()
            sign = np.take(f["hdr"]["ref_frame_sign_bias"], ref)
            seen["future_ref"] += (inter & (sign == 1)).sum()
            if f["hdr"]["interpolation_filter"] == av1_obu.SWITCHABLE:
                filters |= set(filt[inter].tolist())
    assert all(seen.values()), seen
    assert len(filters) > 1, filters


def _grained_store(monkeypatch):
    """Reference slots that keep each hidden frame after its film grain."""
    decode_frame = av1_obu._decode_frame

    def grained(seq, hdr, tiles, slots):
        frame = decode_frame(seq, hdr, tiles, slots)
        if not hdr["show_frame"]:
            frame = dict(frame, planes=av1_obu._with_grain(frame)[:3])
        return frame
    monkeypatch.setattr(av1_obu, "_decode_frame", grained)


@needs_oracle
@pytest.mark.parametrize("name", ["avif_inter_grain_420.avif", "avif_inter_denoise_420.avif"])
def test_references_are_kept_before_film_grain(name, monkeypatch):
    """aom's grain (test vector 1, and its denoiser's estimate) on the
    hidden key frame and the inter frame: the port's store of un-grained
    frames decodes the inter frame equal to dav1d; a store holding the key
    frame after its grain does not."""
    data = _fixture(name)
    _, want = oracle.planes(data)
    obus = avif.parse(data)[0]
    assert all(h["grain"]["apply_grain"] for h in av1_obu.frame_headers(obus))
    for got, ref in zip(av1_obu.decode(obus), want):
        np.testing.assert_array_equal(got, ref)
    _grained_store(monkeypatch)
    assert not any(np.array_equal(got, ref) for got, ref in zip(av1_obu.decode(obus), want))


@needs_oracle
def test_frame_after_the_shown_one_is_decoded():
    """A shown key frame, then an inter frame: dav1d decodes both and
    shows the first; the port decodes the inter frame too (predicting from
    the key frame), and shows the key frame as dav1d does."""
    data = _fixture("avif_inter_after_shown.avif")
    frames = _frames(data)
    assert [f["frame_type"] for f in frames] == [av1_obu.KEY_FRAME, av1_obu.INTER_FRAME]
    assert (frames[1]["mode_info"][..., 0] > 0).any()
    _, want = oracle.planes(data)
    np.testing.assert_array_equal(frames[0]["planes"][0], want[0])
    np.testing.assert_array_equal(av1_obu.decode(avif.parse(data)[0])[0], want[0])


with open(AVIF_RAISES_EXPECTED) as f:
    INTER_REFUSALS = {n: e for n, e in json.load(f).items() if n.startswith("avif_inter_")
                      and e["raises"] == "NotImplementedError"}


@needs_oracle
@pytest.mark.parametrize("name", sorted(INTER_REFUSALS))
def test_inter_tools_of_later_steps_raise_before_their_tiles(name, monkeypatch):
    """Each inter tool of steps 8 and 9 that aom writes here (PIL's own
    sequence: motion-field projection; OBMC; global motion; compound
    prediction; CDFs loaded from a reference) in an item PIL reads: the
    port raises A.1 naming the tool and its step, and decodes no tile of
    that frame; the frames before it decode."""
    with open(os.path.join(AVIF_RAISES, name), "rb") as f:
        data = f.read()
    pil_rgb(data)
    decoded = []
    decode_frame = av1_obu._decode_frame

    def spy(seq, hdr, tiles, slots):
        decoded.append(hdr)
        return decode_frame(seq, hdr, tiles, slots)
    monkeypatch.setattr(av1_obu, "_decode_frame", spy)
    obus = avif.parse(data)[0]
    with pytest.raises(NotImplementedError, match=INTER_REFUSALS[name]["match"]) as e:
        av1_obu.decode(obus)
    seq = av1_obu.sequence_header(next(p for k, p in av1_obu.split_obus(obus) if k == av1_obu.OBU_SEQUENCE_HEADER))
    slots = [None] * av1_obu.NUM_REF_FRAMES
    for first, h in enumerate(av1_obu.frame_headers(obus)):
        if av1_obu.inter_unported(seq, h, slots):
            break
        av1_obu.refresh(slots, h, av1_obu._slot(seq, h))
    assert first > 0 and len(decoded) == first and "AVIF of AV1 " in str(e.value)


@needs_oracle
@pytest.mark.parametrize("name", sorted(INTER_REFUSALS))
def test_a_failure_after_a_refused_frame_fails_as_pil(name):
    """The refused items with a frame header cut after its first byte
    after their frames: dav1d fails the stream and PIL raises its message;
    the port reads the OBUs past the frame it does not decode and fails as
    PIL does, not with A.1."""
    with open(os.path.join(AVIF_RAISES, name), "rb") as f:
        refused = f.read()
    obus, av1c, colr = mt.avif_parts(refused)
    cut = mt.obu(av1_obu.OBU_FRAME_HEADER, b"\x10")  # an inter frame's header, read past its byte
    data = avif_still(obus + cut, avif._ispe(refused, *mt._primary(refused)), av1c, colr=colr)
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == mt.COLOR_FAILED


def _nth_shown(monkeypatch, n: int):
    """av1_obu.decode made to return the item's n-th shown frame (from 1),
    with its grain, in place of its first."""
    decode = av1_obu.decode

    def nth(obus, frames=None):
        decoded = []
        decode(obus, decoded)
        return av1_obu._with_grain([f for f in decoded if f["hdr"]["show_frame"]][n - 1])
    monkeypatch.setattr(av1_obu, "decode", nth)


@needs_encoder
@pytest.mark.parametrize("case", [(8, 3, {}), (10, 1, {"film-grain-test": 6}), (12, 2, {})])
def test_each_inter_frame_of_a_sequence_as_pil(case, monkeypatch):
    """A 3-frame sequence without ALTREF frames (aom's auto-alt-ref off),
    whose third frame predicts from the second, an inter frame, held in
    the port's reference store: each frame the port decodes from the item
    (a hidden key frame and the inter frames up to it) equals frame i of the
    sequence as PIL reads it (seek(i), libavif reading the track)."""
    depth, fmt, options = case
    seq_file = inter_sequence(enc, 72, 56, depth, fmt, 760 + depth, 3, options={"auto-alt-ref": 0, **options})
    im = Image.open(io.BytesIO(seq_file))
    for i in (1, 2):
        item = avif_inter_item(seq_file, i)
        im.seek(i)
        with monkeypatch.context() as m:
            _nth_shown(m, i)
            np.testing.assert_array_equal(codecs.rgb8(item), np.asarray(im.convert("RGB")))
    refs = av1_obu.frame_headers(avif.parse(avif_inter_item(seq_file, 2))[0])[2]["ref_frame_idx"]
    assert any(slot != 0 for slot in refs)  # a slot the first inter frame refreshed


def test_set_frame_refs_as_the_specification_chooses():
    """7.8 on slots of order hints 0, 4, 2, 8, 3, 16, 1, 1 for a frame of
    order hint 5 naming LAST slot 1 and GOLDEN slot 0: ALTREF the latest
    future slot (5), BWDREF the earliest left (3), no ALTREF2 among the
    future ones; LAST2, LAST3 and ALTREF2 the latest past slots left (4,
    then 2, then 7: the later of two equal hints)."""
    seq = {"order_hint_bits": 7}
    slots = [{"order_hint": hint} for hint in (0, 4, 2, 8, 3, 16, 1, 1)]
    assert av1_obu._set_frame_refs(seq, slots, 5, 1, 0) == [1, 4, 2, 0, 3, 7, 5]


@pytest.mark.parametrize("hints, frames", [([4, 4, 2, 0, 8, 8, 16], [1, 5]), ([4, 2, 4, 0, 1, 3, 2], [1, 6]),
                                           ([6, 8, 7, 6, 9, 10, 12], None)])
def test_skip_mode_frames_as_the_specification_chooses(hints, frames):
    """skip_mode_params (5.9.22) for a frame of order hint 5 whose seven
    references have these hints: the nearest past and future references,
    or the two nearest past ones, or no skip mode without a past one."""
    h = {"reference_select": 1, "order_hint": 5, "order_hints": [5] + hints}
    allowed = av1_obu._skip_mode_allowed({"order_hint_bits": 7}, h, [])
    assert allowed == (frames is not None) and h.get("skip_mode_frame") == frames
