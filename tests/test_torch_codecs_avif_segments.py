"""Port parity, AVIF step 5's AV1 segmentation (io/codecs/av1_obu.py's
segmentation_params and CodedLossless; csrc/host/av1_dec.cpp's segment ids,
each segment's qindex, Lossless and loop filter level, the skip feature),
and ROADMAP C.17 (a first frame with nothing before it to refer to).

- Each segmentation fixture of tests/torch_fixtures/textures carries the
  tools it stands for, read from its headers, and its RGB equals PIL's
  `convert("RGB")` (its planes equal dav1d's in
  test_torch_codecs_avif_planes.py).
- A seeded sweep encoded here at 64 x 64 to 96 x 80: aom's good-quality
  usage with variance AQ (`aq-mode` 1: SEG_LVL_ALT_Q on eight segments) at
  8, 10 and 12 bits, in each layout, at speeds 4 and 6; planes equal to
  dav1d's, RGB equal to PIL's.
- What aom does not write, by header edits of such a still (its
  segmentation_params rewritten, the tile data left as coded): alt LF in
  each of its four slots (on loop filter levels set in the same edit:
  aom's good-quality stills filter nothing), the skip feature, the reference and global-MV
  features (which read the segment id before skip), lossless segments
  (qindex 0: the WHT and 4x4 transforms in a frame that is not lossless),
  alt Q values clipped at +-255, fewer active segments, segmentation on
  with no feature, and off. Each decodes equal to dav1d and PIL.
- Where the specification and dav1d part: an id read past the last active
  segment is clipped to it by the specification and taken as 0 by dav1d,
  and with no feature enabled the specification's LastActiveSegId is 0
  where dav1d keeps -1 (every id read kept). A build of the tile decoder
  with the specification's rule decodes those edits unlike dav1d; the
  port, built with dav1d's, equals it.
- C.17: show_existing_frame, or an inter or switch frame_type, flipped
  into the first frame of a still fails as PIL fails ("Decoding of color
  planes failed"), at each depth.

The oracle cases skip where PIL ships no libavif, the encodes where OpenCV
ships none.
"""
import functools
import subprocess

import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
from optixpathtracer_tpu_torch.utils import host_build
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_codecs_avif_tools import _fixture, _headers, _rebuild_frame_header
from torch_codec_encoders import pil_rgb, yuv_photo
from torch_fixtures.make_textures import COLOR_FAILED, avif_frame_bit_flipped

needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")
AQ = {"aq-mode": 1}


def _features(h: dict) -> dict:
    """{(segment, feature): value} of the enabled segmentation features."""
    return {(i, j): h["seg_feature_data"][i][j] for i in range(8) for j in range(8) if h["seg_feature_enabled"][i][j]}


def _tools(data: bytes) -> tuple:
    seq, h = _headers(data)
    layout = "400" if seq["mono"] else {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[seq["ss"]]
    alt_q = sorted({v for (_, j), v in _features(h).items() if j == 0})
    return (seq["bit_depth"], layout, seq["reduced"], h["segmentation_enabled"], h["last_active_seg_id"],
            h["seg_id_pre_skip"], len(alt_q), h["using_qmatrix"], h["delta_q_present"])


# fixture -> (depth, layout, reduced still-picture header, segmentation, LastActiveSegId, SegIdPreSkip,
#             distinct alt Q values, quantizer matrices, delta q)
STEP5 = {
    "avif_seg_420.avif": (8, "420", 0, 1, 7, 0, 8, 0, 0),
    "avif10_seg_444.avif": (10, "444", 0, 1, 7, 0, 8, 0, 0),
    "avif12_seg_400.avif": (12, "400", 0, 1, 7, 0, 8, 0, 0),
    "avif10_seg_qm_420.avif": (10, "420", 0, 1, 7, 0, 8, 1, 0),
    "avif_seg_deltaq_128.avif": (8, "420", 0, 1, 7, 0, 8, 0, 1),
    "avif_seg_rgba.avif": (8, "420", 0, 1, 7, 0, 8, 0, 0),
}


@pytest.mark.parametrize("name", list(STEP5))
def test_fixture_uses_segmentation(name):
    data = _fixture(name)
    assert _tools(data) == STEP5[name]
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


def test_rgba_fixture_segments_its_alpha_too():
    """The RGBA fixture's alpha item is coded with variance AQ as well."""
    seq, h = _headers(_fixture("avif_seg_rgba.avif"), alpha=True)
    assert seq["mono"] and h["segmentation_enabled"] and len(_features(h)) == 8


def _check(data: bytes) -> None:
    _assert_planes_equal(data)
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


@needs_encoder
@pytest.mark.parametrize("speed", [4, 6])
@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_variance_aq_sweep(depth, fmt, speed):
    rng = np.random.default_rng(depth * 100 + fmt * 10 + speed)
    h, w = (64, 64) if fmt in (2, 3) else (int(rng.choice([64, 80])), int(rng.choice([72, 96])))
    data = oracle.encode_hbd(yuv_photo(h, w, depth + fmt + speed, depth, fmt), depth, fmt, speed=speed,
                             quality=int(rng.choice([40, 50, 60])), single=False, options=AQ)
    hdr = _headers(data)[1]
    assert hdr["segmentation_enabled"] and hdr["last_active_seg_id"] == 7
    _check(data)


def _segmentation_bits(features) -> list:
    """segmentation_params for {(segment, feature): value}, None for
    segmentation_enabled 0."""
    if features is None:
        return [0]
    out = [1]
    for i in range(8):
        for j in range(8):
            out.append(int((i, j) in features))
            if (i, j) in features:
                n = av1_obu.SEG_FEATURE_BITS[j] + av1_obu.SEG_FEATURE_SIGNED[j]
                out += [(features[(i, j)] >> (n - 1 - k)) & 1 for k in range(n)]
    return out


def _six(v: int) -> list:
    return [(v >> (5 - k)) & 1 for k in range(6)]


def _with_segmentation(data: bytes, features, monkeypatch, lf_levels=None) -> bytes:
    """The still with its segmentation_params rewritten (the rest of the
    frame header and the tile data as they were), and where `lf_levels`
    (Y vertical, Y horizontal[, U, V]) is given, its loop filter levels,
    which aom's good-quality stills leave at 0 (no U / V level for 4:0:0)."""
    where = {}
    parse = av1_obu.segmentation_params

    def spy(b, h):
        where["start"] = b.bit
        parse(b, h)
        where["end"] = b.bit

    def edit(bits, log, h):
        rest = bits[where["end"]:]
        if lf_levels is not None:
            assert h["lf_level"][:2] == [0, 0]  # loop_filter_level[0] and [1] read, [2] and [3] not
            at = next(p for p, n, _ in log if n == 6 and p >= where["end"]) - where["end"]
            rest = rest[:at] + sum((_six(v) for v in lf_levels), []) + rest[at + 12:]
        return bits[:where["start"]] + _segmentation_bits(features) + rest
    with monkeypatch.context() as m:
        m.setattr(av1_obu, "segmentation_params", spy)
        return _rebuild_frame_header(data, edit)


@functools.lru_cache(maxsize=None)
def _aq_still(depth: int, fmt: int) -> bytes:
    return oracle.encode_hbd(yuv_photo(96, 96, 5 + depth, depth, fmt), depth, fmt, quality=50, single=False,
                             options=AQ)


def _edit(name: str, base: dict, base_q_idx: int):
    """The features of header edit `name` from the encoder's `base`."""
    f = dict(base)
    if name.startswith("alt_lf"):
        f.update({(s, int(name[-1])): v for s, v in ((0, 20), (3, -30), (5, 63), (7, -63))})
    elif name == "skip":
        f[(2, 6)] = 0
    elif name == "ref_frame":
        f[(1, 5)] = 3
    elif name == "global_mv":
        f[(4, 7)] = 0
    elif name == "lossless_segments":
        f.update({(s, 0): -base_q_idx for s in (0, 2, 4, 6)})
    elif name == "alt_q_clipped":
        f[(6, 0)], f[(1, 0)] = 255, -256
    elif name == "last_active_4":
        f = {k: v for k, v in f.items() if k[0] <= 4}
    elif name == "last_active_0":
        f = {k: v for k, v in f.items() if k[0] == 0}
    elif name == "no_feature":
        f = {}
    elif name == "off":
        f = None
    return f


EDITS = ["alt_lf1", "alt_lf2", "alt_lf3", "alt_lf4", "skip", "ref_frame", "global_mv", "lossless_segments",
         "alt_q_clipped", "last_active_4", "last_active_0", "no_feature", "off"]


@needs_encoder
@pytest.mark.parametrize("edit", EDITS)
@pytest.mark.parametrize("depth,fmt", [(8, 3), (10, 1), (12, 4)])
def test_segmentation_features_by_header_edit(depth, fmt, edit, monkeypatch):
    data = _aq_still(depth, fmt)
    base = _headers(data)[1]
    # the alt LF features on loop filter levels of the frame's own (U's, V's 0: unfiltered whatever the
    # segment adds, as dav1d has it)
    levels = None if not edit.startswith("alt_lf") else (20, 34) if fmt == 4 else (20, 34, 12, 0)
    edited = _with_segmentation(data, _edit(edit, _features(base), base["base_q_idx"]), monkeypatch, levels)
    h = _headers(edited)[1]
    if edit == "off":
        assert not h["segmentation_enabled"]
    elif edit in ("skip", "ref_frame", "global_mv"):
        assert h["seg_id_pre_skip"] == 1
    elif edit == "lossless_segments":
        assert [av1_obu.get_qidx(h, i) == 0 for i in range(8)] == [True, False] * 4 and not h["coded_lossless"]
    elif edit == "alt_q_clipped":
        assert h["seg_feature_data"][6][0] == 255 and h["seg_feature_data"][1][0] == -255
    elif edit.startswith("last_active") or edit == "no_feature":
        assert h["last_active_seg_id"] == {"last_active_4": 4, "last_active_0": 0, "no_feature": -1}[edit]
    else:
        assert h["seg_feature_enabled"][7][int(edit[-1])] and h["lf_level"][:2] == [20, 34]
    _check(edited)


SPEC_RULE = ("    uint8_t id = (uint8_t)neg_deinterleave(diff, pred, P.LastActiveSegId + 1);\n"
             "    if ((unsigned)id > (unsigned)P.LastActiveSegId) id = 0;\n"
             "    if (id >= MAX_SEGMENTS) id = 0;\n"
             "    segment_id = id;\n",
             "    int last = P.LastActiveSegId < 0 ? 0 : P.LastActiveSegId;\n"
             "    segment_id = clip3(0, last, neg_deinterleave(diff, pred, last + 1));\n")


@needs_encoder
def test_dav1d_rule_where_the_specification_parts(tmp_path, monkeypatch):
    """The tile decoder built with the specification's segment-id rule
    (Clip3 to LastActiveSegId, which is 0 with no feature enabled) decodes
    the edits with fewer active segments and with no feature unlike dav1d;
    the port's own build (dav1d's rule) equals dav1d on them."""
    import ctypes

    data = _aq_still(8, 3)
    base = _features(_headers(data)[1])
    edits = {name: _with_segmentation(data, _edit(name, base, 0), monkeypatch)
             for name in ("last_active_4", "no_feature")}
    for edited in edits.values():
        _check(edited)
    src = (host_build.SRC_DIR / "av1_dec.cpp").read_text()
    assert SPEC_RULE[0] in src
    (tmp_path / "av1_dec.cpp").write_text(src.replace(*SPEC_RULE))
    (tmp_path / "av1_tables.h").write_text((host_build.SRC_DIR / "av1_tables.h").read_text())
    subprocess.run(["g++", *host_build.GXX_FLAGS, "-o", str(tmp_path / "spec.so"), str(tmp_path / "av1_dec.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "spec.so"))
    fn = lib.av1_decode_frame
    fn.argtypes = av1_obu._native()[0].argtypes
    fn.restype = ctypes.c_int
    monkeypatch.setattr(av1_obu, "_SIG", (fn, lib.av1_param_count()))
    for name, edited in edits.items():
        _, want = oracle.planes(edited)
        assert not np.array_equal(av1_obu.decode(avif.parse(edited)[0])[0], want[0]), name


@needs_encoder
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("flip", ["show_existing_frame", "inter", "switch"])
def test_first_frame_with_nothing_before_it_fails_as_pil(depth, flip):
    """C.17: a good-quality still (a full frame header) with
    show_existing_frame set, or frame_type made INTER_FRAME (1) or
    SWITCH_FRAME (3): no frame fills the slot it names, dav1d fails it and
    PIL raises libavif's reason; the port raises the same reason (its
    DecodeError, as for C.14) and no A.1."""
    data = oracle.encode_hbd(yuv_photo(48, 64, 20 + depth, depth, 3), depth, 3, single=False)
    assert _headers(data)[0]["reduced"] == 0
    bits = {"show_existing_frame": [0], "inter": [2], "switch": [1, 2]}[flip]
    for bit in bits:
        data = avif_frame_bit_flipped(data, bit)
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == COLOR_FAILED


def test_tile_list_obus_are_skipped():
    """A tile list OBU (type 8) in the item is skipped, as dav1d skips it:
    the still decodes as PIL decodes it (no A.1)."""
    from torch_codec_encoders import avif_still
    from torch_fixtures.make_textures import avif_parts

    data = _fixture("avif_seg_420.avif")
    obus, av1c, colr = avif_parts(data)
    tile_list = bytes([8 << 3 | 2, 6]) + bytes(6)
    for at in (0, len(obus)):
        edited = avif_still(obus[:at] + tile_list + obus[at:], (96, 96), av1c, colr=colr)
        assert avif.parse(edited)[0].count(tile_list) == 1
        np.testing.assert_array_equal(codecs.rgb8(edited), pil_rgb(edited))
