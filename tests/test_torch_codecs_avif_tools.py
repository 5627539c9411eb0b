"""Port parity, AVIF step 4: the coding tools aom writes into stills (film
grain synthesis, quantizer matrices, delta q and delta lf) at 8, 10 and 12
bits, decoded by the port (io/codecs/av1_obu.py's headers, the tile decoder
and film grain of csrc/host/av1_dec.cpp) as PIL decodes them.

- Each step-4 fixture of tests/torch_fixtures/textures carries the tools it
  stands for (read from its headers: depth, layout, the grain's AR lag,
  overlap, chroma from luma, clip and scaling points, the quantizer matrix
  levels, delta q / delta lf / delta_lf_multi, alpha) and its RGB equals
  PIL's `convert("RGB")`; its planes equal dav1d's in
  test_torch_codecs_avif_planes.py.
- A seeded sweep encoded here at 96 x 64 or less: all 16 of aom's
  film-grain-test vectors across the four layouts, qm-min = qm-max = L for
  every L in 0-15, delta q and delta lf, and each tool at 10 and 12 bits,
  RGB and RGBA: Y / U / V and alpha planes equal to dav1d's (grain
  applied), RGB equal to PIL's.
- aom grain tables (`film-grain-table`): AR lags 0-3, no luma points,
  chroma from luma, overlap off, Cb / Cr multipliers and offsets, at 8, 10
  and 12 bits.
- Header edits, each decoded as PIL decodes it: clip_to_restricted_range
  set (no encoder sets it), and at 10 and 12 bits on an identity-matrix
  4:4:4 still, whose chroma clips at 235 like its luma (planes against
  dav1d, its RGB, of matrix 0, equal to PIL's);
  delta_lf_multi set (no encoder writes it); and the loop filter's deltas
  turned off with the frame's level lowered, so that blocks of level 0
  take the previous block's level (7.14.2), which no aom still needs (its
  intra reference delta keeps every level above 0).
- A glTF whose texture is an AVIF with grain and quantizer matrices loads
  as the JAX loader loads it.

The oracle cases skip where PIL ships no libavif, the high-depth ones where
OpenCV ships none.
"""
import functools
import os

import numpy as np
import pytest
from PIL import Image

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
from test_torch_codecs_avif import _properties, mux
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_obj_gltf import _assert_same_gltf, _textured_glb
from torch_codec_encoders import photo, pil_bytes, pil_rgb, yuv_photo
from torch_fixtures.make_textures import OUT, aom_grain_table, avif_grain_clipped, with_grain_table

needs_oracle = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")
LAYOUTS = ("4:4:4", "4:2:2", "4:2:0", "4:0:0")


def _fixture(name: str) -> bytes:
    with open(os.path.join(OUT, name), "rb") as f:
        return f.read()


def _headers(data: bytes, alpha: bool = False):
    """(sequence header, frame header) of the primary item, or the alpha
    item's."""
    _, _, alpha_obus, _ = avif._parse(data)
    obus = alpha_obus if alpha else avif.parse(data)[0]
    seq = None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
            return seq, av1_obu.frame_header(av1_obu.Bits(payload), seq)
    raise AssertionError("no frame header")


def _tools(data: bytes) -> tuple:
    seq, h = _headers(data)
    g = h["grain"]
    layout = "400" if seq["mono"] else {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[seq["ss"]]
    grain = None if not g["apply_grain"] else (
        g["ar_coeff_lag"], g["overlap_flag"], g["chroma_scaling_from_luma"], g["clip_to_restricted_range"],
        len(g["y_points"]), len(g["cb_points"]), len(g["cr_points"]))
    qm = (h["qm_y"], h["qm_u"], h["qm_v"]) if h["using_qmatrix"] else None
    return (seq["bit_depth"], layout, seq["film_grain_params_present"], grain, qm,
            (h["delta_q_present"], h["delta_lf_present"], h["delta_lf_multi"]), avif._parse(data)[2] is not None)


# fixture -> (depth, layout, film_grain_params_present, grain: (ar_coeff_lag, overlap, chroma from luma,
#             clip, luma / Cb / Cr points) or None, quantizer matrix levels (Y, U, V) or None,
#             (delta q, delta lf, delta_lf_multi), alpha)
NO_DELTA = (0, 0, 0)
STEP4 = {
    "avif_film_grain.avif": (8, "420", 1, None, None, NO_DELTA, False),  # signalled, too few flat blocks to apply
    "avif_qm.avif": (8, "420", 0, None, (9, 9, 9), NO_DELTA, False),
    "avif_grain_test1.avif": (8, "420", 1, (2, 0, 0, 0, 14, 8, 9), None, NO_DELTA, False),
    "avif_grain_test6.avif": (8, "420", 1, (3, 1, 0, 0, 14, 0, 0), None, NO_DELTA, False),
    "avif_grain_test15.avif": (8, "420", 1, (2, 1, 1, 0, 1, 0, 0), None, NO_DELTA, False),
    "avif_grain_test16.avif": (8, "420", 1, (3, 1, 0, 0, 8, 8, 8), None, NO_DELTA, False),
    "avif_grain_lag0.avif": (8, "420", 1, (0, 1, 0, 0, 3, 3, 3), None, NO_DELTA, False),
    "avif_grain_lag1_422.avif": (8, "422", 1, (1, 0, 0, 0, 3, 3, 1), None, NO_DELTA, False),
    "avif_grain_no_luma_444.avif": (8, "444", 1, (2, 1, 0, 0, 0, 3, 3), None, NO_DELTA, False),
    "avif_grain_clipped.avif": (8, "420", 1, (3, 1, 0, 1, 2, 9, 9), None, NO_DELTA, False),
    "avif_grain_37x23_444.avif": (8, "444", 1, (2, 1, 0, 0, 2, 2, 2), None, NO_DELTA, False),
    "avif_grain_37x23_422.avif": (8, "422", 1, (2, 1, 0, 0, 2, 2, 2), None, NO_DELTA, False),
    "avif_grain_37x23_420.avif": (8, "420", 1, (2, 1, 0, 0, 2, 2, 2), None, NO_DELTA, False),
    "avif_grain_37x23_400.avif": (8, "400", 1, (2, 1, 0, 0, 2, 0, 0), None, NO_DELTA, False),
    "avif_grain_estimated_128.avif": (8, "420", 1, (3, 1, 0, 0, 6, 2, 5), None, NO_DELTA, False),
    "avif_qm0.avif": (8, "420", 0, None, (0, 0, 0), NO_DELTA, False),
    "avif_qm13.avif": (8, "444", 0, None, (13, 13, 13), NO_DELTA, False),
    "avif_deltaq_128.avif": (8, "420", 0, None, None, (1, 0, 0), False),
    "avif_deltaq_deltalf_128.avif": (8, "420", 0, None, None, (1, 1, 0), False),
    "avif_tools_rgba_128.avif": (8, "420", 1, (3, 1, 0, 0, 2, 2, 2), (9, 9, 9), (1, 1, 0), True),
    "avif10_grain_422.avif": (10, "422", 1, (3, 1, 0, 0, 2, 9, 9), None, NO_DELTA, False),
    "avif12_grain_444.avif": (12, "444", 1, (3, 1, 0, 0, 8, 8, 8), None, NO_DELTA, False),
    "avif10_qm_420.avif": (10, "420", 0, None, (8, 8, 8), NO_DELTA, False),
    "avif12_qm_400.avif": (12, "400", 0, None, (8, 8, 8), NO_DELTA, False),
    "avif10_deltaq_444_128.avif": (10, "444", 0, None, None, (1, 0, 0), False),
    "avif12_deltaq_420_128.avif": (12, "420", 0, None, None, (1, 0, 0), False),
}


@pytest.mark.parametrize("name", list(STEP4))
def test_fixture_uses_its_tool(name):
    data = _fixture(name)
    assert _tools(data) == STEP4[name]
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


def test_alpha_item_carries_the_tools_too():
    """libavif hands its codec options to the alpha item as well: the RGBA
    fixture's alpha is coded with grain, quantizer matrices, delta q and
    delta lf, and decodes through the same path (its plane equal to
    dav1d's in test_torch_codecs_avif_planes.py)."""
    seq, h = _headers(_fixture("avif_tools_rgba_128.avif"), alpha=True)
    assert seq["mono"] and h["grain"]["apply_grain"] and h["using_qmatrix"] and h["delta_lf_present"]


def _check(data: bytes) -> None:
    _assert_planes_equal(data)
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


@needs_oracle
@pytest.mark.parametrize("vector", range(1, 17))
def test_every_grain_test_vector(vector):
    """aom's film-grain-test vector N on a seeded still, the layout and
    alpha cycling with N, at most 96 x 64."""
    rng = np.random.default_rng(vector)
    h, w = int(rng.integers(17, 65)), int(rng.integers(17, 97))
    img = photo(h, w, 100 + vector, 4 if vector % 4 == 3 else 3)
    data = pil_bytes(Image.fromarray(img), "AVIF", subsampling=LAYOUTS[vector % 4],
                     advanced={"film-grain-test": str(vector)})
    assert _headers(data)[1]["grain"]["apply_grain"]
    _check(data)


@needs_oracle
@pytest.mark.parametrize("level", range(16))
def test_every_quantizer_matrix_level(level):
    """qm-min = qm-max = L, the layout and quality cycling: level 15 is the
    flat matrix (written, and scaling nothing)."""
    rng = np.random.default_rng(200 + level)
    h, w = int(rng.integers(24, 65)), int(rng.integers(24, 97))
    data = pil_bytes(photo(h, w, 200 + level), "AVIF", subsampling=LAYOUTS[level % 4],
                     quality=int(rng.choice([30, 55, 80])), speed=int(rng.choice([2, 6, 9])),
                     advanced={"enable-qm": "1", "qm-min": str(level), "qm-max": str(level)})
    assert _headers(data)[1]["qm_y"] == level
    _check(data)


@needs_oracle
@pytest.mark.parametrize("quality,layout,delta_lf", [(50, "4:2:0", 0), (75, "4:4:4", 1), (85, "4:2:2", 1),
                                                     (60, "4:0:0", 1)])
def test_delta_q_and_delta_lf(quality, layout, delta_lf):
    """deltaq-mode 2 (and delta-lf-mode 1) at 96 x 64."""
    advanced = {"deltaq-mode": "2", **({"delta-lf-mode": "1"} if delta_lf else {})}
    data = pil_bytes(photo(64, 96, 300 + quality), "AVIF", quality=quality, subsampling=layout, advanced=advanced)
    h = _headers(data)[1]
    assert (h["delta_q_present"], h["delta_lf_present"]) == (1, delta_lf)
    _check(data)


@needs_oracle
@pytest.mark.parametrize("quality", [50, 70])
def test_delta_q_resets_at_each_tile(quality):
    """Each tile starts from base_q_idx and no loop filter deltas (2 x 2
    tiles)."""
    data = pil_bytes(photo(200, 260, 7), "AVIF", quality=quality, speed=6, tile_rows=1, tile_cols=1,
                     advanced={"deltaq-mode": "2", "delta-lf-mode": "1"})
    h = _headers(data)[1]
    assert len(h["mi_col_starts"]) == len(h["mi_row_starts"]) == 3 and h["delta_lf_present"]
    _check(data)


HBD_TOOLS = {"grain": {"film-grain-test": 11}, "qm": {"enable-qm": 1, "qm-min": 1, "qm-max": 12},
             "deltaq": {"deltaq-mode": 3, "delta-lf-mode": 1}}


@needs_encoder
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("tool", list(HBD_TOOLS))
def test_every_tool_at_high_depth(depth, tool):
    """Each tool at 10 and 12 bits, 96 x 64, a layout of its own, with
    alpha (coded with the tool too)."""
    fmt = {"grain": 2, "qm": 1, "deltaq": 3}[tool] + (depth == 12)
    planes = yuv_photo(64, 96, 400 + depth + fmt, depth, fmt)
    alpha = yuv_photo(64, 96, 450 + depth, depth, 4)[0]
    data = oracle.encode_hbd(planes, depth, fmt, alpha=alpha, quality=70, options=HBD_TOOLS[tool])
    seq, h = _headers(data)
    assert seq["bit_depth"] == depth
    assert {"grain": h["grain"]["apply_grain"], "qm": h["using_qmatrix"], "deltaq": h["delta_q_present"]}[tool]
    _check(data)


Y_POINTS, C_POINTS = [(0, 20), (90, 60), (255, 40)], [(0, 30), (128, 70), (255, 30)]
TABLES = {  # name -> (layout, aom_grain_table arguments)
    "lag0": ("4:2:0", dict(lag=0, y_points=Y_POINTS, cb_points=C_POINTS, cr_points=C_POINTS, cb=(120, 200, 300))),
    "lag1_overlap_off": ("4:2:2", dict(lag=1, y_points=Y_POINTS, cb_points=C_POINTS, cr_points=[(10, 50)],
                                       overlap=0, shifts=(6, 0, 10), cr=(140, 180, 200))),
    "lag2_no_luma": ("4:4:4", dict(lag=2, y_points=[], cb_points=C_POINTS, cr_points=C_POINTS)),
    "lag3_chroma_from_luma": ("4:2:0", dict(lag=3, y_points=Y_POINTS, cb_points=[], cr_points=[],
                                            chroma_from_luma=1, shifts=(8, 2, 11))),
    "lag2_grey": ("4:0:0", dict(lag=2, y_points=Y_POINTS, cb_points=[], cr_points=[], shifts=(9, 3, 8))),
}
FMT = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}


@needs_oracle
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("name", list(TABLES))
def test_grain_tables(depth, name):
    """aom's grain tables set what its test vectors do not: AR lags 0 and
    1, no luma points (4:4:4), the shifts and multipliers; at each depth on
    an odd size."""
    layout, kw = TABLES[name]
    table = aom_grain_table(coeff_seed=depth, **kw)
    if depth == 8:
        data = with_grain_table(lambda o: pil_bytes(photo(37, 45, 500), "AVIF", subsampling=layout, advanced=o),
                                table)
    else:
        if not oracle.hbd_available():
            pytest.skip("OpenCV ships no libavif here")
        planes = yuv_photo(37, 45, 500 + depth, depth, FMT[layout])
        data = with_grain_table(lambda o: oracle.encode_hbd(planes, depth, FMT[layout], options=o), table)
    g = _headers(data)[1]["grain"]
    assert (g["ar_coeff_lag"], len(g["y_points"]), g["chroma_scaling_from_luma"]) == (
        kw["lag"], len(kw["y_points"]), kw.get("chroma_from_luma", 0))
    _check(data)


@needs_oracle
@pytest.mark.parametrize("vector", [1, 5, 15])
def test_clip_to_restricted_range(vector):
    """clip_to_restricted_range, the frame header's last bit, set on a
    still with grain: samples clipped to 16-235 (luma) and 16-240 (chroma)
    as PIL's decode clips them."""
    data = avif_grain_clipped(pil_bytes(photo(45, 37, 600 + vector), "AVIF",
                                        advanced={"film-grain-test": str(vector)}))
    assert _headers(data)[1]["grain"]["clip_to_restricted_range"] == 1
    _check(data)


@needs_encoder
@pytest.mark.parametrize("depth", [10, 12])
def test_clip_with_the_identity_matrix(depth):
    """On an identity-matrix (sRGB 4:4:4) still the clip takes chroma to
    235, as luma: planes equal to dav1d's, and its RGB (matrix 0, libavif's
    own conversion) equal to PIL's."""
    y, u, v = yuv_photo(45, 67, 9, depth, 1)
    top = (1 << depth) - 1
    u, v = np.maximum(u, top - (u >> 3)), np.maximum(v, top - (v >> 4))  # chroma near the top, where 235 and 240 differ
    data = avif_grain_clipped(oracle.encode_hbd([y, u, v], depth, 1, matrix=0, options={"film-grain-test": "1"}))
    seq, h = _headers(data)
    assert seq["color"][2] == 0 and seq["ss"] == (0, 0) and h["grain"]["clip_to_restricted_range"]
    _check(data)


def _frame_payload_edit(data: bytes, edit) -> bytes:
    """The still with its frame OBU's payload passed through edit(payload,
    sequence header) -> payload of the same length."""
    obus, _ = avif.parse(data)
    seq = None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind == av1_obu.OBU_FRAME:
            new = edit(payload, seq)
            at = data.index(payload)
            return data[:at] + new + data[at + len(payload):]
    raise AssertionError("no frame OBU")


def _with_field_flipped(data: bytes, key: str) -> bytes:
    """The frame header's one bit whose flip changes `key` and nothing
    else of the header, flipped."""
    def edit(payload, seq):
        b = av1_obu.Bits(payload)
        base = av1_obu.frame_header(b, seq)
        for bit in range(b.bit):
            new = bytearray(payload)
            new[bit >> 3] ^= 0x80 >> (bit & 7)
            try:
                h = av1_obu.frame_header(av1_obu.Bits(bytes(new)), seq)
            except Exception:
                continue
            if [k for k in base if h[k] != base[k]] == [key]:
                return bytes(new)
        raise AssertionError(f"no bit sets {key}")
    return _frame_payload_edit(data, edit)


@needs_oracle
@pytest.mark.parametrize("layout", ["4:2:0", "4:0:0"])
def test_delta_lf_multi_as_pil(layout):
    """No encoder here writes delta_lf_multi: set in the header of a still
    with delta lf, each superblock's deltas are read per edge direction and
    plane (FRAME_LF_COUNT, two in 4:0:0) from its symbols, and the file
    decodes as PIL decodes it."""
    data = pil_bytes(photo(128, 128, 700), "AVIF", subsampling=layout,
                     advanced={"deltaq-mode": "2", "delta-lf-mode": "1"})
    flipped = _with_field_flipped(data, "delta_lf_multi")
    assert _headers(flipped)[1]["delta_lf_multi"] == 1
    _check(flipped)


class _LoggedBits(av1_obu.Bits):
    """Bits that log (position, width, value) of each read."""

    def __init__(self, data: bytes, pos: int = 0):
        super().__init__(data, pos)
        self.log = []

    def f(self, n: int) -> int:
        at = self.bit
        value = super().f(n)
        self.log.append((at, n, value))
        return value


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _rebuild_frame_header(data: bytes, edit) -> bytes:
    """The still with its frame header's bits passed through edit(bits,
    log, header) -> bits (log: the header's reads, (position, width,
    value)), byte-aligned again before the same tile data, the frame OBU
    rebuilt and muxed again (test_torch_codecs_avif.mux)."""
    obus, _ = avif.parse(data)
    out, seq = b"", None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        if kind == av1_obu.OBU_FRAME:
            b = _LoggedBits(payload)
            h = av1_obu.frame_header(b, seq)
            bits = edit([(payload[k >> 3] >> (7 - (k & 7))) & 1 for k in range(b.bit)], b.log, h)
            bits += [0] * (-len(bits) % 8)
            head = bytes(int("".join(map(str, bits[k:k + 8])), 2) for k in range(0, len(bits), 8))
            payload = head + payload[(b.bit + 7) // 8:]
        out += bytes([kind << 3 | 2]) + _leb128(len(payload)) + payload
    props = _properties(data)
    return mux(out, [props[k] for k in (b"ispe", b"pixi", b"av1C", b"colr")])


def _lf_deltas_off(bits: list, log: list, h: dict, level0: int) -> list:
    """loop_filter_delta_enabled 0 (its delta_update bit, 0, gone) and
    loop_filter_level[0] = level0."""
    l0, l1 = h["lf_level"][:2]
    i = next(i for i in range(len(log) - 1) if log[i][1:] == (6, l0) and log[i + 1][1:] == (6, l1)
             and log[i + 1][0] == log[i][0] + 6)
    j = next(j for j in range(i, len(log)) if log[j][1] == 3)  # sharpness, then delta_enabled and update
    enabled, update = log[j + 1], log[j + 2]
    assert enabled[1:] == (1, 1) and update[1:] == (1, 0)
    bits[log[i][0]:log[i][0] + 6] = [(level0 >> (5 - k)) & 1 for k in range(6)]
    bits[enabled[0]] = 0
    del bits[update[0]]
    return bits


def _grain_off(bits: list, log: list, h: dict) -> list:
    """apply_grain 0: the header cut after it (the bit before grain_seed)."""
    seed_at = next(at for at, n, v in log if n == 16 and v == h["grain"]["grain_seed"])
    return bits[:seed_at - 1] + [0]


@needs_oracle
@pytest.mark.parametrize("seed,level", [(0, 5), (1, 8)])
def test_level_zero_takes_the_previous_blocks_level(seed, level):
    """With delta lf and no loop filter deltas, a block whose level comes
    to 0 is filtered at the previous block's level (7.14.2): a still whose
    superblocks' deltas differ (a flat half beside a photo), its header
    edited so that some come to 0 beside others that do not, decodes as
    PIL decodes it."""
    img = photo(256, 256, 20 + seed)
    img[:, 128:] = img[:, 128:] // 4 + 96
    if seed:
        img = img[::-1, ::-1].copy()
    data = pil_bytes(img, "AVIF", quality=50, speed=6, advanced={"deltaq-mode": "2", "delta-lf-mode": "1"})
    edited = _rebuild_frame_header(data, functools.partial(_lf_deltas_off, level0=level))
    h = _headers(edited)[1]
    assert h["lf_delta_enabled"] == 0 and h["lf_level"][0] == level and h["delta_lf_present"]
    _check(edited)


def test_gltf_textured_with_grain_and_quantizer_matrices(tmp_path):
    """A glTF whose texture is the RGBA still with grain, quantizer
    matrices, delta q and delta lf loads to the JAX loader's scene."""
    data = _fixture("avif_tools_rgba_128.avif")
    got, _ = _assert_same_gltf(_textured_glb(tmp_path / "t.glb", data))
    np.testing.assert_array_equal(got.textures[0], pil_rgb(data).astype(np.float32) / 255.0)


def test_grain_off_leaves_the_planes():
    """apply_grain 0 adds nothing: the grain fixture with its frame header
    cut to apply_grain 0 decodes as PIL decodes it, and the grain it had
    moved samples."""
    data = _fixture("avif_grain_test16.avif")
    plain = _rebuild_frame_header(data, _grain_off)
    assert _headers(plain)[1]["grain"] == {"apply_grain": 0}
    _check(plain)
    assert not np.array_equal(avif.planes(plain)[0], avif.planes(data)[0])


@needs_oracle
def test_grain_points_out_of_order_fail_as_pil():
    """Scaling points whose values do not increase break 5.9.30's rules:
    dav1d refuses the header and PIL raises libavif's reason; the port
    raises the same reason (its DecodeError, as for C.14)."""
    def edit(bits, log, h):
        seed = next(i for i, (_, n, v) in enumerate(log) if n == 16 and v == h["grain"]["grain_seed"])
        second = log[seed + 4]  # num_y_points, then (value, scaling) pairs: the second value
        assert log[seed + 1][1:] == (4, 3) and second[1:] == (8, 90)
        bits[second[0]:second[0] + 8] = [0] * 8
        return bits
    data = _rebuild_frame_header(_fixture("avif_grain_lag0.avif"), edit)
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == av1_obu.GRAIN_POINTS
