"""Port parity, AVIF (io/codecs/avif.py, av1_obu.py, avif_yuv.py and
csrc/host/av1_dec.cpp): the container, the headers, what PIL refuses, the
variants that raise A.1, and the native switch.

- The HEIF container around the same AV1 OBUs, rebuilt with `iloc`
  versions 0-2, construction method 1 (`idat`), several extents and 8-byte
  offsets, an ICC `colr` or none, `irot` / `imir` / `clap`, and a `mif1`
  major brand beside `avif`: each decoded as PIL decodes it. Properties
  marked essential or not, each failing or decoding as libavif has it.
- The sequence and frame headers of the fixtures: reduced still-picture
  headers, profile 0, 8-bit 4:2:0, the superblock size and tiles.
- ROADMAP C.14: a HEIF brand without `avif` is no format (PIL's
  UnidentifiedImageError); a primary item of type hvc1 and a file cut 40
  bytes short fail with PIL's reason (the port's DecodeError, where PIL
  raises RuntimeError and SyntaxError).
- A.1 for a step-6 variant, naming it: a premultiplied alpha item of
  another size (tests/torch_fixtures/avif_raises/); film grain and
  quantizer matrices, and a `grid` item, once refused there too, are
  fixtures of textures/ now (AVIF steps 4 and 5). ROADMAP C.16 and C.17:
  identity on 4:2:0 and matrix 10, and a show_existing_frame or inter
  frame with no frame before it, fail with PIL's reason. The
  film grain bit flipped in a sequence header, the monochrome and the
  high_bitdepth bits, which once raised here, now name a tool, a layout
  and a depth the port decodes (each flipped file decodes as PIL decodes
  it; a PIL 4:0:0 still too).
- OPTIX_TPU_NO_NATIVE=1 raises naming the switch (there is no Python tile
  decoder); a failed build raises.
- The native inverse DCT (4-64 points, one generic butterfly network) and
  ADST (8, 16) against the float transforms they approximate.
"""
import json
import os
import re

import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
from optixpathtracer_tpu_torch.utils import host_build
from torch_codec_encoders import photo, pil_bytes, pil_rgb
from torch_fixtures.make_textures import AVIF_RAISES, AVIF_RAISES_EXPECTED, OUT

with open(AVIF_RAISES_EXPECTED) as f:
    RAISES = json.load(f)


def _fixture(name: str) -> bytes:
    with open(os.path.join(OUT, name), "rb") as f:
        return f.read()


def _box(kind: bytes, body: bytes) -> bytes:
    return (8 + len(body)).to_bytes(4, "big") + kind + body


def _full(kind: bytes, version: int, body: bytes, flags: int = 0) -> bytes:
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def _properties(data: bytes) -> dict:
    """The ipco children of a PIL-written AVIF, whole boxes by type."""
    out = {}
    start = data.index(b"ipco") + 4
    end = start - 8 + int.from_bytes(data[start - 8:start - 4], "big")
    for kind, s, e in avif._boxes(data, start, end):
        out[kind] = data[s - 8:e]
    return out


def mux(obus: bytes, props: list, brands=(b"avif", b"avif", b"mif1", b"miaf"), iloc_version: int = 0,
        method: int = 0, extents: int = 1, offset_size: int = 4,
        essential=(b"av1C", b"irot", b"imir", b"clap")) -> bytes:
    """A still AVIF of one av01 item holding `obus`, with the given property
    boxes, its data in mdat (method 0) or idat (method 1), in `extents`
    pieces; the properties of `essential` types marked so (libavif wants
    the transformative ones essential)."""
    ftyp = _box(b"ftyp", brands[0] + bytes(4) + b"".join(brands[1:]))
    hdlr = _full(b"hdlr", 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = _full(b"pitm", 0, (1).to_bytes(2, "big"))
    iinf = _full(b"iinf", 0, (1).to_bytes(2, "big") + _full(b"infe", 2, (1).to_bytes(2, "big") + bytes(2) +
                                                            b"av01" + b"\0"))
    ipco = _box(b"ipco", b"".join(props))
    assoc = bytes([len(props)]) + bytes((0x80 if p[4:8] in essential else 0) | (i + 1) for i, p in enumerate(props))
    ipma = _full(b"ipma", 0, (1).to_bytes(4, "big") + (1).to_bytes(2, "big") + assoc)
    iprp = _box(b"iprp", ipco + ipma)
    cuts = np.linspace(0, len(obus), extents + 1).astype(int)
    pieces = [(int(a), int(b - a)) for a, b in zip(cuts[:-1], cuts[1:])]
    base = 0

    def iloc(base_offset: int) -> bytes:
        n = 2 if iloc_version < 2 else 4
        body = bytes([offset_size << 4 | 4, (8 << 4) | (4 if iloc_version else 0)])
        body += (1).to_bytes(n, "big") + (1).to_bytes(n, "big")
        if iloc_version:
            body += method.to_bytes(2, "big")
        body += bytes(2) + base_offset.to_bytes(8, "big") + len(pieces).to_bytes(2, "big")
        for off, ln in pieces:
            if iloc_version:
                body += bytes(4)  # extent_index
            body += off.to_bytes(offset_size, "big") + ln.to_bytes(4, "big")
        return _full(b"iloc", iloc_version, body)

    idat = _box(b"idat", obus) if method == 1 else b""
    meta = _full(b"meta", 0, hdlr + pitm + iloc(0) + iinf + iprp + idat)
    if method == 0:
        base = len(ftyp) + len(meta) + 8  # the mdat payload
        meta = _full(b"meta", 0, hdlr + pitm + iloc(base) + iinf + iprp + idat)
    return ftyp + meta + (_box(b"mdat", obus) if method == 0 else b"")


CONTAINERS = {
    "iloc_v0": dict(),
    "iloc_v1_idat": dict(iloc_version=1, method=1),
    "iloc_v2_three_extents": dict(iloc_version=2, extents=3, offset_size=8),
    "iloc_v1_two_extents": dict(iloc_version=1, extents=2),
    "mif1_major": dict(brands=(b"mif1", b"mif1", b"avif", b"miaf")),
}


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_container_variants_decode_like_pil(name):
    data = _fixture("avif_37x23.avif")
    obus, _ = avif.parse(data)
    props = _properties(data)
    got = mux(obus, [props[k] for k in (b"ispe", b"pixi", b"av1C", b"colr")], **CONTAINERS[name])
    np.testing.assert_array_equal(codecs.rgb8(got), pil_rgb(got))
    np.testing.assert_array_equal(codecs.rgb8(got), codecs.rgb8(data))


@pytest.mark.parametrize("missing", [b"ispe", b"av1C", b"pict"])
def test_what_libavif_refuses_to_parse_is_no_format(missing):
    """An av01 item without ispe or av1C, or a meta whose handler is not
    pict: libavif's parse fails, PIL's plugin gives up and PIL identifies
    no image; the port's walk goes on to UnidentifiedImageError too."""
    data = _fixture("avif_37x23.avif")
    obus, _ = avif.parse(data)
    props = _properties(data)
    got = mux(obus, [props[k] for k in (b"ispe", b"pixi", b"av1C", b"colr") if k != missing])
    if missing == b"pict":
        got = got.replace(b"pict", b"vide", 1)
    with pytest.raises(Exception, match="cannot identify"):
        pil_rgb(got)
    with pytest.raises(codecs.UnidentifiedImageError):
        codecs.rgb8(got)


ESSENTIAL_CASES = [  # (property box type, body, marked essential, what libavif does)
    (b"mdcv", bytes(24), True, "missing"), (b"cclv", bytes(8), True, "missing"), (b"zzzz", bytes(4), True, "missing"),
    (b"mdcv", bytes(24), False, "decodes"), (b"clli", bytes(4), True, "decodes"),
    (b"pasp", bytes(7) + b"\1" + bytes(3) + b"\1", True, "decodes"),
    (b"a1lx", bytes(7), True, "no format"), (b"a1lx", bytes(7), False, "decodes"),
]


@pytest.mark.parametrize("kind,body,essential,outcome", ESSENTIAL_CASES)
def test_essential_properties_as_libavif(kind, body, essential, outcome):
    """libavif skips an item with an essential property it does not parse
    (PIL: "Missing or empty image item"), refuses an essential a1lx at
    parse (PIL identifies no image), and decodes through the others."""
    data = _fixture("avif_37x23.avif")
    obus, _ = avif.parse(data)
    props = _properties(data)
    got = mux(obus, [props[k] for k in (b"ispe", b"pixi", b"av1C", b"colr")] + [_box(kind, body)],
              essential=(b"av1C", kind) if essential else (b"av1C",))
    if outcome == "decodes":
        np.testing.assert_array_equal(codecs.rgb8(got), pil_rgb(got))
    elif outcome == "missing":
        with pytest.raises(RuntimeError, match=re.escape(avif.MISSING_ITEM)):
            pil_rgb(got)
        with pytest.raises(codecs.DecodeError, match=re.escape(avif.MISSING_ITEM)):
            codecs.rgb8(got)
    else:
        with pytest.raises(Exception, match="cannot identify"):
            pil_rgb(got)
        with pytest.raises(codecs.UnidentifiedImageError):
            codecs.rgb8(got)


@pytest.mark.parametrize("colr", ["icc", "none", "limited_nclx_over_full_av1"])
def test_colour_comes_from_colr_else_the_sequence_header(colr):
    """libavif takes the nclx colr over the AV1 sequence header; with an ICC
    colr or none, the header's (unspecified = BT.601, its range)."""
    data = _fixture("avif_37x23.avif")
    obus, _ = avif.parse(data)
    props = _properties(data)
    boxes = [props[b"ispe"], props[b"pixi"], props[b"av1C"]]
    if colr == "icc":
        boxes.append(_box(b"colr", b"prof" + bytes(128)))
    elif colr == "limited_nclx_over_full_av1":
        boxes.append(_box(b"colr", b"nclx" + bytes([0, 1, 0, 13, 0, 6, 0])))
    got = mux(obus, boxes)
    np.testing.assert_array_equal(codecs.rgb8(got), pil_rgb(got))


def test_orientation_boxes_leave_the_pixels(tmp_path):
    """PIL turns irot / imir into the EXIF orientation it reports and
    decodes the pixels as coded; so does the port (clap is ignored too)."""
    import io

    from PIL import Image

    data = _fixture("avif_orient6.avif")
    assert Image.open(io.BytesIO(data)).getexif().get(0x0112) == 6
    assert b"irot" in data
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))
    np.testing.assert_array_equal(codecs.rgb8(data), codecs.rgb8(_fixture("avif_37x23.avif")))
    obus, _ = avif.parse(data)
    props = _properties(data)
    clap = b"".join(v.to_bytes(4, "big") for v in (33, 1, 21, 1, 0, 1, 0, 1))  # a centred 33 x 21 crop
    extra = [_box(b"imir", b"\x01"), _box(b"clap", clap)]
    got = mux(obus, [props[k] for k in (b"ispe", b"pixi", b"av1C", b"colr", b"irot")] + extra)
    np.testing.assert_array_equal(codecs.rgb8(got), pil_rgb(got))
    loose = mux(obus, [props[k] for k in (b"ispe", b"pixi", b"av1C", b"colr", b"irot")] + extra, essential=(b"av1C",))
    with pytest.raises(Exception, match="cannot identify"):  # libavif wants transforms essential
        pil_rgb(loose)
    with pytest.raises(codecs.UnidentifiedImageError):
        codecs.rgb8(loose)


@pytest.mark.parametrize("name,use_128,tiles,q", [
    ("avif_q75.avif", 0, (1, 1), 64), ("avif_q95.avif", 0, (1, 1), 12), ("avif_q90.avif", 0, (1, 1), 24),
    ("avif_q40.avif", 0, (1, 1), 152), ("avif_lossless.avif", 0, (1, 1), 0),
    ("avif_1024_tiles.avif", 1, (2, 2), None), ("avif_speed0_sb128.avif", 1, (1, 1), 64),
    ("loft_tex1.avif", 0, (1, 1), 64)])
def test_headers(name, use_128, tiles, q):
    obus, _ = avif.parse(_fixture(name))
    kinds = [k for k, _ in av1_obu.split_obus(obus)]
    assert kinds == [av1_obu.OBU_TEMPORAL_DELIMITER, av1_obu.OBU_SEQUENCE_HEADER, av1_obu.OBU_FRAME]
    seq = av1_obu.sequence_header(av1_obu.split_obus(obus)[1][1])
    assert (seq["reduced"], seq["profile"], seq["bit_depth"], seq["ss"], seq["use_128"]) == (1, 0, 8, (1, 1), use_128)
    hdr = av1_obu.frame_header(av1_obu.Bits(av1_obu.split_obus(obus)[2][1]), seq)
    assert (len(hdr["mi_col_starts"]) - 1, len(hdr["mi_row_starts"]) - 1) == tiles
    if q is not None:
        assert hdr["base_q_idx"] == q
    if name == "loft_tex1.avif":
        assert hdr["allow_screen_content_tools"] == hdr["allow_intrabc"] == 1


@pytest.mark.parametrize("name", sorted(RAISES))
def test_refused_files_fail_as_expected(name):
    """The step-7 variant (PIL reads it) raises A.1 naming the variant;
    the C.14, C.16, C.17, C.18 and C.19 files, the grid missing a cell and
    the sequence stripped of its meta fail as PIL fails: no format, or
    PIL's reason."""
    with open(os.path.join(AVIF_RAISES, name), "rb") as f:
        data = f.read()
    want = RAISES[name]
    with pytest.raises(Exception) as got:
        codecs.rgb8(data)
    assert type(got.value).__name__ == want["raises"] and re.search(want["match"], str(got.value)), got.value
    if want["raises"] == "NotImplementedError":
        assert pil_rgb(data).ndim == 3  # PIL reads it
        return
    with pytest.raises(Exception) as pil_error:
        pil_rgb(data)
    assert isinstance(got.value, OSError) and not isinstance(got.value, NotImplementedError)
    pil_class = {"avif_heic_brand.avif": "UnidentifiedImageError", "avif_hvc1_item.avif": "RuntimeError",
                 "avif_truncated.avif": "SyntaxError", "avif_identity_420.avif": "RuntimeError",
                 "avif_matrix10.avif": "RuntimeError", "avif_show_existing_frame.avif": "RuntimeError",
                 "avif_inter_frame.avif": "RuntimeError", "avif_grid_missing_cell.avif": "RuntimeError",
                 "avif12_overread_444.avif": "RuntimeError", "avif12_overread_420.avif": "RuntimeError",
                 "avif_tile_groups_flipped.avif": "RuntimeError", "avif_tile_cut.avif": "RuntimeError",
                 "avif_sequence_meta_stripped.avif": "UnidentifiedImageError"}[name]
    assert type(pil_error.value).__name__ == pil_class
    if pil_class != "UnidentifiedImageError":  # the same reason as PIL's
        assert str(pil_error.value) == str(got.value)


def _color_config_bit(payload: bytes) -> int:
    """The bit position of high_bitdepth in a reduced sequence header."""
    b = av1_obu.Bits(payload)
    b.f(3)
    b.f(1)
    assert b.f(1) == 1  # reduced_still_picture_header
    b.f(5)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    b.f(wbits)
    b.f(hbits)
    b.f(3)  # use_128x128_superblock, enable_filter_intra, enable_intra_edge_filter
    b.f(3)  # enable_superres, enable_cdef, enable_restoration
    return b.bit


def _flip_sequence_bit(data: bytes, offset_from_color_config: int) -> bytes:
    obus, _ = avif.parse(data)
    seq_at = obus.index(av1_obu.split_obus(obus)[1][1])
    payload = bytearray(obus[seq_at:seq_at + len(av1_obu.split_obus(obus)[1][1])])
    bit = _color_config_bit(bytes(payload)) + offset_from_color_config
    payload[bit >> 3] ^= 0x80 >> (bit & 7)
    edited = obus[:seq_at] + bytes(payload) + obus[seq_at + len(payload):]
    start = data.index(obus)
    return data[:start] + edited + data[start + len(obus):]


@pytest.mark.parametrize("offset,variant", [(0, "10-bit AV1"), (1, "monochrome AV1")])
def test_step2_sequence_variants_raise_a1(offset, variant):
    """10-bit, once a step-3 gap here, is decoded now: the flipped
    high_bitdepth bit gives a 10-bit header, and the file (its tiles coded
    for 8 bits, read at 10) decodes as PIL decodes it, planes as dav1d's.
    Monochrome, once a step-2 gap, is decoded too: the flipped bit gives a
    monochrome header that the port parses (no A.1), and a 4:0:0 still PIL
    writes decodes as PIL decodes it."""
    flipped = _flip_sequence_bit(_fixture("avif_37x23.avif"), offset)
    if variant == "10-bit AV1":
        obus, _ = avif.parse(flipped)
        assert av1_obu.sequence_header(av1_obu.split_obus(obus)[1][1])["bit_depth"] == 10
        y, u, v, seq, _ = avif.planes(flipped)
        assert y.dtype == np.uint16 and seq["bit_depth"] == 10
        np.testing.assert_array_equal(codecs.rgb8(flipped), pil_rgb(flipped))
        if oracle.available():
            _, want = oracle.planes(flipped)
            for got, ref in zip((y, u, v), want):
                np.testing.assert_array_equal(got, ref)
        return
    obus, _ = avif.parse(flipped)
    assert av1_obu.sequence_header(av1_obu.split_obus(obus)[1][1])["mono"] == 1
    grey = pil_bytes(photo(23, 37, 5), "AVIF", subsampling="4:0:0")
    np.testing.assert_array_equal(codecs.rgb8(grey), pil_rgb(grey))


def test_film_grain_raises_a1():
    """film_grain_params_present is the sequence header's last bit before
    its trailing bits. Once A.1 (AVIF step 4), the flipped header now has
    the frame header read film_grain_params after reduced_tx_set: its
    apply_grain is the first of the zero bits that byte-aligned the header,
    so the tiles start where they did and the file decodes as PIL decodes
    it, as the unflipped file does."""
    data = _fixture("avif_37x23.avif")
    obus, _ = avif.parse(data)
    payload = av1_obu.split_obus(obus)[1][1]
    seq = av1_obu.sequence_header(payload)
    assert not seq["film_grain_params_present"]
    # the last set bit is the trailing one; film grain sits just before it
    last = max(i for i in range(len(payload) * 8) if payload[i >> 3] & (0x80 >> (i & 7)))
    edited = bytearray(payload)
    edited[(last - 1) >> 3] |= 0x80 >> ((last - 1) & 7)
    start = data.index(payload)
    flipped = data[:start] + bytes(edited) + data[start + len(payload):]
    obus, _ = avif.parse(flipped)
    seq = av1_obu.sequence_header(av1_obu.split_obus(obus)[1][1])
    assert seq["film_grain_params_present"]
    h = av1_obu.frame_header(av1_obu.Bits(av1_obu.split_obus(obus)[2][1]), seq)
    assert h["grain"] == {"apply_grain": 0}
    got = codecs.rgb8(flipped)
    np.testing.assert_array_equal(got, pil_rgb(flipped))
    np.testing.assert_array_equal(got, codecs.rgb8(data))


@pytest.mark.parametrize("where", ["starts_past_the_end", "runs_past_the_end", "empty"])
def test_item_extent_off_the_file_fails_as_libavif(where):
    """The primary item's iloc extent starting past the end of the file, or
    running past it, or of length 0 (empty, not "to the end"): each fails
    with libavif's reason, as PIL fails (ROADMAP C.14: the port's
    DecodeError where PIL raises SyntaxError / RuntimeError)."""
    data = _fixture("avif_37x23.avif")
    i = data.index(b"iloc") + 4
    assert data[i] == 0 and data[i + 4:i + 6] == b"\x44\x00" and data[i + 6:i + 8] == b"\x00\x01"
    at = i + 8  # the one item's entry: id, data reference, extent count, offset, length
    offset, length = int.from_bytes(data[at + 6:at + 10], "big"), int.from_bytes(data[at + 10:at + 14], "big")
    value = {"starts_past_the_end": (at + 6, len(data) + 5), "runs_past_the_end": (at + 10, length + 10),
             "empty": (at + 10, 0)}[where]
    data = data[:value[0]] + value[1].to_bytes(4, "big") + data[value[0] + 4:]
    with pytest.raises(Exception) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == {
        "starts_past_the_end": avif.BMFF_FAILED, "runs_past_the_end": avif.TRUNCATED, "empty": avif.MISSING_ITEM}[where]
    assert offset + length <= len(data)


def test_unsupported_matrix_raises_a1():
    """Identity (matrix 0) on a 4:2:0 still: libavif refuses to convert it,
    and PIL raises its reason; the port raises the same reason (its
    DecodeError, as for C.14), no A.1 (ROADMAP C.16)."""
    data = _fixture("avif_37x23.avif")
    data = data.replace(b"colrnclx\x00\x01\x00\x0d\x00\x06", b"colrnclx\x00\x01\x00\x0d\x00\x00")
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == "Conversion from YUV failed: Reformat failed"


def test_no_native_raises_naming_the_switch(monkeypatch):
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    with pytest.raises(NotImplementedError, match="OPTIX_TPU_NO_NATIVE"):
        codecs.rgb8(_fixture("avif_37x23.avif"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A missing compiler raises (no silent fallback of any kind)."""
    monkeypatch.delenv("OPTIX_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(av1_obu, "_SIG", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        codecs.rgb8(_fixture("avif_37x23.avif"))


def test_pil_default_stills_decode_in_the_walk(tmp_path):
    """A fresh file of PIL's encoder goes through the format walk to the
    AVIF decoder, equal to PIL's decode and to the JAX package's
    load_image."""
    from optixpathtracer_tpu.io import image as jimg
    from optixpathtracer_tpu_torch.io import image as timg

    data = pil_bytes(photo(40, 52, 11), "AVIF", quality=60)
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))
    np.testing.assert_array_equal(timg.load_image(str(path)), jimg.load_image(str(path)))


@pytest.mark.parametrize("kind,n", [("dct", 4), ("dct", 8), ("dct", 16), ("dct", 32), ("dct", 64), ("adst", 8),
                                    ("adst", 16)])
def test_inverse_transforms_approximate_the_float_ones(kind, n):
    """Each 1-D inverse transform of csrc/host/av1_dec.cpp within a few
    units of its float definition (the DC basis of the DCT 1 / sqrt 2; the
    ADST of 8 and 16 a DST-IV): a wrong angle or sign in the network gives
    errors of the inputs' size."""
    import ctypes

    lib = host_build.load("av1_dec")
    lib.av1_inverse_1d.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int]
    rng = np.random.default_rng(n)
    i, k = np.arange(n)[:, None], np.arange(n)[None, :]
    if kind == "dct":
        basis = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
        basis[:, 0] = 1 / np.sqrt(2)
    else:
        basis = np.sin(np.pi * (2 * i + 1) * (2 * k + 1) / (4 * n))
    worst = 0.0
    for _ in range(50):
        x = rng.integers(-2000, 2000, n).astype(np.int32)
        buf = x.copy()
        lib.av1_inverse_1d(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, 0 if kind == "dct" else 1)
        worst = max(worst, float(np.abs(buf - basis @ x).max()))
    assert worst < 0.25 * n + 2, worst  # rounding over the stages, not a wrong rotation (errors of 100s)
