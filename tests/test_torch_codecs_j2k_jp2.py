"""Port parity, the JP2 layer and PIL's side of JPEG 2000 (codecs/jp2.py),
packet headers elsewhere (PPT / PPM), and streams PIL refuses, against
PIL's `convert("RGB")`; JPEG 2000 textures through the OBJ and glTF loaders
against the JAX package's.

colr sRGB / grey / sYCC / CMYK / eYCC / other enumerations / ICC / none
(OpenJPEG leaves the colour space unspecified and PIL guesses it), pclr +
cmap (P and PA, each colour kept once, RGBA palettes, wider entries PIL
ignores), cdef, res, the JPX brand, an ihdr whose size or component count
is not the codestream's, bytes after the codestream; PPT and PPM at several
segment sizes (an Nppm field split across PPM segments fails, as in
OpenJPEG); cuts at every few bytes and single-byte corruptions of three
streams: the port fails exactly where PIL fails and otherwise decodes the
same pixels. An ICNS entry in JPEG 2000.
"""
import warnings

import numpy as np
import pytest

from optixpathtracer_tpu.io import image as jimg
from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io import obj as tobj
from test_torch_obj_gltf import _assert_same_gltf, _assert_same_scene, _textured_glb
from torch_codec_encoders import assert_as_pil, assert_fails_like_pil, assert_like_pil, icns_file, photo, pil_bytes
from torch_j2k_encoders import box, cdef, colr, colr_icc, jp2_file, opj_encode, pclr, planes, to_ppm, to_ppt

P3 = planes(21, 27, 3, 1)
CS3 = opj_encode(P3, numresolution=3)
CS1 = opj_encode(planes(21, 27, 1, 2), numresolution=3)
CS2 = opj_encode(planes(21, 27, 2, 5), numresolution=3)
CS4 = opj_encode(planes(21, 27, 4, 3), numresolution=3, tcp_mct=0)


@pytest.mark.parametrize("enumcs", [16, 17, 18, 12, 24, 14, 99, None, "icc"])
def test_colour_spaces(enumcs):
    """The first colr box names OpenJPEG's colour space; eYCC and grey on
    three components find no unpacker in PIL; what it does not name is
    left unspecified, which PIL takes by the component count."""
    c = None if enumcs is None else colr_icc(bytes(100)) if enumcs == "icc" else colr(enumcs)
    for cs, nc in ((CS3, 3), (CS4, 4), (CS1, 1)):
        assert_as_pil(jp2_file(cs, 21, 27, nc, 7, c))
    assert_like_pil(jp2_file(CS3, 21, 27, 3, 7, colr(18)))
    assert_like_pil(jp2_file(CS4, 21, 27, 4, 7, colr(12) if enumcs == 12 else colr(16)))
    assert_fails_like_pil(jp2_file(CS3, 21, 27, 3, 7, colr(24)))


def test_first_colr_and_cmyk_modes():
    """OpenJPEG takes the first colr box; PIL makes CMYK of any enumcs 12."""
    assert_as_pil(jp2_file(CS4, 21, 27, 4, 7, colr(16) + colr(12)))
    assert_like_pil(jp2_file(CS4, 21, 27, 4, 7, colr(12) + colr(16)))
    assert_like_pil(jp2_file(CS4, 21, 27, 4, 7, colr(12), brand=b"jpx "))


@pytest.mark.parametrize("entries", [256, 40, 3])
def test_palettes(entries):
    """P and PA from pclr: the indices through PIL's palette of first
    occurrences (a repeated colour shifts the later ones), RGBA palettes;
    the palette under a grey colr finds no unpacker."""
    rng = np.random.default_rng(entries)
    colours = rng.integers(0, 256, (entries, 3))
    colours[-1] = colours[0]
    assert_like_pil(jp2_file(CS1, 21, 27, 1, 7, colr(16), pclr(colours)))
    assert_like_pil(jp2_file(CS2, 21, 27, 2, 7, colr(16), pclr(colours)))
    assert_like_pil(jp2_file(CS1, 21, 27, 1, 7, colr(16), pclr(rng.integers(0, 256, (entries, 4)))))
    assert_fails_like_pil(jp2_file(CS1, 21, 27, 1, 7, colr(17), pclr(colours)))
    wide = box(b"pclr", bytes([0, 2, 3, 15, 15, 15]) + bytes(12)) + box(b"cmap", bytes([0, 0, 1, 0]))
    assert_as_pil(jp2_file(CS1, 21, 27, 1, 7, colr(16), wide))  # 16-bit entries: PIL keeps L


def test_cdef_res_and_trailing_bytes():
    assert_like_pil(jp2_file(CS3, 21, 27, 3, 7, colr(16), cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])))
    assert_like_pil(jp2_file(CS4, 21, 27, 4, 7, colr(16), cdef([(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])))
    assert_like_pil(jp2_file(CS3, 21, 27, 3, 7, colr(16), box(b"res ", box(b"resc", bytes(10)))))
    for tail in (bytes(8), bytes(3), box(b"xml ", b"<a/>"), b"garbage", box(b"jp2c", b"zz")):
        assert_like_pil(jp2_file(CS3, 21, 27, 3, 7, colr(16)) + tail)
        assert_like_pil(CS3 + tail)


@pytest.mark.parametrize("height, width, nc", [(21, 28, 3), (22, 27, 3), (20, 27, 3), (21, 27, 4), (21, 27, 1)])
def test_ihdr_unlike_the_codestream(height, width, nc):
    """An ihdr of another size fails in PIL; another component count gives
    PIL's mode and its unpacker for the codestream's components."""
    assert_as_pil(jp2_file(CS3, height, width, nc, 7, colr(16)))


@pytest.mark.parametrize("chunk", [7, 20, 50, 200, 5000])
@pytest.mark.parametrize("kind", ["plain", "tiles", "sop_eph_tiles", "layers"])
def test_ppt_ppm(kind, chunk):
    kw = {"plain": {}, "tiles": dict(tile_size_on=1, cp_tdx=16, cp_tdy=8),
          "sop_eph_tiles": dict(csty=6, tile_size_on=1, cp_tdx=16, cp_tdy=8),
          "layers": dict(irreversible=1, prcw_init=[4, 4, 4], prch_init=[4, 4, 4])}[kind]
    cs = opj_encode(P3, numresolution=3, rates=(20, 5, 1) if kind == "layers" else (0,), **kw)
    assert_like_pil(to_ppt(cs, chunk))
    assert_as_pil(to_ppm(cs, chunk))  # an Nppm split across segments fails in both


STREAMS = {
    "rev": lambda: CS3,
    "irr_layers": lambda: opj_encode(P3, numresolution=3, irreversible=1, rates=(20, 5, 1)),
    "sop_eph_styles": lambda: opj_encode(P3, numresolution=3, csty=6, mode=63),
    "tiles_jp2": lambda: opj_encode(P3, numresolution=2, tile_size_on=1, cp_tdx=8, cp_tdy=8, jp2=True),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_truncated_and_corrupt_streams(name):
    """Every cut fails (OpenJPEG reads strictly for PIL: no EOC, a short
    tile-part, a segment past its packet); single bytes set anywhere fail
    or decode exactly as in PIL (a missing EPH fails, a missing SOP does
    not)."""
    data = STREAMS[name]()
    rng = np.random.default_rng(len(data))
    for cut in sorted(set(rng.integers(1, len(data), 12).tolist()) | {len(data) - 2, len(data) - 1}):
        assert_fails_like_pil(data[:cut])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(40):
            pos, val = int(rng.integers(0, len(data))), int(rng.integers(0, 256))
            if name == "sop_eph_styles" and pos == 9:
                continue  # a huge canvas: PIL's decompression-bomb check, not a decode
            assert_as_pil(data[:pos] + bytes([val]) + data[pos + 1:])


def test_icns_entry():
    """ICNS reads a JPEG 2000 entry's bytes as a file of their own."""
    img = photo(16, 16, 2)
    for data in (pil_bytes(img, "JPEG2000", no_jp2=True), pil_bytes(img, "JPEG2000"),
                 pil_bytes(img, "JPEG2000", irreversible=True)):
        assert_like_pil(icns_file([(b"icp4", data)]))
    assert_like_pil(icns_file([(b"ic08", pil_bytes(photo(256, 256, 3), "JPEG2000", no_jp2=True))]))
    assert_fails_like_pil(icns_file([(b"icp4", pil_bytes(img, "JPEG2000")[:-30])]))


def test_textures_through_obj_and_gltf(tmp_path):
    """A .jp2 and a .j2k map_Kd through load_obj, and a JPEG 2000 image in
    a glTF binary, equal to the JAX loaders' scenes."""
    px = photo(12, 20, 9)
    (tmp_path / "a.jp2").write_bytes(pil_bytes(px, "JPEG2000"))
    (tmp_path / "b.j2k").write_bytes(pil_bytes(px[::-1], "JPEG2000", no_jp2=True, irreversible=True))
    (tmp_path / "m.mtl").write_text("newmtl a\nKd 0.5 0.5 0.5\nmap_Kd a.jp2\nnewmtl b\nKd 0.2 0.3 0.4\n"
                                    "map_Kd b.j2k\n")
    (tmp_path / "m.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
                                    "vt 0 1\nusemtl a\nf 1/1 2/2 3/3\nusemtl b\nf 1/1 3/3 4/4\n")
    for native in (True, False):
        got = tobj.load_obj(str(tmp_path / "m.obj"), prefer_native=native)
        _assert_same_scene(got, jobj.load_obj(str(tmp_path / "m.obj"), prefer_native=False))
        assert len(got.textures) == 2
    np.testing.assert_array_equal(timg.load_image(str(tmp_path / "a.jp2")), jimg.load_image(str(tmp_path / "a.jp2")))
    for data in (pil_bytes(px, "JPEG2000"), pil_bytes(px, "JPEG2000", no_jp2=True, irreversible=True)):
        got, _ = _assert_same_gltf(_textured_glb(tmp_path / "j2k.glb", data))
        assert len(got.textures) == 1
