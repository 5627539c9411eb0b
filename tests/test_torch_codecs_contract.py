"""Port parity, the decoders' contract (io/codecs/__init__.py, io/image.py,
io/gltf.py, io/obj.py) against PIL and the JAX package's loaders.

- NotImplementedError naming ROADMAP A.1 only for bytes PIL reads: one
  case per variant PIL reads here and the port does not (an AVIF grid,
  AVIF step 5); the cases of the formats once unported here (BLP, IM,
  MSP, SPIDER, XBM, ICNS, SUN, XPM, FITS, JPEG 2000, AVIF at PIL's
  defaults, 4:4:4 AVIF, AVIF with quantizer matrices) now hold the port's
  decode to PIL's, and a glTF that embeds an AVIF grid raises A.1 (one
  with a 4:4:4 AVIF and one with quantizer matrices, each once the
  example here, load as the JAX loader loads them).
- The formats PIL opens but cannot decode (EPS without Ghostscript, MPEG,
  HDF5, BUFR, GRIB, WMF) raise an OSError that is no NotImplementedError,
  and a glTF embedding one keeps the factor-only material in both
  packages (ROADMAP C.12).
- What PIL cannot read raises an OSError in both packages: bytes of no
  format, a Radiance .hdr through `load_image`, a 12-bit or hierarchical
  JPEG; the glTF loaders then both keep the factor-only material with a
  warning, and `load_obj` raises the decoder's error once.
- Formats are told apart in PIL's order: bytes that a later format owns
  but an earlier one's magic takes resolve as PIL resolves them.
"""
import os
import struct
import warnings

import numpy as np
import pytest

from optixpathtracer_tpu.io import image as jimg
from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io import obj as tobj
from test_torch_obj_gltf import _assert_same_gltf, _textured_glb
from torch_codec_encoders import assert_fails_like_pil, assert_like_pil, photo, pil_bytes, pil_rgb
from torch_fixtures.make_textures import AVIF_RAISES, OUT


def _sun(img: np.ndarray) -> bytes:
    """A Sun raster file: 24-bit BGR rows, each padded to 16 bits."""
    h, w, _ = img.shape
    body = b"".join(r.tobytes() + b"\0" * ((w * 3) % 2) for r in img[..., ::-1])
    return struct.pack(">8I", 0x59A66A95, w, h, 24, len(body), 1, 0, 0) + body


def _xpm() -> bytes:
    return b'/* XPM */\nstatic char *x[] = {\n"4 2 2 1",\n"a c #FF0000",\n"b c #00FF00",\n"abab",\n"baba"\n};\n'


def _committed_avif(name: str) -> bytes:
    """An AVIF of tests/torch_fixtures/textures (a grid from libavif's own
    encoder, which PIL's save does not write; a premultiplied alpha item of
    another size than the colour, which libavif scales) or, where the port
    raises A.1 for it, of tests/torch_fixtures/avif_raises (an inter frame
    shown first, after a hidden key frame, with the motion-field projection
    of AVIF step 8)."""
    path = os.path.join(OUT, name)
    with open(path if os.path.exists(path) else os.path.join(AVIF_RAISES, name), "rb") as f:
        return f.read()


def _fits() -> bytes:
    cards = [b"SIMPLE  =                    T", b"BITPIX  =                    8", b"NAXIS   =                    2",
             b"NAXIS1  =                    4", b"NAXIS2  =                    3", b"END"]
    head = b"".join(c.ljust(80) for c in cards).ljust(2880)
    return head + bytes(range(12)).ljust(2880, b"\0")


UNPORTED = {
    "BLP": lambda: pil_bytes(photo(16, 16, 1), "BLP", "P"),
    "IM": lambda: pil_bytes(photo(8, 8, 1), "IM"),
    "MSP": lambda: pil_bytes(photo(16, 16, 1), "MSP", "1"),
    "SPIDER": lambda: pil_bytes(photo(8, 8, 1), "SPIDER", "F"),
    "XBM": lambda: pil_bytes(photo(8, 8, 1), "XBM", "1"),
    "JPEG2000": lambda: pil_bytes(photo(8, 8, 1), "JPEG2000"),
    "AVIF": lambda: pil_bytes(photo(8, 8, 1), "AVIF"),
    "AVIF_444": lambda: pil_bytes(photo(8, 8, 1), "AVIF", subsampling="4:4:4"),
    "AVIF_QM": lambda: pil_bytes(photo(8, 8, 1), "AVIF", advanced={"enable-qm": "1"}),
    "AVIF_GRID": lambda: _committed_avif("avif_grid.avif"),
    "AVIF_PREM_ALPHA_OTHER_SIZE": lambda: _committed_avif("avif_prem_alpha_other_size.avif"),
    "AVIF_INTER_SHOWN_FIRST": lambda: _committed_avif("avif_inter_shown_first.avif"),
    "AVIF_INTER": lambda: _committed_avif("avif_inter_420.avif"),
    "ICNS": lambda: pil_bytes(photo(16, 16, 1, 4), "ICNS", "RGBA", sizes=[(16, 16)]),
    "SUN": lambda: _sun(photo(3, 5, 1)),
    "XPM": _xpm,
    "FITS": _fits,
}


# what each still-unported case's NotImplementedError names
STILL_UNPORTED = {"AVIF_INTER_SHOWN_FIRST": "AVIF of AV1 motion-field projection"}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_format_pil_reads_raises_a1(tmp_path, name):
    """A.1 for the formats still unported; each format once unported here
    decodes as PIL does, and its file loads as the JAX package loads it."""
    data = UNPORTED[name]()
    assert pil_rgb(data).ndim == 3  # PIL reads it
    if name not in STILL_UNPORTED:
        assert_like_pil(data, tmp_path, "x.img")
        return
    with pytest.raises(NotImplementedError, match=f"{STILL_UNPORTED[name]}.*ROADMAP A.1"):
        timg.rgb8_from_bytes(data)
    path = tmp_path / "x.img"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="A.1"):
        timg.load_image(str(path))


def _eps() -> bytes:
    return b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\n%%EndComments\nshowpage\n%%EOF\n"


# formats PIL opens and cannot decode here: (bytes, PIL's reason)
STUBS = {
    "EPS": (_eps, "Ghostscript"),
    "MPEG": (lambda: b"\x00\x00\x01\xb3\x01\x00\x10\x14" + bytes(40), "cannot load this image"),
    "HDF5": (lambda: b"\x89HDF\r\n\x1a\n" + bytes(40), "HDF5"),
    "BUFR": (lambda: b"BUFR" + bytes(40), "BUFR"),
    "GRIB": (lambda: b"GRIB\x00\x00\x00\x01" + bytes(40), "GRIB"),
    "WMF": (lambda: b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(8) + b"\x60\x00" + bytes(28), "WMF"),
}


@pytest.mark.parametrize("name", list(STUBS))
def test_stub_formats_fail_like_pil(tmp_path, name):
    """C.12: an OSError with PIL's reason, never A.1, from the decoder and
    from load_image, as the JAX package's load_image fails."""
    make, reason = STUBS[name]
    data = make()
    assert_fails_like_pil(data)
    with pytest.raises(codecs.DecodeError, match=reason):
        timg.rgb8_from_bytes(data)
    path = tmp_path / "x.img"
    path.write_bytes(data)
    with pytest.raises(Exception):
        jimg.load_image(str(path))
    with pytest.raises(OSError) as e:
        timg.load_image(str(path))
    assert not isinstance(e.value, NotImplementedError)


@pytest.mark.parametrize("name", list(STUBS))
def test_gltf_stub_format_keeps_the_factor_only_material(tmp_path, name):
    """C.12: a glTF embedding bytes of a format PIL opens and cannot decode
    loads in both packages with the factor-only material (tex_id -1) and
    a warning; the port once raised NotImplementedError here."""
    path = _textured_glb(tmp_path / "stub.glb", STUBS[name][0]())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, _ = _assert_same_gltf(path)
    assert sum("undecodable, using material factors only" in str(w.message) for w in caught) == 2
    assert not got.textures and all(m.material["texture_id"] == -1 for m in got.meshes)


def _twelve_bit() -> bytes:
    base = pil_bytes(photo(8, 8, 2), "JPEG", quality=75)
    sof = base.index(b"\xff\xc0")
    return base[:sof + 4] + b"\x0c" + base[sof + 5:]


def _hierarchical() -> bytes:
    base = pil_bytes(photo(8, 8, 2), "JPEG", quality=75)
    sof = base.index(b"\xff\xc0")
    return base[:sof] + b"\xff\xc5" + base[sof + 2:]


UNREADABLE = {
    "no format": lambda: b"no image format" + bytes(40),
    "radiance hdr": lambda: b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n" + bytes(16),
    "12-bit jpeg": _twelve_bit,
    "hierarchical jpeg": _hierarchical,
    "truncated png": lambda: pil_bytes(photo(8, 8, 2), "PNG")[:40],
}


@pytest.mark.parametrize("name", list(UNREADABLE))
def test_what_pil_cannot_read_raises_an_os_error(tmp_path, name):
    data = UNREADABLE[name]()
    assert_fails_like_pil(data)
    path = tmp_path / ("x.hdr" if "hdr" in name else "x.img")
    path.write_bytes(data)
    with pytest.raises(OSError):
        jimg.load_image(str(path))
    with pytest.raises(OSError) as e:
        timg.load_image(str(path))
    assert not isinstance(e.value, NotImplementedError)


@pytest.mark.parametrize("name", ["no format", "12-bit jpeg", "hierarchical jpeg"])
def test_gltf_keeps_the_factor_only_material(tmp_path, name):
    """Both loaders warn and keep the material's factors (tex_id -1), as
    optixpathtracer_tpu/io/gltf.py:208-213 does."""
    path = _textured_glb(tmp_path / "bad.glb", UNREADABLE[name]())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, _ = _assert_same_gltf(path)
    assert sum("undecodable, using material factors only" in str(w.message) for w in caught) == 2
    assert not got.textures and all(m.material["texture_id"] == -1 for m in got.meshes)


def test_gltf_with_unported_format_raises_a1(tmp_path):
    from optixpathtracer_tpu_torch.io import gltf as tgltf

    path = _textured_glb(tmp_path / "avif.glb", UNPORTED["AVIF_INTER_SHOWN_FIRST"]())
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*A.1"):
        tgltf.load_gltf(path)
    for name in ("AVIF_444", "AVIF_QM", "AVIF_GRID", "AVIF_PREM_ALPHA_OTHER_SIZE", "AVIF_INTER"):  # each once raised here
        got, _ = _assert_same_gltf(_textured_glb(tmp_path / f"{name}.glb", UNPORTED[name]()))
        assert len(got.textures) == 1


@pytest.mark.parametrize("native", [True, False])
def test_load_obj_raises_the_decoder_error_once(tmp_path, monkeypatch, native):
    (tmp_path / "tex.jpg").write_bytes(_twelve_bit())
    (tmp_path / "m.mtl").write_text("newmtl tex\nKd 0.3 0.3 0.3\nmap_Kd tex.jpg\n")
    (tmp_path / "s.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
                                    "usemtl tex\nf 1/1 2/2 3/3\n")
    path = str(tmp_path / "s.obj")
    with pytest.raises(OSError):
        jobj.load_obj(path, prefer_native=native)
    calls = []
    real = codecs.rgb8
    monkeypatch.setattr(codecs, "rgb8", lambda data: calls.append(len(data)) or real(data))
    with pytest.raises(codecs.UnidentifiedImageError, match="cannot identify"):
        tobj.load_obj(path, prefer_native=native)
    assert len(calls) == 1


def test_pil_order_resolves_shared_magic():
    """A 1x1 QOI begins with what GIMP brushes' magic test takes (a big
    header size, then version 1), but not their header checks: QOI. A
    short TGA whose ID field makes it look like PCX goes on to TGA."""
    qoi = pil_bytes(photo(1, 1, 3), "QOI")
    assert struct.unpack(">I", qoi[4:8])[0] == 1
    assert_like_pil(qoi)
    from torch_codec_encoders import tga_file

    tga = tga_file(np.arange(6, dtype=np.uint8).reshape(1, 6), 2, 24, image_id=bytes(10))
    assert tga[:2] == b"\x0a\x00"
    assert_like_pil(tga)


def test_every_ported_format_is_in_pils_order():
    from PIL import Image

    Image.init()
    names = [n for n, _, _ in codecs.FORMATS]
    preinit = ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG"]
    pil_order = preinit + [n for n in Image.ID if n not in preinit]
    assert names == [n for n in pil_order if n in names]
    missing = set(pil_order) - set(names)
    assert missing <= {"MPO", "FPX", "MIC"}, missing  # not registered by PIL here, or folded into JPEG
