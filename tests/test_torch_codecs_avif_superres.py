"""Port parity, AVIF step 6's AV1 superres (io/codecs/av1_obu.py's
superres_params: the downscaled FrameWidth sets MiCols, the tiles, the
deblocking and CDEF, and IntraBC is not read; csrc/host/av1_dec.cpp's
upscaling process, 7.16, after CDEF and before loop restoration, on the
CDEF output and on the deblocked rows loop restoration reads at its stripe
edges, with loop-restoration units on the upscaled width and read_lr's
column mapping, and film grain on the upscaled frame).

No encoder here writes superres, so the stills are OpenCV's libavif's
encoded at the downscaled width W' = (8 W + d / 2) / d with a full
sequence header and made superres stills of width W by header edits
(make_textures.avif_superres): enable_superres and the maximum width in
the sequence header, use_superres and coded_denom = d - 9 in the frame
header, W in the ispe. The tile data is as coded: with loop restoration
on, its unit reads are read on the new geometry, and the port holds
whatever dav1d does with them.

- Every denominator 9-16 at 8, 10 and 12 bits in 4:4:4, 4:2:0 and 4:0:0,
  at an odd downscaled width where d allows: planes equal to dav1d's, RGB
  to PIL's.
- Film grain on the upscaled frame; loop restoration on (chroma units
  from aom; luma units by a header edit of lr_params); dav1d's least
  downscaled width (16, or W below it).
- Upscale_Filter (av1_tables.h) is the library's, its first rows as the
  specification prints them.
- The committed superres fixtures, and a glTF textured with one, loaded as
  the JAX loader loads it.

The oracle cases skip where PIL ships no libavif, the encodes where OpenCV
ships none.
"""
import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import av1_obu
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_codecs_avif_tables import _table
from test_torch_codecs_avif_tools import _fixture, _headers
import torch_codec_encoders as enc
from torch_codec_encoders import pil_rgb, yuv_photo
from torch_fixtures import gen_av1_tables as gen
from torch_fixtures import make_textures as mt

needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")


def _as_pil(data: bytes):
    """Planes equal to dav1d's and RGB to PIL's, or PIL's failure -> PIL's
    message or None."""
    try:
        want = pil_rgb(data)
    except (RuntimeError, SyntaxError) as e:
        with pytest.raises(codecs.DecodeError) as got:
            codecs.rgb8(data)
        assert str(got.value) == str(e)
        return str(e)
    _assert_planes_equal(data)
    np.testing.assert_array_equal(codecs.rgb8(data), want)
    return None


def _superres(width: int, height: int, denom: int, depth: int, fmt: int, seed: int, **kw) -> bytes:
    data = mt.superres_still(enc, width, height, denom, depth, fmt, seed, **kw)
    seq, h = _headers(data)
    assert seq["enable_superres"] and h["upscaled_width"] == width and h["superres_denom"] == denom
    assert h["width"] == max((8 * width + denom // 2) // denom, min(16, width))
    return data


@needs_encoder
@pytest.mark.parametrize("denom", range(9, 17))
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", [1, 3, 4])
def test_every_denominator_depth_and_layout(denom, depth, fmt):
    """Planes equal to dav1d's, RGB equal to PIL's; CDEF on (aom's
    good-quality usage), a downscaled width that is odd for most d."""
    width = 77 if denom % 2 else 93
    data = _superres(width, 40, denom, depth, fmt, 40 + denom + depth)
    assert _headers(data)[1]["enable_cdef"]
    assert _as_pil(data) is None


@needs_encoder
@pytest.mark.parametrize("denom", [9, 13, 16])
@pytest.mark.parametrize("depth,fmt,vector", [(8, 3, 1), (10, 1, 2), (12, 4, 3)])
def test_film_grain_on_the_upscaled_frame(denom, depth, fmt, vector):
    data = _superres(93, 72, denom, depth, fmt, 40 + denom + depth, options={"film-grain-test": vector})
    assert _headers(data)[1]["grain"]["apply_grain"]
    assert _as_pil(data) is None


# (d, depth, layout, (width, height)): the stills aom restores at quality 30, speed 4
LR_CASES = [(d, 10, 3, (96, 96)) for d in (9, 10, 11, 13, 14, 15, 16)] + \
           [(d, 8, 3, (93, 72)) for d in (10, 11, 12, 13, 14, 16)]


@needs_encoder
@pytest.mark.parametrize("case", LR_CASES)
def test_loop_restoration_read_on_the_upscaled_geometry(case):
    """Loop restoration's units lie on the upscaled width and read_lr maps
    superblock columns through the upscaling; the still's unit reads were
    coded for the downscaled geometry, and the port reads and applies them
    as dav1d does: the same planes, or the same failure."""
    denom, depth, fmt, (width, height) = case
    data = _superres(width, height, denom, depth, fmt, 40 + denom + depth,
                     options={"enable-restoration": 1}, quality=30, speed=4)
    assert any(_headers(data)[1]["lr_type"])
    assert _as_pil(data) in (None, mt.COLOR_FAILED)


# (width, height, d, depth, layout, seed): stills where aom restores chroma alone
CHROMA_LR = [(93, 72, 12, 8, 3, 60), (96, 96, 10, 10, 3, 60)]


@needs_encoder
@pytest.mark.parametrize("lr_type", [1, 2, 3])
@pytest.mark.parametrize("case", CHROMA_LR)
def test_luma_loop_restoration_by_header_edit(lr_type, case):
    """Luma loop restoration turned on by an edit of lr_params in a
    superres still whose chroma aom restored: every unit of the upscaled
    luma plane reads its coefficients from the tile data; the same planes
    as dav1d's, or its failure."""
    width, height, denom, depth, fmt, seed = case
    data = _superres(width, height, denom, depth, fmt, seed, options={"enable-restoration": 1}, quality=30, speed=4)
    h = _headers(data)[1]
    coded = {av1_obu.REMAP_LR_TYPE[k]: k for k in range(4)}
    edited = mt.avif_lr_edited(data, [lr_type] + [coded[t] for t in h["lr_type"][1:]])
    assert _headers(edited)[1]["lr_type"][0] == av1_obu.REMAP_LR_TYPE[lr_type]
    assert _as_pil(edited) in (None, mt.COLOR_FAILED)


@needs_encoder
@pytest.mark.parametrize("lr_type", [1, 2, 3])
@pytest.mark.parametrize("case", [(16, 8, 3, 0), (12, 10, 3, 1), (10, 8, 1, 2)])
def test_loop_restoration_units_on_the_upscaled_width(lr_type, case):
    """A 256-wide superres still (downscaled to 128-205) with luma loop
    restoration and 64-sample units by a header edit: 4 luma units across
    the upscaled width where the downscaled one holds 2-3, each read where
    read_lr's column mapping puts it; the same planes as dav1d's, or its
    failure. (The stills of 96 and less hold one unit a row either way.)"""
    denom, depth, fmt, seed = case
    data = _superres(256, 64, denom, depth, fmt, seed, options={"enable-restoration": 1}, quality=30, speed=4)
    h = _headers(data)[1]
    coded = {av1_obu.REMAP_LR_TYPE[k]: k for k in range(4)}
    edited = mt.avif_lr_edited(data, [lr_type] + [coded[t] for t in h["lr_type"][1:]], unit_shift=0)
    assert _headers(edited)[1]["lr_size"][0] == 64
    assert _as_pil(edited) in (None, mt.COLOR_FAILED)


@needs_encoder
@pytest.mark.parametrize("width,denom", [(18, 16), (16, 12), (40, 16), (24, 9)])
def test_least_downscaled_width(width, denom):
    """dav1d keeps the downscaled width at 16 or more (the upscaled width
    where it is less): W = 18, d = 16 codes 16 columns where (8 W + d / 2)
    / d would give 9."""
    down = max((8 * width + denom // 2) // denom, min(16, width))
    data = oracle.encode_hbd(yuv_photo(24, down, 70 + width, 8, 3), 8, 3, single=False)
    edited = mt.avif_superres(data, width, denom)
    assert _headers(edited)[1]["width"] == down
    assert _as_pil(edited) is None


def test_upscale_filter_is_the_specifications():
    """Upscale_Filter[64][8] (7.16): the library's, its first rows as the
    specification prints them, each row summing to 128."""
    with open(gen.OUT) as f:
        rows = np.array(_table(f.read(), "Upscale_Filter")).reshape(64, 8)
    assert rows[0].tolist() == [0, 0, 0, 128, 0, 0, 0, 0]
    assert rows[1].tolist() == [0, 0, -1, 128, 2, -1, 0, 0]
    assert rows[32].tolist() == [-2, 7, -20, 79, 79, -20, 7, -2]
    assert (rows.sum(1) == 128).all()


SUPERRES_FIXTURES = ["avif_superres_420.avif", "avif10_superres_444_grain.avif", "avif12_superres_400.avif",
                     "avif10_superres_420_lr.avif"]


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
@pytest.mark.parametrize("name", SUPERRES_FIXTURES)
def test_superres_fixtures(name):
    data = _fixture(name)
    seq, h = _headers(data)
    assert seq["enable_superres"] and h["upscaled_width"] > h["width"]
    assert _as_pil(data) is None


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
def test_gltf_textured_with_superres(tmp_path):
    """A glTF whose texture is a superres still loads as the JAX loader
    loads it."""
    from test_torch_obj_gltf import _assert_same_gltf, _textured_glb

    data = _fixture("avif10_superres_444_grain.avif")
    got, _ = _assert_same_gltf(_textured_glb(tmp_path / "superres.glb", data))
    np.testing.assert_array_equal(got.textures[0], pil_rgb(data).astype(np.float32) / 255.0)
