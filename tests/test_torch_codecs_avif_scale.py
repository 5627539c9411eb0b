"""Port parity, AVIF step 6's sizes and sources: libavif's avifImageScale
(io/codecs/avif_scale.py: libyuv's ScalePlane and ScalePlane_12 in box
filter mode, each of their paths with its own rounding), applied where
libavif applies it (io/codecs/avif.py: a frame of another size than its
item's ispe or its track's tkhd, each grid cell to its own ispe, an alpha
item to its ispe before un-premultiplying), libavif's limited-range alpha
brought to full range, and image sequences (the first AV1 track's first
sample; libavif's AVIF_DECODER_SOURCE_AUTO, ROADMAP C.20).

- avif_scale.scale_plane equals avifImageScale (PIL's libavif through
  ctypes, tests/torch_avif_oracle.py `scale`) on seeded planes for every
  path libyuv takes (copy, vertical only, 3/4, 1/2, 3/8 and 1/4 down, box,
  twice up, bilinear up and down, point sampling) and a random sweep of
  sizes, at 8, 10 and 12 bits, and on the three planes of each layout.
- Frames of another size than their ispe, up and down, odd, at each depth
  and layout; grid cells of another size than theirs; an alpha item of
  another size than the colour (scaled to its ispe, then un-premultiplied)
  and one whose ispe differs from the colour's (PIL's alpha failure);
  limited-range premultiplied alpha: each equal to PIL or failing as PIL
  fails.
- Image sequences: a file of tracks alone decodes as PIL does; one whose
  brands still say avif is no image to PIL and to the port; an `avis`
  file is read from its track and an `avif` one from its item (C.20: the
  port read the item); straight and premultiplied alpha tracks; a file
  with no AV1 track.

The oracle cases skip where PIL ships no libavif, the encodes where OpenCV
ships none.
"""
import io

import numpy as np
import pytest
from PIL import Image

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import avif, avif_scale
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_codecs_avif_tools import _fixture
from torch_codec_encoders import avif_grid, avif_still, photo, pil_bytes, pil_rgb, yuv_photo
from torch_fixtures import make_textures as mt

needs_oracle = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")
ALPHA_FAILED = "Failed to decode frame 0: Decoding of alpha plane failed"

# libyuv's path -> (source width, height, destination width, height) that take it
PATHS = {
    "copy": [(40, 32, 40, 32), (1, 1, 1, 1)],
    "vertical": [(40, 32, 40, 64), (33, 27, 33, 13), (48, 48, 48, 16), (17, 9, 17, 30)],
    "down_3_4": [(40, 32, 30, 24), (96, 64, 72, 48), (128, 96, 96, 72), (64, 40, 48, 30)],
    "down_1_2": [(40, 32, 20, 16), (96, 96, 48, 48), (34, 18, 17, 9)],
    "down_3_8": [(40, 32, 15, 12), (48, 48, 18, 18), (64, 40, 24, 15), (128, 64, 48, 24), (160, 96, 60, 36)],
    "down_1_4": [(40, 32, 10, 8), (96, 96, 24, 24), (64, 40, 16, 10)],
    "box": [(40, 32, 13, 10), (33, 27, 8, 6), (64, 40, 21, 13), (17, 9, 5, 3), (200, 8, 50, 3)],
    "up_2_linear": [(40, 32, 80, 32), (33, 27, 65, 27), (17, 9, 33, 9)],
    "up_2_bilinear": [(40, 32, 80, 64), (40, 32, 79, 63), (33, 27, 65, 53), (17, 9, 34, 18)],
    "bilinear_up": [(40, 32, 47, 37), (33, 27, 61, 31), (1, 1, 7, 5), (64, 64, 192, 192), (17, 9, 11, 20)],
    "bilinear_down": [(40, 32, 35, 29), (33, 27, 28, 26), (48, 48, 36, 30), (64, 40, 48, 39), (96, 20, 60, 19)],
    "point": [(33, 27, 11, 27), (48, 48, 16, 48), (9, 1, 3, 1)],
}


def _planes(rng, shape, depth):
    return rng.integers(0, 1 << depth, shape).astype(np.uint8 if depth == 8 else np.uint16)


@needs_oracle
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("path", list(PATHS))
def test_each_libyuv_path_equals_libavif(path, depth):
    rng = np.random.default_rng(depth)
    for sw, sh, dw, dh in PATHS[path]:
        src = _planes(rng, (sh, sw), depth)
        (want,), _ = oracle.scale([src], depth, 4, dw, dh)
        got = avif_scale.scale_plane(src, dw, dh)
        assert got.dtype == src.dtype
        np.testing.assert_array_equal(got, want, err_msg=str((sw, sh, dw, dh)))


@needs_oracle
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("seed", range(4))
def test_random_sizes_equal_libavif(depth, seed):
    """A seeded sweep: 40 (source, destination) sizes from 1 to 130, up
    and down in each axis."""
    rng = np.random.default_rng(100 + 10 * depth + seed)
    for _ in range(40):
        sw, sh = (int(v) for v in rng.integers(1, 110, 2))
        dw, dh = (int(v) for v in rng.integers(1, 130, 2))
        src = _planes(rng, (sh, sw), depth)
        (want,), _ = oracle.scale([src], depth, 4, dw, dh)
        np.testing.assert_array_equal(avif_scale.scale_plane(src, dw, dh), want, err_msg=str((sw, sh, dw, dh)))


@needs_oracle
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_every_layout_and_alpha_equal_libavif(depth, fmt):
    """avifImageScale's Y, U and V (chroma to the subsampled size of the
    new size, odd sizes rounding up) and its alpha plane."""
    rng = np.random.default_rng(fmt * depth)
    ss = oracle.SUBSAMPLING[fmt]
    for (w, h), (dw, dh) in (((48, 40), (61, 37)), ((33, 27), (16, 14)), ((40, 32), (80, 64))):
        shapes = [(h, w)] + ([] if ss is None else [((h + ss[1]) >> ss[1], (w + ss[0]) >> ss[0])] * 2)
        planes = [_planes(rng, s, depth) for s in shapes]
        alpha = _planes(rng, (h, w), depth)
        want, want_alpha = oracle.scale(planes, depth, fmt, dw, dh, alpha)
        u, v = (None, None) if ss is None else planes[1:]
        y, u, v = avif_scale.scale(planes[0], u, v, ss, dw, dh)
        for got, ref in zip([y] + ([] if u is None else [u, v]), want):
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(avif_scale.scale_plane(alpha, dw, dh), want_alpha)


def _as_pil(data: bytes):
    try:
        want = pil_rgb(data)
    except (RuntimeError, SyntaxError) as e:
        with pytest.raises(codecs.DecodeError) as got:
            codecs.rgb8(data)
        assert str(got.value) == str(e)
        return str(e)
    np.testing.assert_array_equal(codecs.rgb8(data), want)
    return None


@needs_encoder
@pytest.mark.parametrize("depth,fmt", [(8, 3), (8, 2), (10, 1), (10, 3), (12, 4), (12, 1)])
@pytest.mark.parametrize("size", [(96, 80), (24, 20), (61, 37), (48, 33), (95, 79)])
def test_frame_of_another_size_than_its_ispe(depth, fmt, size):
    """A 48 x 40 frame under an ispe of another size: libavif scales it to
    the ispe, and so does the port; planes equal to dav1d's as libavif
    hands them on, RGB to PIL's."""
    obus, av1c, colr = mt.avif_parts(oracle.encode_hbd(yuv_photo(40, 48, 3 + depth, depth, fmt), depth, fmt))
    data = avif_still(obus, size, av1c, depth=depth, colr=colr)
    assert _as_pil(data) is None
    _assert_planes_equal(data)


@needs_oracle
def test_grid_cells_of_another_size_than_their_ispe():
    """Each grid cell is scaled to its own ispe before the cells are laid
    out: one cell, or every cell, coded 48 x 48 under 64 x 64 ispes."""
    cells = [mt.avif_parts(pil_bytes(photo(64, 64, 13 + k), "AVIF")) for k in range(3)]
    small = [mt.avif_parts(pil_bytes(photo(48, 48, 20 + k), "AVIF")) for k in range(4)]
    for parts in (cells + small[:1], small):
        data = avif_grid([p[0] for p in parts], 2, 2, 128, 128, (64, 64), parts[0][1])
        assert _as_pil(data) is None


def _rgba(h: int, w: int, seed: int, **kw) -> bytes:
    return pil_bytes(Image.fromarray(photo(h, w, seed, 4), "RGBA"), "AVIF", **kw)


@needs_oracle
@pytest.mark.parametrize("premultiplied", [True, False])
@pytest.mark.parametrize("size", [(32, 40), (64, 60), (17, 13), (48, 40)])
def test_alpha_of_another_size(size, premultiplied):
    """An alpha item coded at another size than the colour under the
    colour's ispe: scaled to it before libavif un-premultiplies; limited
    range brought to full first."""
    data = _rgba(40, 48, 10, alpha_premultiplied=premultiplied)
    other = _rgba(size[1], size[0], 11, alpha_premultiplied=premultiplied)
    edited = mt.avif_with_alpha_of(data, other)
    assert _as_pil(edited) is None
    assert _as_pil(mt.avif_alpha_limited(edited)) is None


@needs_oracle
@pytest.mark.parametrize("premultiplied", [True, False])
@pytest.mark.parametrize("size", [(32, 40), (24, 20), (96, 80), (50, 41)])
def test_alpha_item_of_another_ispe_fails_as_pil(size, premultiplied):
    """An alpha item whose ispe is not the colour's: libavif scales it to
    its own ispe and then fails it ("Decoding of alpha plane failed"),
    straight or premultiplied; the port, which kept a straight one, fails
    it too."""
    data = _rgba(40, 48, 10, alpha_premultiplied=premultiplied)
    colour, av1c, colr = mt.avif_parts(data)
    _, off, ln = mt._iloc(data)[2]
    meta, _ = mt._primary(data)
    alpha_av1c = [data[s - 8:e] for k, s, e in meta.props if k == b"av1C"][1]
    edited = avif_still(colour, (48, 40), av1c, colr=colr, alpha=(data[off:off + ln], alpha_av1c, size),
                        premultiplied=premultiplied)
    assert _as_pil(edited) == ALPHA_FAILED


@needs_oracle
@pytest.mark.parametrize("seed", range(3))
def test_limited_range_premultiplied_alpha(seed):
    """An alpha item in limited range (its sequence header's color_range
    edited) under premultiplied colour: libavif brings it to full range,
    rounding, then un-premultiplies."""
    data = mt.avif_alpha_limited(_rgba(40, 48, 30 + seed, alpha_premultiplied=True))
    want, premultiplied = oracle.alpha(data)
    got, got_premultiplied = avif.alpha_plane(data)
    assert premultiplied and got_premultiplied
    np.testing.assert_array_equal(got, want)
    assert _as_pil(data) is None


@needs_oracle
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_alpha_limited_to_full_every_code(depth):
    """avifLimitedToFullY on every alpha code of the depth, as libavif
    converts an alpha plane it is handed: a one-row alpha plane of every
    code through an 8-bit still's converter at 8 bits, and the port's
    formula against its definition above."""
    codes = np.arange(1 << depth)
    lo, span, top = 16 << (depth - 8), 219 << (depth - 8), (1 << depth) - 1
    dtype = np.uint8 if depth == 8 else np.uint16
    got = avif._alpha_limited_to_full(codes.astype(dtype), depth).astype(np.int64)
    c_div = [int((int(v) - lo) * top + span // 2) for v in codes]
    want = [min(max(int(n / span), 0), top) for n in c_div]  # C's division truncates toward zero
    assert got.tolist() == want
    if depth == 8:
        data = mt.avif_alpha_limited(_rgba(40, 48, 40, alpha_premultiplied=True))
        raw = avif._frame(avif._read(data)[2].cells[0], None)[0]
        np.testing.assert_array_equal(avif._alpha_limited_to_full(raw, 8), oracle.alpha(data)[0])


def _sequence(seeds, size=(32, 48), rgba=False, **kw) -> bytes:
    frames = [Image.fromarray(photo(*size, s, 4 if rgba else 3), "RGBA" if rgba else "RGB") for s in seeds]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], **kw)
    return buf.getvalue()


@needs_oracle
@pytest.mark.parametrize("seeds", [(1, 2), (3, 10), (4, 5, 6)])
def test_tracks_only_as_pil(seeds):
    """An image sequence of tracks alone (meta stripped, no avif brand):
    the first sample of the AV1 track, as PIL reads it."""
    data = mt._brands_without_avif(mt.avif_meta_stripped(_sequence(seeds)))
    assert b"meta" not in data
    assert _as_pil(data) is None
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(_sequence(seeds)))  # its track, as PIL reads it


@needs_oracle
def test_meta_stripped_but_brand_says_avif():
    """The same with the ftyp kept: its avif brand wants a meta box, so
    libavif's parse fails and PIL identifies no image; the port likewise."""
    data = mt.avif_meta_stripped(_sequence((1, 2)))
    with pytest.raises(Exception, match="cannot identify") as pil_error:
        pil_rgb(data)
    assert type(pil_error.value).__name__ == "UnidentifiedImageError"
    with pytest.raises(codecs.NotThisFormat):
        avif.rgb8(data)
    with pytest.raises(Exception, match="cannot identify"):
        codecs.rgb8(data)


@needs_oracle
@pytest.mark.parametrize("major", [None, b"avif", b"mif1", b"msf1"])
def test_source_rule(major):
    """AVIF_DECODER_SOURCE_AUTO: an `avis` major brand reads the track, an
    `avif` one the primary item, any other the tracks where there are
    some. The item here holds another still than the track's first sample
    (C.20: the port read the item of an `avis` file)."""
    sequence, still = _sequence((7, 8)), pil_bytes(photo(32, 48, 9), "AVIF")
    data = mt.avif_item_replaced(sequence, mt.avif_parts(still)[0], major)
    assert _as_pil(data) is None
    track, item = pil_rgb(sequence), pil_rgb(still)
    assert not np.array_equal(track, item)
    np.testing.assert_array_equal(codecs.rgb8(data), item if major == b"avif" else track)


@needs_oracle
@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("tracks_only", [False, True])
def test_alpha_tracks(premultiplied, tracks_only):
    """An RGBA sequence: the alpha track (auxl to the colour track) and the
    colour track's prem reference to it, as libavif reads them."""
    data = _sequence((3, 4), rgba=True, alpha_premultiplied=premultiplied)
    if tracks_only:
        data = mt._brands_without_avif(mt.avif_meta_stripped(data))
    assert _as_pil(data) is None


@needs_oracle
def test_no_av1_track_is_no_image():
    """A track whose sample description is not av01: libavif finds no
    colour track, and PIL identifies no image."""
    data = mt._brands_without_avif(mt.avif_meta_stripped(_sequence((1, 2))))
    at = data.index(b"av01", data.index(b"stsd"))
    data = data[:at] + b"av02" + data[at + 4:]
    with pytest.raises(Exception, match="cannot identify"):
        pil_rgb(data)
    with pytest.raises(codecs.NotThisFormat):
        avif.rgb8(data)


STEP6_SIZES = ["avif_scaled_up_420.avif", "avif12_scaled_down_444.avif", "avif_prem_alpha_other_size.avif",
               "avif_prem_alpha_limited.avif", "avif_sequence_tracks_only.avif", "avif_sequence_item_differs.avif"]


@needs_oracle
@pytest.mark.parametrize("name", STEP6_SIZES)
def test_step6_fixtures(name):
    """The committed fixtures: planes equal to dav1d's as libavif hands
    them on, RGB to PIL's."""
    data = _fixture(name)
    assert _as_pil(data) is None
    _assert_planes_equal(data)
