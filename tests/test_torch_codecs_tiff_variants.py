"""Port parity, the TIFF variants of codecs/tiff.py, codecs/ccitt.py and
codecs/lzw.py against PIL's `convert("RGB")` (libtiff beneath it) and the
JAX package's `load_image`, bit for bit.

Orientation 2-8 (and values PIL ignores) on every path, the floating-point
predictor (3) on 32-bit floats in both byte orders, under LZW, Deflate and
LZMA, PIL's F -> L clamp of NaN and the infinities; 12-bit grey; CIELAB;
JPEG-compressed CMYK; tiled 16-bit planar uncompressed samples (PIL's
byte-per-sample reading and its strides); LZMA; old-style (LSB-first) LZW;
ThunderScan; CCITT modified Huffman, RLE-W (libtiff's own alignment, which
its writer does not share: the port reads PIL's files as libtiff misreads
them), Group 3 1-D and 2-D with and without EOL fill, Group 4, fill order
2, runs past 2560 pixels; YCbCr without JPEG (libtiff's RGBA reader over
every subsampling, PIL's raw reading of uncompressed ones). The
compressions PIL does not know or cannot decode fail as PIL fails them;
ZSTD (codecs/zstd.py) over PIL's own frames and a hand-made one; old-style
JPEG (6) through JPEGInterchangeFormat and from TIFF 6.0's table tags, over
several strips (each a restart interval) and of one sample; JPEG (7) in
separate planes and under PIL's raw modes L;I and P.
"""
import numpy as np
import pytest

from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io import image as timg
from torch_codec_encoders import (assert_as_pil, assert_fails_like_pil, assert_like_pil, photo, pil_bytes, pil_rgb,
                                  ojpeg_tables_tiff, ojpeg_tiff, tiff_file, tiff_raw_strip, ycbcr_tiff,
                                  zstd_simple_frame)


@pytest.mark.parametrize("orientation", range(0, 10))
def test_orientation(tmp_path, orientation):
    ph = photo(9, 13, 1)
    tag = {274: (3, [orientation])}
    got = assert_like_pil(tiff_file(ph, 8, 2, "<", 5, rows_per_strip=4, extra_tags=tag), tmp_path, "o.tif")
    assert got.shape == ((13, 9, 3) if orientation in (5, 6, 7, 8) else (9, 13, 3))
    assert_like_pil(tiff_file(ph, 8, 2, ">", 8, planar=2, tile=(16, 16), extra_tags=tag))
    assert_like_pil(tiff_file(ph[..., :1] // 64, 2, 1, "<", 1, extra_tags=tag))


@pytest.mark.parametrize("orientation", [3, 5, 6, 8])
def test_orientation_jpeg_ccitt_and_libtiffs_rgba_reader(orientation):
    """Through libtiff's RGBA reader too (YCbCr without JPEG, old-style
    JPEG): it leaves the raster upright, and PIL turns it by the tag."""
    from PIL import Image

    ph = photo(12, 20, 2)
    tag = {274: (3, [orientation])}
    assert_like_pil(pil_bytes(Image.fromarray(ph), "TIFF", compression="jpeg", tiffinfo={274: orientation}))
    assert_like_pil(pil_bytes(Image.fromarray(ph).convert("1"), "TIFF", compression="group4",
                              tiffinfo={274: orientation}))
    ycc = np.random.default_rng(orientation).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    assert_like_pil(ycbcr_tiff(ycc, (2, 2), 5, 4, extra_tags=tag))
    assert_like_pil(ojpeg_tiff(pil_bytes(photo(9, 13, 3), "JPEG", quality=85), 9, 13, extra_tags=tag))


def _floats(rng, shape=(9, 13, 1)):
    f = (rng.random(shape) * 400 - 100).astype(np.float32)
    f[0, :6, 0] = [np.nan, np.inf, -np.inf, -3.7, 127.5, 254.99]
    return f


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", [5, 8, 32946, 34925])
def test_float_predictor(order, compression):
    rng = np.random.default_rng(compression)
    f = _floats(rng)
    assert_like_pil(tiff_file(f, 32, 1, order, compression, predictor=3, sample_format=3, rows_per_strip=4))
    assert_like_pil(tiff_file(f, 32, 1, order, compression, predictor=3, sample_format=3, tile=(16, 16)))


def test_float_predictor_pil_writer_and_clamps():
    from PIL import Image

    f = np.array([[-3.7, 0.4, 127.5, 300.2, np.nan, np.inf, -np.inf, 254.99]], np.float32)
    for compression in ("tiff_lzw", "tiff_adobe_deflate", "lzma"):
        got = assert_like_pil(pil_bytes(Image.fromarray(f), "TIFF", compression=compression, tiffinfo={317: 3}))
        np.testing.assert_array_equal(got[0, :4, 0], [0, 0, 127, 255])
    # 16-bit grey (PIL's I;16) clamps on the way to RGB
    got = assert_like_pil(tiff_file(np.array([[[0], [255], [256], [65535]]], np.uint16), 16, 1, "<", 5))
    np.testing.assert_array_equal(got[0, :, 0], [0, 255, 255, 255])


def test_predictors_libtiff_refuses():
    ph = photo(5, 7, 3)
    assert_fails_like_pil(tiff_file(ph[..., :1], 8, 1, "<", 5, predictor=3))  # the float predictor on integers
    assert_fails_like_pil(tiff_file(ph[..., :1], 8, 1, "<", 5, predictor=4))


@pytest.mark.parametrize("width", [13, 14])
def test_twelve_bit_grey(tmp_path, width):
    rng = np.random.default_rng(width)
    v = rng.integers(0, 400, (7, width))
    bits = ((v[..., None] >> np.arange(11, -1, -1)) & 1).reshape(7, -1).astype(np.uint8)
    assert_like_pil(tiff_raw_strip(np.packbits(bits, axis=1).tobytes(), width, 7, 12, 1), tmp_path, "i12.tif")


@pytest.mark.parametrize("compression", [1, 5, 32773])
@pytest.mark.parametrize("order", ["<", ">"])
def test_cielab(compression, order):
    rng = np.random.default_rng(compression)
    lab = rng.integers(0, 256, (11, 17, 3), dtype=np.uint8)
    assert_like_pil(tiff_file(lab, 8, 8, order, compression, rows_per_strip=4))


@pytest.mark.parametrize("quality", [60, 95])
def test_jpeg_cmyk(tmp_path, quality):
    from PIL import Image

    assert_like_pil(pil_bytes(Image.fromarray(photo(19, 26, 4, 4), "CMYK"), "TIFF", compression="jpeg",
                              quality=quality), tmp_path, "cmyk.tif")
    assert_like_pil(pil_bytes(Image.fromarray(photo(19, 26, 4)).convert("CMYK"), "TIFF", compression="jpeg"))


@pytest.mark.parametrize("mode", ["RGBA", "RGBX", "LA"])
def test_jpeg_alpha_and_pad_samples(mode):
    """JPEG strips of four or two components (libjpeg keeps them raw)."""
    from PIL import Image

    im = Image.fromarray(photo(16, 24, 2, 4), "RGBA").convert(mode)
    assert_like_pil(pil_bytes(im, "TIFF", compression="jpeg"))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("extra,spp", [((), 3), ((2,), 4), ((0,), 4)])
def test_tiled_16bit_planes_uncompressed(order, extra, spp):
    rng = np.random.default_rng(spp)
    s = rng.integers(0, 65536, (37, 40, spp), dtype=np.uint64)
    assert_as_pil(tiff_file(s, 16, 2, order, 1, planar=2, tile=(16, 16), extra=extra))
    assert_as_pil(tiff_file(s[:16, :16], 16, 2, order, 1, planar=2, tile=(16, 16), extra=extra))


@pytest.mark.parametrize("order", ["<", ">"])
def test_lzma_and_old_lzw(tmp_path, order):
    from PIL import Image

    ph = photo(21, 17, 5)
    assert_like_pil(tiff_file(ph, 8, 2, order, 34925, predictor=2, rows_per_strip=8), tmp_path, "lzma.tif")
    assert_like_pil(pil_bytes(Image.fromarray(ph), "TIFF", compression="lzma"))
    assert_like_pil(tiff_file(ph, 8, 2, order, 5, old_lzw=True, rows_per_strip=8), tmp_path, "old.tif")
    big = np.random.default_rng(1).integers(0, 256, (40, 64, 3), dtype=np.uint8)  # codes past 9 and 10 bits
    assert_like_pil(tiff_file(big, 8, 2, order, 5, old_lzw=True))


@pytest.mark.parametrize("photometric", [0, 1, 3])
def test_thunderscan(photometric):
    rng = np.random.default_rng(photometric)
    v = (photo(13, 22, photometric)[..., :1] // 16).astype(np.uint8)
    v[4:7] = 9
    cmap = rng.integers(0, 65536, (16, 3)) if photometric == 3 else None
    assert_like_pil(tiff_file(v, 4, photometric, ">", 32809, rows_per_strip=5, colormap=cmap))


def _ink(h=37, w=45, seed=5):
    from PIL import Image

    return Image.fromarray(photo(h, w, seed)).convert("1")


def _wide_runs():
    """Rows of runs of every terminating and make-up length, past 2560."""
    from PIL import Image

    rng = np.random.default_rng(3)
    lens = list(range(64)) + [64 * k + j for k in range(1, 41) for j in (0, 5)]
    rows = []
    for r in range(4):
        rng.shuffle(lens)
        row, pos, c = np.zeros(2700, np.uint8), 0, r % 2
        for n in lens:
            row[pos:pos + n] = c
            pos += n
            c ^= 1
            if pos >= 2700:
                break
        rows.append(row)
    return Image.fromarray(np.array(rows) * 255).convert("1")


@pytest.mark.parametrize("compression,info", [("tiff_ccitt", {}), ("tiff_raw_16", {}), ("group3", {}),
                                              ("group3", {292: 1}), ("group3", {292: 4}), ("group3", {292: 5}),
                                              ("group4", {}), ("group4", {266: 2}), ("group3", {266: 2}),
                                              ("tiff_ccitt", {266: 2})])
def test_ccitt(tmp_path, compression, info):
    for im in (_ink(), _ink(9, 70, 8), _wide_runs()):
        data = pil_bytes(im, "TIFF", compression=compression, tiffinfo=info)
        assert_like_pil(data, tmp_path, "fax.tif")
    from optixpathtracer_tpu_torch.io.codecs import tiff

    tags = tiff._ifd(data)[1]
    assert tags[259][0] == {"tiff_ccitt": 2, "tiff_raw_16": 32771, "group3": 3, "group4": 4}[compression]
    if 292 in info:
        assert tags[292][0] == info[292]  # libtiff wrote the options asked for (2-D rows for bit 0)


def test_ccitt_photometric_and_strips():
    im = _ink(30, 33, 9)
    for photometric in (0, 1):
        for rows in (7, 30):
            assert_like_pil(pil_bytes(im, "TIFF", compression="group4", tiffinfo={262: photometric, 278: rows}))
            assert_like_pil(pil_bytes(im, "TIFF", compression="group3", tiffinfo={262: photometric, 278: rows,
                                                                                  292: 1}))


@pytest.mark.parametrize("compression", [34712, 34887, 12345])
def test_compressions_pil_does_not_know(compression):
    """Codes outside PIL's table: no TIFF PIL opens, and nothing else takes
    the bytes (PIL's UnidentifiedImageError)."""
    data = tiff_file(photo(4, 5, 1), 8, 2, "<", 1, extra_tags={259: (3, [compression])})
    assert_fails_like_pil(data)
    with pytest.raises(codecs.UnidentifiedImageError):
        timg.rgb8_from_bytes(data)


@pytest.mark.parametrize("compression", [34676, 34677, 50001])
def test_compressions_pil_cannot_decode(compression):
    data = tiff_file(photo(4, 5, 1), 8, 2, "<", 1, extra_tags={259: (3, [compression])})
    assert_fails_like_pil(data)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 34925])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)])
def test_ycbcr_without_jpeg(compression, sub):
    """Compressed: libtiff's RGBA reader (TIFFYCbCrtoRGB on each data unit;
    4x4 blocks an odd count across lose their last bytes to libtiff's
    scanline rounding). Uncompressed: PIL's raw decoder reads four bytes a
    pixel, RGBX, so files it runs short of fail, as PIL's own writer's do."""
    rng = np.random.default_rng(sub[0] * 3 + sub[1])
    for shape, rows in (((8, 12), 4), ((9, 13), 8), ((16, 16), 16)):
        ycc = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        assert_as_pil(ycbcr_tiff(ycc, sub, compression, rows))


@pytest.mark.parametrize("compression", [1, 5, 8])
@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
def test_ycbcr_planes_and_tiles(compression, sub):
    """Separate planes (libtiff converts them without subsampling only; PIL
    reads uncompressed ones as RGB planes) and uncompressed tiles (PIL's
    RGBX rows, three bytes a pixel apart at the right edge)."""
    rng = np.random.default_rng(compression)
    for shape in ((9, 13), (20, 37), (40, 40)):
        ycc = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        for tile in (None, (16, 16)):
            assert_as_pil(tiff_file(ycc, 8, 6, ">", compression, planar=2, rows_per_strip=4, tile=tile,
                                    extra_tags={530: (3, list(sub))}))
            if compression == 1:
                assert_as_pil(tiff_file(ycc, 8, 6, "<", 1, rows_per_strip=4, tile=tile,
                                        extra_tags={530: (3, list(sub))}))


def test_ycbcr_reference_and_coefficients(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(7)
    ycc = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    ref = {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
    assert_like_pil(ycbcr_tiff(ycc, (2, 2), 5, 4, extra_tags=ref), tmp_path, "ycc.tif")
    luma = {529: (5, [2990, 10000, 5870, 10000, 1140, 10000])}
    assert_like_pil(ycbcr_tiff(ycc, (2, 1), 8, 4, extra_tags=luma))
    assert_as_pil(pil_bytes(Image.fromarray(ycc, "YCbCr"), "TIFF"))  # PIL's own writer: PIL cannot read it


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("split", [False, True])
def test_old_style_jpeg(tmp_path, subsampling, split):
    """Compression 6 through JPEGInterchangeFormat: the whole stream there,
    or its header there and its scan as the strip; libtiff's OJPEG hands
    the components on without upsampling and its RGBA reader converts
    them. Frames OJPEG does not take, and a grey stream under three
    samples, fail as PIL fails them."""
    rng = np.random.default_rng(subsampling)
    for shape in ((19, 29), (16, 24)):
        jp = pil_bytes(photo(*shape, int(rng.integers(9))), "JPEG", quality=80, subsampling=subsampling)
        assert_like_pil(ojpeg_tiff(jp, *shape, split, "<>"[split]), tmp_path if subsampling == 2 else None, "oj.tif")
    ref = {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
    assert_like_pil(ojpeg_tiff(pil_bytes(photo(9, 13, 1), "JPEG", quality=60, optimize=True), 9, 13, split,
                               extra_tags=ref))
    if not split:
        for bad in (pil_bytes(photo(9, 13, 1), "JPEG", progressive=True), pil_bytes(photo(9, 13, 1), "JPEG", "L"),
                    pil_bytes(photo(9, 13, 1), "JPEG", "CMYK")):
            assert_fails_like_pil(ojpeg_tiff(bad, 9, 13))


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("order", ["<", ">"])
def test_old_style_jpeg_from_tables(tmp_path, quality, order):
    """TIFF 6.0's own old-style JPEG: JPEGProc, JPEGQTables, JPEGDCTables
    and JPEGACTables, the scan's entropy-coded data as the strip; the port
    builds the stream libtiff builds."""
    for shape in ((16, 24), (19, 29)):
        for optimize in (False, True):
            jp = pil_bytes(photo(*shape, quality), "JPEG", quality=quality, subsampling=2, optimize=optimize)
            assert_like_pil(ojpeg_tables_tiff(jp, *shape, order), tmp_path, "ojt.tif")


@pytest.mark.parametrize("shape, rows", [((48, 40), 16), ((40, 37), 16), ((64, 24), 32)])
def test_old_style_jpeg_from_tables_over_strips(tmp_path, shape, rows):
    """Table tags over several strips: libtiff's OJPEG takes each strip as
    a restart interval of its MCUs (its own RST between strips), whatever
    JPEGRestartInterval says where it is absent, 0 or the strip's MCUs. In
    big-endian files libtiff decodes the inner strips otherwise: A.1."""
    img = photo(*shape, 3)
    jp = pil_bytes(img, "JPEG", quality=80, subsampling=2, restart_marker_rows=rows // 16)
    mcus = -(-shape[1] // 16) * (rows // 16)
    for restart in (None, 0, mcus):
        assert_like_pil(ojpeg_tables_tiff(jp, *shape, rows_per_strip=rows, restart=restart), tmp_path, "ojs.tif")
    big = ojpeg_tables_tiff(jp, *shape, ">", rows_per_strip=rows)
    assert pil_rgb(big).shape == (*shape, 3)
    with pytest.raises(NotImplementedError, match="A.1"):
        timg.rgb8_from_bytes(big)


@pytest.mark.parametrize("photometric", [0, 1, 2, 3, 5, 6])
def test_old_style_jpeg_one_sample(tmp_path, photometric):
    """Compression 6 of one sample: PIL reads it as YCbCr's L and libtiff
    hands on the one component, grey whatever the photometric tag says,
    but refuses the directory under RGB or YCbCr; a three-component
    stream under one sample fails."""
    grey = pil_bytes(photo(16, 24, 1)[..., 0], "JPEG", "L", quality=80)
    one = {258: (3, [8]), 277: (3, [1]), 262: (3, [photometric])}
    data = ojpeg_tiff(grey, 16, 24, extra_tags=one)
    if photometric in (2, 6):
        assert_fails_like_pil(data)
    else:
        assert_like_pil(data, tmp_path if photometric == 1 else None, "oj1.tif")
        assert_like_pil(ojpeg_tiff(grey, 16, 24, True, ">", extra_tags=one))
    if photometric == 1:
        assert_fails_like_pil(ojpeg_tiff(pil_bytes(photo(16, 24, 1), "JPEG"), 16, 24, extra_tags=one))


@pytest.mark.parametrize("spp, photometric", [(1, 1), (2, 1), (3, 2), (4, 2), (3, 6)])
def test_jpeg_in_planes(tmp_path, spp, photometric):
    """JPEG (7) in separate planes: one grey stream a plane and strip,
    put together as PIL's libtiff decoder does; YCbCr planes fail, as
    libtiff converts YCbCr to RGB on contiguous samples only."""
    px = photo(16, 24, 1)
    px = np.concatenate([px, px[..., :1]], -1)[..., :spp]
    extra = (2,) if spp in (2, 4) else ()
    chunks = [pil_bytes(px[y:y + 8, :, i], "JPEG", "L", quality=90) for i in range(spp) for y in (0, 8)]
    data = tiff_file(px, 8, photometric, "<", 7, planar=2, jpeg_chunks=chunks, rows_per_strip=8, extra=extra)
    if photometric == 6:
        assert_fails_like_pil(data)
    else:
        assert_like_pil(data, tmp_path if spp == 3 else None, "planes.tif")


def test_jpeg_raw_modes():
    """JPEG (7) under PIL's raw modes beyond RGB / L / CMYK: white-is-zero
    grey (L;I, inverted) and a palette (P, through the colour map) decode
    as PIL's unpackers read libtiff's bytes; 16-bit and 1-bit samples fail,
    as libtiff's JPEG codec refuses them."""
    px = photo(16, 24, 1)
    grey = pil_bytes(px[..., 0], "JPEG", "L", quality=90)
    cmap = np.random.default_rng(0).integers(0, 65536, (256, 3))
    assert_like_pil(tiff_file(px[..., :1], 8, 0, "<", 7, jpeg_chunks=[grey], rows_per_strip=16))
    assert_like_pil(tiff_file(px[..., :1], 8, 3, ">", 7, jpeg_chunks=[grey], rows_per_strip=16, colormap=cmap))
    assert_like_pil(tiff_file(px[..., :1], 8, 0, "<", 7, planar=2, jpeg_chunks=[grey], rows_per_strip=16))
    assert_fails_like_pil(tiff_file(px[..., :1].astype(np.uint16), 16, 1, "<", 7, jpeg_chunks=[grey],
                                    rows_per_strip=16))
    assert_fails_like_pil(tiff_file(px[..., :1] > 128, 1, 1, "<", 7, jpeg_chunks=[grey], rows_per_strip=16))


def _zstd_images():
    from PIL import Image

    rng = np.random.default_rng(0)
    return {"photo": photo(37, 45, 1), "noise": rng.integers(0, 256, (20, 30, 3), dtype=np.uint8),
            "levels": (rng.integers(0, 4, (64, 64, 3)) * 60).astype(np.uint8),
            "stripes": np.repeat(rng.integers(0, 256, (64, 1, 3), dtype=np.uint8), 64, 1),
            "big": photo(160, 200, 2),
            "float": Image.fromarray(photo(20, 30, 3)[..., 0].astype(np.float32) * 1.7 - 9)}


ZSTD = _zstd_images()


@pytest.mark.parametrize("name", list(ZSTD))
@pytest.mark.parametrize("rows", [None, 2])
def test_zstd(tmp_path, name, rows):
    """libtiff's ZSTD frames as PIL writes them: raw and Huffman literals in
    one and four streams, FSE-coded weights, predefined, RLE, FSE-coded and
    repeated sequence tables, the repeat offsets; under predictor 2 (3 for
    floats), in strips of 2 rows and whole."""
    info = {317: 3 if name == "float" else 2}
    if rows:
        info[278] = rows
    img = ZSTD[name]
    assert_like_pil(pil_bytes(img, "TIFF", compression="zstd"), tmp_path if name == "photo" else None, "z.tif")
    assert_like_pil(pil_bytes(img, "TIFF", compression="zstd", tiffinfo=info))


def test_zstd_block_types():
    """Raw and RLE blocks and RLE literals, from a hand-made frame."""
    data = bytes(range(40)) + bytes([200]) * 50 + bytes([17]) * 30
    frame = zstd_simple_frame(data, 40)
    assert_like_pil(tiff_raw_strip(frame, 12, 10, 8, 1, compression=50000))
    assert_fails_like_pil(tiff_raw_strip(frame[:-6], 12, 10, 8, 1, compression=50000))
