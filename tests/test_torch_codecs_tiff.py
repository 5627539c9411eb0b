"""Port parity, codecs/tiff.py and codecs/lzw.py against PIL's
`convert("RGB")` (PIL's own decoder for uncompressed data, libtiff for the
rest) and the JAX package's `load_image`, bit for bit.

A TIFF writer in tests/torch_codec_encoders.py covers compression none,
LZW, Deflate (8 and 32946) and PackBits, predictor 2 at 8 / 16 / 32 bits,
strips and tiles, planar configuration 1 and 2, II and MM, fill order 2,
classic and BigTIFF; photometric 0, 1, 2, 3 and 5 at the depths and extra
samples PIL's table maps (associated and unassociated alpha), signed and
float samples. JPEG-compressed strips (PIL's RGB files, and YCbCr ones
split into JPEGTables and strips) go through the port's JPEG decoder.
Layouts PIL's libtiff decoder fails (planar RGBX, big-endian BigTIFF)
fail the same way.
"""
import numpy as np
import pytest

from torch_codec_encoders import assert_as_pil, assert_fails_like_pil, assert_like_pil, photo, pil_bytes, tiff_file

LAYOUTS = [(0, 1, 1, (), 1), (1, 1, 1, (), 1), (0, 2, 1, (), 1), (1, 4, 1, (), 1), (0, 8, 1, (), 1),
           (1, 8, 1, (), 1), (1, 8, 1, (), 2), (1, 16, 1, (), 1), (0, 16, 1, (), 1), (1, 16, 1, (), 2),
           (1, 32, 1, (), 1), (1, 32, 1, (), 2), (1, 32, 1, (), 3), (0, 32, 1, (), 3), (1, 8, 2, (2,), 1),
           (2, 8, 3, (), 1), (2, 8, 4, (0,), 1), (2, 8, 4, (1,), 1), (2, 8, 4, (2,), 1), (2, 8, 4, (), 1),
           (2, 8, 5, (1, 0), 1), (2, 16, 3, (), 1), (2, 16, 4, (1,), 1), (2, 16, 4, (2,), 1), (3, 1, 1, (), 1),
           (3, 4, 1, (), 1), (3, 8, 1, (), 1), (5, 8, 4, (), 1), (5, 16, 4, (), 1)]


def _samples(photo_, bits, spp, fmt, rng, h=9, w=13):
    if fmt == 3:
        s = (rng.random((h, w, spp)) * 400 - 100).astype(np.float32)
        s[0, 0] = np.nan
        return s
    if fmt == 2:
        return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, spp))
    s = rng.integers(0, 1 << bits, (h, w, spp), dtype=np.uint64)
    s[3:6] = s[3:4]
    if photo_ == 2 and spp >= 4:
        s[..., :3] = np.minimum(s[..., :3], s[..., 3:4])  # associated alpha: colour at most alpha
    return s


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("photo_,bits,spp,extra,fmt", LAYOUTS)
def test_layouts_and_compressions(tmp_path, photo_, bits, spp, extra, fmt, compression, order):
    rng = np.random.default_rng(bits * 7 + spp + compression + ord(order))
    s = _samples(photo_, bits, spp, fmt, rng)
    cmap = rng.integers(0, 65536, (1 << bits, 3)) if photo_ == 3 else None
    data = tiff_file(s, bits, photo_, order, compression, rows_per_strip=4, extra=extra, sample_format=fmt,
                     colormap=cmap)
    read = assert_as_pil(data, tmp_path, "t.tif")  # PIL's table lacks some layouts in one byte order
    assert read or order == ">"


@pytest.mark.parametrize("compression", [5, 8, 32946])
@pytest.mark.parametrize("bits,photo_,spp,fmt", [(8, 2, 3, 1), (16, 1, 1, 1), (32, 1, 1, 1), (16, 2, 4, 1),
                                                 (8, 5, 4, 1), (32, 1, 1, 3), (16, 1, 1, 2)])
@pytest.mark.parametrize("order", ["<", ">"])
def test_predictor(bits, photo_, spp, fmt, compression, order):
    rng = np.random.default_rng(bits + spp + compression)
    s = _samples(photo_, bits, spp, fmt, rng)
    assert assert_as_pil(tiff_file(s, bits, photo_, order, compression, predictor=2, rows_per_strip=3,
                                   sample_format=fmt)) or order == ">"


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("planar", [1, 2])
def test_tiles_planes_bigtiff_fill_order(compression, planar):
    rng = np.random.default_rng(compression + planar)
    s = rng.integers(0, 256, (21, 35, 3), dtype=np.uint8)
    assert_like_pil(tiff_file(s, 8, 2, "<", compression, planar=planar, tile=(16, 16)))
    assert_like_pil(tiff_file(s, 8, 2, "<", compression, planar=planar, rows_per_strip=5, big=True))
    assert_like_pil(tiff_file(s[..., :1], 8, 1, "<", compression, rows_per_strip=5, fill_order=2))
    assert_like_pil(tiff_file(s[..., :1] & 1, 1, 0, ">", compression, rows_per_strip=7, fill_order=2))


def test_layouts_pil_fails():
    s = np.random.default_rng(1).integers(0, 256, (6, 7, 4), dtype=np.uint8)
    assert_fails_like_pil(tiff_file(s, 8, 2, "<", 8, planar=2, extra=(0,), rows_per_strip=3))  # planar RGBX
    assert_fails_like_pil(tiff_file(s, 8, 2, "<", 1, planar=2, extra=(1,)))  # planar uncompressed RGBa
    assert_fails_like_pil(tiff_file(s[..., :3], 8, 2, ">", 1, big=True))  # big-endian BigTIFF


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "1", "P", "CMYK", "I;16", "LA", "I", "F"])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "jpeg"])
def test_pil_writer(tmp_path, mode, compression):
    if compression == "jpeg" and mode not in ("RGB", "L"):
        mode = "RGB"  # PIL writes JPEG-compressed TIFF of RGB and grey only
    assert_like_pil(pil_bytes(photo(13, 17, 2), "TIFF", mode, compression=compression), tmp_path, "p.tif")


def _split_tables(jpeg: bytes) -> tuple[bytes, bytes]:
    """A JPEG -> (SOI + its DQT / DHT segments + EOI, SOI + the rest)."""
    pos, tables, rest = 2, b"", b""
    while True:
        marker, length = jpeg[pos + 1], int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            rest += jpeg[pos:]
            break
        if marker in (0xDB, 0xC4):
            tables += jpeg[pos:pos + 2 + length]
        else:
            rest += jpeg[pos:pos + 2 + length]
        pos += 2 + length
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest


def test_jpeg_tiles():
    """JPEG-compressed 16x16 tiles, the edge tiles whole as libtiff writes
    them, YCbCr 4:2:0 after shared tables."""
    img = photo(35, 40, 4)
    pad = np.pad(img, ((0, 13), (0, 8), (0, 0)), mode="edge")
    chunks = [_split_tables(pil_bytes(pad[y:y + 16, x:x + 16], "JPEG", quality=80, subsampling=2))
              for y in range(0, 35, 16) for x in range(0, 40, 16)]
    data = tiff_file(np.zeros((35, 40, 3), np.uint8), 8, 6, "<", 7, tile=(16, 16), jpeg_chunks=[c[1] for c in chunks],
                     jpeg_tables=chunks[0][0], extra_tags={530: (3, [2, 2])})
    assert_like_pil(data)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("photo_", [6, 2])
def test_jpeg_strips(subsampling, split, photo_):
    """YCbCr strips are converted to RGB by libjpeg (PIL asks libtiff for
    RGB); RGB strips are taken as they are, and libtiff fails subsampled
    ones."""
    img = photo(40, 27, 3)
    rows = 16
    chunks = [pil_bytes(img[y:y + rows], "JPEG", quality=85, subsampling=subsampling)
              for y in range(0, 40, rows)]
    tables = None
    if split:
        pairs = [_split_tables(c) for c in chunks]
        tables, chunks = pairs[0][0], [p[1] for p in pairs]
    ss = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[subsampling]
    data = tiff_file(np.zeros((40, 27, 3), np.uint8), 8, photo_, "<", 7, rows_per_strip=rows, jpeg_chunks=chunks,
                     jpeg_tables=tables, extra_tags={530: (3, list(ss))})
    if photo_ == 2 and subsampling:
        assert_fails_like_pil(data)
    else:
        assert_like_pil(data)
