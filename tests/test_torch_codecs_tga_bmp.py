"""Port parity, codecs/tga.py, codecs/bmp.py and codecs/ico.py against
PIL's `convert("RGB")` and the JAX package's `load_image`, bit for bit.

TGA: image types 1/2/3 and their RLE forms at every depth PIL opens, colour
maps of 16/24 bits starting past 0, the image-ID field, the four origins,
16-bit colour expanded 5 bits to 8; the maps and depths PIL opens but
cannot load fail as PIL fails. BMP: header sizes 12 to 124, 1-32 bits,
BI_RLE8 / BI_RLE4, the BI_BITFIELDS masks, top-down rows, short palettes,
grey palettes read as PIL reads them, DIB without its file header. ICO
(PNG and DIB entries, the largest chosen) and CUR.
"""
import struct

import numpy as np
import pytest

from torch_codec_encoders import (assert_fails_like_pil, assert_like_pil, bmp_file, bmp_rle, cur_file, photo,
                                  pil_bytes, tga_file)

TGA_CASES = [(1, 8, 24), (1, 8, 16), (9, 8, 24), (9, 8, 16), (2, 16, None), (2, 24, None), (2, 32, None),
             (10, 16, None), (10, 24, None), (10, 32, None), (3, 8, None), (3, 16, None), (11, 8, None),
             (11, 16, None), (3, 1, None)]


@pytest.mark.parametrize("origin", [0, 0x10, 0x20, 0x30])
@pytest.mark.parametrize("kind,depth,map_depth", TGA_CASES)
def test_tga(tmp_path, kind, depth, map_depth, origin):
    rng = np.random.default_rng(kind * 100 + depth + origin)
    h, w = 7, 13
    size = max(1, depth // 8)
    stride = (w * depth + 7) // 8
    px = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    px[2:5] = px[2:3]  # runs for RLE
    cmap = None
    if map_depth:
        px %= 200  # indices inside a map of 3 + 200 entries
        cmap = rng.integers(0, 256, (200, map_depth // 8), dtype=np.uint8)
    data = tga_file(px.reshape(h, -1) if size else px, kind, depth, cmap, map_depth or 24, cmap_start=3,
                    origin=origin, image_id=b"id!", rng=rng)
    assert_like_pil(data, tmp_path, "t.tga")


def test_tga_written_by_pil_and_fifteen_bit_expansion(tmp_path):
    img = photo(33, 29, 1)
    for mode in ("RGB", "RGBA", "L", "P"):
        for rle in ("tga_rle", None):
            assert_like_pil(pil_bytes(img, "TGA", mode, compression=rle), tmp_path, f"{mode}.tga")
    one = tga_file(np.array([[0x1F, 0x00, 0x00, 0x7C, 0xE0, 0x03]], np.uint8), 2, 16)
    np.testing.assert_array_equal(assert_like_pil(one)[0], [[0, 0, 255], [255, 0, 0], [0, 255, 0]])


def test_tga_layouts_pil_cannot_load_fail_as_pil_fails():
    px = np.arange(12, dtype=np.uint8).reshape(2, 6)
    cases = [tga_file(px % 4, 1, 8, np.zeros((4, 4), np.uint8), 32),  # a 32-bit map
             tga_file(px % 4, 1, 8, np.zeros((254, 3), np.uint8), 24, cmap_start=3),  # past 256 entries
             tga_file(px, 2, 24, np.zeros((4, 3), np.uint8), 24),  # a map on true colour
             tga_file(px, 1, 8)]  # type 1 without a map
    for data in cases:
        assert_fails_like_pil(data)


def test_tga_whose_first_bytes_look_like_pcx():
    """An image-ID field of 10 bytes makes a TGA's first two bytes PCX's
    magic: PIL tries PCX first. Shorter than PCX's 68-byte header it goes on
    to TGA and decodes; longer, PCX fails it ("unknown PCX mode")."""
    rng = np.random.default_rng(3)
    short = tga_file(rng.integers(0, 256, (2, 9), dtype=np.uint8), 2, 24, image_id=bytes(10))
    assert len(short) < 68
    assert_like_pil(short)
    long = tga_file(rng.integers(0, 256, (10, 30), dtype=np.uint8), 2, 24, image_id=bytes(10))
    assert_fails_like_pil(long)


BMP_CASES = [(40, 1, 0), (40, 4, 0), (40, 8, 0), (40, 16, 0), (40, 24, 0), (40, 32, 0), (12, 1, 0), (12, 4, 0),
             (12, 8, 0), (12, 24, 0), (40, 8, 1), (40, 4, 2), (40, 16, 3), (52, 16, 3), (56, 32, 3), (108, 32, 3),
             (124, 24, 3), (124, 8, 0), (64, 24, 0)]


@pytest.mark.parametrize("header,bits,compression,top_down", [
    c + (t,) for c in BMP_CASES for t in (False, True) if not (t and (c[0] == 12 or c[2] in (1, 2)))])
def test_bmp(tmp_path, header, bits, compression, top_down):
    """OS/2 headers and RLE bitmaps have no top-down form."""
    rng = np.random.default_rng(header + bits + compression)
    h, w = 6, 11
    masks = None
    if compression == 3:
        masks = {16: (0xF800, 0x7E0, 0x1F, 0), 24: (0xFF0000, 0xFF00, 0xFF, 0),
                 32: (0xFF000000, 0xFF00, 0xFF, 0xFF0000)}[bits]
        if header == 108:
            masks = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    palette = rng.integers(0, 256, (1 << bits, 3)) if bits <= 8 else None
    if compression in (1, 2):
        idx = rng.integers(0, 1 << bits, (h, w))
        idx[1:3] = idx[1]
        px = bmp_rle(idx, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        px = rng.integers(0, 256, stride * h, dtype=np.uint8).tobytes()
    data = bmp_file(px, w, h, bits, header, compression, palette, masks, top_down)
    assert_like_pil(data, tmp_path, "b.bmp")
    if compression != 1:
        assert_like_pil(data[14:])  # the same bitmap as a DIB, after its file header


@pytest.mark.parametrize("rle4", [False, True])
def test_bmp_rle_delta_and_early_end(rle4):
    """PIL's RLE decoder reads a delta escape (0, 2) as four bytes, the
    offsets the last two, and fills the skipped pixels with index 0; a
    bitmap whose codes end before its last pixel is too short for PIL."""
    rng = np.random.default_rng(9 + rle4)
    run = bytes([5, 0x21 if rle4 else 7])
    delta = bytes([0, 2, 9, 9, 3, 1])  # PIL skips 9, 9 and moves 3 right, 1 up
    absolute = bytes([0, 4, 0x12, 0x34]) if rle4 else bytes([0, 3, 1, 2, 3, 0])
    head = run + delta + absolute + bytes([0, 0]) + run
    palette = rng.integers(0, 256, (16 if rle4 else 256, 3))
    kw = dict(compression=2 if rle4 else 1, palette=palette)
    full = head + (bytes([0, 0, 12, 0x45 if rle4 else 9])) * 3 + bytes([0, 1])  # runs stop at a row's end
    assert_like_pil(bmp_file(full, 12, 5, 4 if rle4 else 8, **kw))
    assert_fails_like_pil(bmp_file(head + bytes([0, 1]), 12, 5, 4 if rle4 else 8, **kw))


def test_bmp_palettes_and_pil_writer(tmp_path):
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, 4 * 5, dtype=np.uint8).tobytes()
    short = bmp_file(px, 4, 5, 8, palette=rng.integers(0, 256, (100, 3)), colors=100)  # indices past it: black
    grey2 = bmp_file(px, 4, 5, 8, palette=np.array([[0, 0, 0], [255, 255, 255]]), colors=2)  # read as bits
    grey = bmp_file(px, 4, 5, 8, palette=np.repeat(np.arange(256)[:, None], 3, 1))
    for data in (short, grey2, grey):
        assert_like_pil(data)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        assert_like_pil(pil_bytes(photo(9, 10, 2), "BMP", mode), tmp_path, f"{mode}.bmp")
    bad = bmp_file(px, 4, 5, 16, compression=3, masks=(0xF00, 0xF0, 0xF, 0))  # masks PIL has no unpacker for
    assert_fails_like_pil(bad)


@pytest.mark.parametrize("fmt,mode", [("png", "RGBA")] + [("bmp", m) for m in ("RGBA", "RGB", "P", "L", "1")])
def test_ico(tmp_path, fmt, mode):
    img = photo(32, 32, 3, 4)
    from PIL import Image

    data = pil_bytes(Image.fromarray(img, "RGBA"), "ICO", mode if fmt == "bmp" else None,
                     sizes=[(16, 16), (32, 32), (24, 24)], bitmap_format=fmt)
    assert_like_pil(data, tmp_path, "i.ico")


@pytest.mark.parametrize("order", [0, 1])
def test_cur(order):
    entries = [(8, 8, 24), (16, 16, 8), (12, 20, 32)]
    assert_like_pil(cur_file(entries[::-1] if order else entries, np.random.default_rng(order)))


def test_dib_header_sizes_pil_does_not_read():
    data = struct.pack("<I", 40) + bytes(60)  # a DIB of width 0 and 0 bits
    assert_fails_like_pil(data)
