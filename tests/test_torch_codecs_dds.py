"""Port parity, codecs/dds.py against PIL's `convert("RGB")` (Pillow's
BcnDecode.c) and the JAX package's `load_image`, bit for bit.

Every 8- or 16-byte pattern is a valid BCn block, so DDS headers over
random block bytes hold the port's block decoders to PIL's across their
whole mode space: BC1 (both colour modes), BC2, BC3, BC4, BC5 (unsigned and
signed), BC7 with each of its eight modes forced in turn, by FourCC and by
the DX10 header, at sizes that are not multiples of 4. Then the
uncompressed layouts (bit masks, luminance, palettes, R8G8B8A8) and PIL's
own DDS writer. BC6H (UF16 and SF16) decodes as PIL decodes it.
"""
import numpy as np
import pytest

from torch_codec_encoders import assert_like_pil, dds_file, photo, pil_bytes

BLOCKS = {b"DXT1": 8, b"DXT3": 16, b"DXT5": 16, b"ATI1": 8, b"BC4U": 8, b"ATI2": 16, b"BC5U": 16, b"BC5S": 16}
DXGI = {71: 8, 74: 16, 77: 16, 80: 8, 83: 16, 84: 16, 98: 16, 70: 8}


def _blocks(w, h, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (((w + 3) // 4) * ((h + 3) // 4), size), dtype=np.uint8)


@pytest.mark.parametrize("size", [(16, 12), (13, 7), (1, 1)])
@pytest.mark.parametrize("fourcc", list(BLOCKS))
def test_fourcc_random_blocks(tmp_path, fourcc, size):
    w, h = size
    data = dds_file(w, h, _blocks(w, h, BLOCKS[fourcc], len(fourcc) + w).tobytes(), fourcc)
    assert_like_pil(data, tmp_path, "f.dds")


@pytest.mark.parametrize("dxgi", list(DXGI))
def test_dx10_random_blocks(dxgi):
    w, h = 22, 18
    assert_like_pil(dds_file(w, h, _blocks(w, h, DXGI[dxgi], dxgi).tobytes(), dxgi=dxgi))


@pytest.mark.parametrize("mode", range(9))
def test_bc7_every_mode(mode):
    """Mode m is the lowest set bit of byte 0; 8 is the all-zero byte (black)."""
    blocks = _blocks(40, 40, 16, 100 + mode)
    if mode < 8:
        blocks[:, 0] = (blocks[:, 0] & np.uint8(0xFF ^ ((1 << (mode + 1)) - 1))) | np.uint8(1 << mode)
    else:
        blocks[:, 0] = 0
    assert_like_pil(dds_file(37, 39, blocks.tobytes(), dxgi=98))


def test_uncompressed_layouts(tmp_path):
    rng = np.random.default_rng(5)
    w, h = 9, 7
    cases = []
    for bits, flags, masks in ((16, 0x40, (0xF800, 0x7E0, 0x1F, 0)), (16, 0x41, (0x7C00, 0x3E0, 0x1F, 0x8000)),
                               (16, 0x41, (0xF00, 0xF0, 0xF, 0xF000)), (24, 0x40, (0xFF0000, 0xFF00, 0xFF, 0)),
                               (32, 0x41, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                               (32, 0x41, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000))):
        body = rng.integers(0, 256, w * h * bits // 8, dtype=np.uint8).tobytes()
        cases.append(dds_file(w, h, body, pf_flags=flags, bitcount=bits, masks=masks))
    cases.append(dds_file(w, h, rng.integers(0, 256, w * h, dtype=np.uint8).tobytes(), pf_flags=0x20000,
                          bitcount=8))
    cases.append(dds_file(w, h, rng.integers(0, 256, 2 * w * h, dtype=np.uint8).tobytes(), pf_flags=0x20001,
                          bitcount=16))
    cases.append(dds_file(w, h, rng.integers(0, 256, 1024 + w * h, dtype=np.uint8).tobytes(), pf_flags=0x20))
    cases.append(dds_file(w, h, rng.integers(0, 256, 4 * w * h, dtype=np.uint8).tobytes(), dxgi=28))
    for i, data in enumerate(cases):
        assert_like_pil(data, tmp_path, f"u{i}.dds")


@pytest.mark.parametrize("fmt,mode", [("DXT1", "RGBA"), ("DXT3", "RGBA"), ("DXT5", "RGBA"), ("BC5", "RGB"),
                                      (None, "RGBA"), (None, "RGB"), (None, "L")])
def test_pil_writer(fmt, mode):
    kw = {"pixel_format": fmt} if fmt else {}
    assert_like_pil(pil_bytes(photo(20, 28, 6, 4)[..., :3], "DDS", mode, **kw))


@pytest.mark.parametrize("dxgi", [95, 96])
@pytest.mark.parametrize("mode_bits", [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19])
def test_bc6h_every_mode(dxgi, mode_bits):
    """BC6H unsigned (95) and signed (96): modes 0 / 1 by their two low
    bits, 2-9 and 10-13 by five, 19 a reserved mode (black); Pillow's
    half floats clamped into 0-255."""
    blocks = _blocks(32, 32, 16, dxgi + mode_bits)
    blocks[:, 0] = (blocks[:, 0] & np.uint8(0xE0 if mode_bits > 1 else 0xFC)) | np.uint8(mode_bits)
    assert_like_pil(dds_file(29, 31, blocks.tobytes(), dxgi=dxgi))
