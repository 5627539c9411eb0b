"""Port parity, io/image.py's JPEG residue: arithmetic coding
(codecs/jpeg_arith.py), CMYK and YCCK, 8-bit lossless
(codecs/jpeg_lossless.py), against PIL's `convert("RGB")` (libjpeg-turbo)
and the JAX package's `load_image`, bit for bit.

Arithmetic-coded files come from a QM-coder encoder in
tests/torch_codec_encoders.py: PIL's own Huffman JPEG, its quantised
coefficients re-encoded (sequential, and progressive with every pass kind;
restart intervals; DAC conditioning). PIL decodes both to the same pixels,
so the encoder is right before the port's decoder is held to it. Huffman
data under an arithmetic SOF is garbage PIL still decodes: the port
decodes it to the same garbage. 12-bit, hierarchical and arithmetic
lossless JPEG, which PIL cannot read, raise an OSError.
"""
import numpy as np
import pytest

from torch_codec_encoders import (arith_jpeg, assert_fails_like_pil, assert_like_pil, lossless_jpeg, photo,
                                  pil_bytes, pil_rgb)
from optixpathtracer_tpu_torch.io import image as timg


@pytest.mark.parametrize("mode,size,subsampling", [("RGB", (21, 34), 2), ("RGB", (16, 16), 0), ("L", (9, 13), 0),
                                                    ("RGB", (33, 7), 1), ("CMYK", (12, 18), 0)])
@pytest.mark.parametrize("progressive", [False, True])
def test_arithmetic_equals_huffman_and_pil(tmp_path, mode, size, subsampling, progressive):
    base = pil_bytes(photo(*size, 1), "JPEG", mode, quality=80, subsampling=subsampling)
    data = arith_jpeg(base, progressive=progressive)
    np.testing.assert_array_equal(pil_rgb(data), pil_rgb(base))  # the encoder is right
    assert_like_pil(data, tmp_path, "a.jpg")


@pytest.mark.parametrize("restart,dac", [(1, None), (3, (1, 4, 2)), (5, (0, 7, 40)), (0, (2, 3, 1))])
def test_arithmetic_restarts_and_conditioning(restart, dac):
    base = pil_bytes(photo(29, 23, 2), "JPEG", quality=92, subsampling=2)
    for progressive in (False, True):
        data = arith_jpeg(base, progressive=progressive, restart_mcus=restart, dac=dac)
        np.testing.assert_array_equal(pil_rgb(data), pil_rgb(base))
        assert_like_pil(data)


@pytest.mark.parametrize("seed", range(4))
def test_huffman_data_under_arithmetic_sof_decodes_as_libjpeg_does(seed):
    progressive = seed % 2 == 1
    base = pil_bytes(np.random.default_rng(seed).integers(0, 256, (17 + seed, 20, 3), dtype=np.uint8), "JPEG",
                     quality=80, progressive=progressive)
    sof = base.index(b"\xff\xc2" if progressive else b"\xff\xc0")
    assert_like_pil(base[:sof] + (b"\xff\xca" if progressive else b"\xff\xc9") + base[sof + 2:])


@pytest.mark.parametrize("quality", [50, 95])
def test_cmyk_ycck_and_no_adobe_marker(tmp_path, quality):
    data = pil_bytes(photo(19, 23, 3), "JPEG", "CMYK", quality=quality)
    assert_like_pil(data, tmp_path, "cmyk.jpg")
    i = data.index(b"Adobe")
    ycck = data[:i + 11] + b"\x02" + data[i + 12:]  # Adobe transform 2: YCCK, converted by libjpeg
    assert_like_pil(ycck, tmp_path, "ycck.jpg")
    assert_like_pil(arith_jpeg(ycck))
    j = data.index(b"\xff\xee")
    bare = data[:j] + data[j + 2 + int.from_bytes(data[j + 2:j + 4], "big"):]  # CMYK without the marker
    assert_like_pil(bare)


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt,channels", [(0, 1), (0, 3), (2, 3)])
def test_lossless(predictor, pt, channels):
    """libjpeg-turbo 3 reads 8-bit lossless JPEG (no colour conversion:
    three components are RGB)."""
    img = np.random.default_rng(predictor).integers(0, 256, (11, 14, channels), dtype=np.uint8)
    img[4:8] = img[4:5]
    assert_like_pil(lossless_jpeg(img, predictor, pt))


def test_lossless_restarts_and_jfif(tmp_path):
    img = photo(12, 9, 4)
    assert_like_pil(lossless_jpeg(img, 6, restart_rows=4), tmp_path, "ll.jpg")
    jfif = timg._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    assert_fails_like_pil(lossless_jpeg(img, 1, markers=jfif))  # a YCbCr lossless file: libjpeg-turbo refuses


def test_what_pil_cannot_read_raises_os_errors(tmp_path):
    base = pil_bytes(photo(16, 16, 5), "JPEG", quality=75)
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    cases = {"12-bit": twelve, "two components": base[:sof + 9] + b"\x02" + base[sof + 10:]}
    for marker, name in ((b"\xff\xc5", "hierarchical"), (b"\xff\xc7", "hierarchical lossless"),
                         (b"\xff\xcb", "arithmetic lossless"), (b"\xff\xc3", "lossless, Huffman data")):
        cases[name] = base[:sof] + marker + base[sof + 2:]
    for name, data in cases.items():
        assert_fails_like_pil(data)
    with pytest.raises(OSError, match="cannot identify"):
        timg.rgb8_from_bytes(twelve)
    with pytest.raises(ValueError):  # the port's error class is both, as the old decoders' was a ValueError
        timg.rgb8_from_bytes(twelve)
