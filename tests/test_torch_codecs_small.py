"""Port parity, codecs/psd.py, qoi.py, sgi.py and pcx.py against PIL's
`convert("RGB")` and the JAX package's `load_image`, bit for bit.

PSD composites written by tests/torch_codec_encoders.py (grey, indexed with
its palette, RGB and RGBA, CMYK, bitmap, duotone; raw and PackBits);
QOI, SGI and PCX written by PIL (and RLE SGI at 8 and 16 bits by the
test writer).
"""
import numpy as np
import pytest

from torch_codec_encoders import assert_as_pil, assert_like_pil, photo, pil_bytes, psd_file, sgi_rle

PSD_CASES = [(1, 8, 1), (3, 8, 3), (3, 8, 4), (4, 8, 4), (2, 8, 1), (8, 8, 1), (7, 8, 1), (0, 1, 1)]


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("mode,bits,channels", PSD_CASES)
def test_psd(tmp_path, mode, bits, channels, compression):
    if bits == 1:
        compression = 0  # PIL reads bitmap composites raw
    rng = np.random.default_rng(mode * 10 + channels + compression)
    h, w = 9, 14
    if bits == 1:
        planes = [rng.integers(0, 256, (h, (w + 7) // 8), dtype=np.uint8)]
    else:
        planes = [np.array(photo(h, w, c)[..., 0]) for c in range(channels)]
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8) if mode == 2 else None
    assert_like_pil(psd_file(planes, mode, bits, compression, palette), tmp_path, "p.psd")


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (17, 23), (40, 3)])
def test_qoi(tmp_path, mode, size):
    img = photo(*size, 1, 4)
    img[:, :3, 3] = 7
    from PIL import Image

    assert_like_pil(pil_bytes(Image.fromarray(img, "RGBA"), "QOI", mode), tmp_path, "q.qoi")


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_sgi(tmp_path, mode):
    img = photo(13, 18, 2, 4)
    from PIL import Image

    im = Image.fromarray(img, "RGBA").convert(mode)
    assert_like_pil(pil_bytes(im, "SGI"), tmp_path, "s.sgi")
    px = np.asarray(im).reshape(13, 18, -1)
    assert_like_pil(sgi_rle(px, 1))
    assert_like_pil(sgi_rle(px.astype(np.uint16) * 257 + 3, 2))


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("size", [(7, 9), (16, 16), (5, 1)])
def test_pcx(tmp_path, mode, size):
    assert_as_pil(pil_bytes(photo(*size, 3), "PCX", mode), tmp_path, "x.pcx")  # PIL fails its own 1-wide RGB
