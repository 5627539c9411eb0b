"""Port parity, AVIF end to end: every AVIF fixture (steps 1 and 2: every
layout, alpha, CDEF, loop restoration) decoded by the port equal to PIL's
`convert("RGB")` and to the JAX package's `load_image` bit for bit; and
io/codecs/avif_yuv.py's 4:2:0 path (libavif 1.3 through libyuv: the
bilinear 2x chroma upsampling, the fixed-point YuvConstants) equal to
libavif's own `avifImageYUVToRGB` with PIL's settings, on seeded planes of
odd and even sizes, for BT.601 (matrix 6, 5 and unspecified), BT.709 and
BT.2020 in full and limited range (the other layouts:
test_torch_codecs_avif_options.py). The oracle is PIL's bundled libavif
through ctypes (tests/torch_avif_oracle.py); those cases skip where PIL
ships none.
"""
import json
import os

import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu.io import image as jimg
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io.codecs import DecodeError, avif_yuv
from torch_codec_encoders import pil_rgb
from torch_fixtures.make_textures import MANIFEST, OUT

with open(MANIFEST) as f:
    AVIF_FIXTURES = sorted(n for n in json.load(f) if n.endswith(".avif"))


@pytest.mark.parametrize("name", AVIF_FIXTURES)
def test_fixture_equals_pil_and_jax(name):
    path = os.path.join(OUT, name)
    with open(path, "rb") as f:
        data = f.read()
    got = timg.rgb8_from_bytes(data)
    np.testing.assert_array_equal(got, pil_rgb(data))
    np.testing.assert_array_equal(timg.load_image(path), jimg.load_image(path))


# a template of each size, for libavif to own the planes
SIZES = {"37x23": "avif_37x23.avif", "128x128": "avif_q75.avif", "17x1": "avif_17x1.avif", "1x1": "avif_1x1.avif",
         "64x64": "avif_lossless.avif"}


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("matrix", [1, 2, 5, 6, 9])
@pytest.mark.parametrize("full", [0, 1])
def test_yuv_to_rgb_equals_libavif(size, matrix, full):
    with open(os.path.join(OUT, SIZES[size]), "rb") as f:
        template = f.read()
    (w, h, _, _, _), _ = oracle.planes(template)
    rng = np.random.default_rng(matrix * 10 + full + w)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u, v = (rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8) for _ in range(2))
    want = oracle.yuv_to_rgb(template, y, u, v, matrix, full)
    np.testing.assert_array_equal(avif_yuv.yuv420_to_rgb(y, u, v, matrix, full), want)


@pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
def test_other_matrices_raise_a1():
    """The 4:2:0 matrices libyuv has no constants for: libyuv's kernel
    refuses them, and libavif converts them on its own (4, 12) or refuses
    them, PIL raising "Conversion from YUV failed: Reformat failed" (0, 10,
    14; ROADMAP C.16): `to_rgb` does each as libavif does."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (6, 10), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (3, 5), dtype=np.uint8) for _ in range(2))
    for matrix in (0, 4, 10, 12, 14):
        with pytest.raises(ValueError, match=f"libyuv has no constants for matrix coefficients {matrix}"):
            avif_yuv.yuv420_to_rgb(y, u, v, matrix, 1)
        if matrix in (4, 12):
            np.testing.assert_array_equal(avif_yuv.to_rgb(y, u, v, (1, 1), matrix, 1),
                                          oracle.yuv_to_rgb((10, 6, 8, 3), y, u, v, matrix, 1))
        else:
            with pytest.raises(RuntimeError, match="avifImageYUVToRGB failed"):
                oracle.yuv_to_rgb((10, 6, 8, 3), y, u, v, matrix, 1)
            with pytest.raises(DecodeError, match="^Conversion from YUV failed: Reformat failed$"):
                avif_yuv.to_rgb(y, u, v, (1, 1), matrix, 1)
