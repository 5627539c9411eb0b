"""Port parity, codecs/lab.py (LittleCMS's Lab -> sRGB transform, which
PIL's LAB mode converts through) on every 8-bit (L, a, b) against PIL bit
for bit; a CIELAB TIFF and a CIELAB PSD decoded as PIL decodes them,
loaded as the JAX package loads them."""
import numpy as np
import pytest

import torch_codec_encoders as enc
from torch_codec_encoders import assert_like_pil, tiff_file


def _sweep(lo: int, hi: int) -> np.ndarray:
    """Every (v0, v1, v2) with v0 in [lo, hi), as a (hi - lo) * 256 x 256 image."""
    g = np.stack(np.meshgrid(np.arange(lo, hi), np.arange(256), np.arange(256), indexing="ij"), -1)
    return g.astype(np.uint8).reshape((hi - lo) * 256, 256, 3)


def assert_lab_sweep(quarter: int) -> None:
    """Every a and b for a quarter of L's range. PIL's LAB mode holds a* and
    b* offset by 128, as lab_rgb takes them; its raw LAB unpacker (TIFF's
    signed bytes) flips their sign bits on the way in."""
    from PIL import Image

    from optixpathtracer_tpu_torch.io.codecs.lab import lab_rgb

    g = _sweep(64 * quarter, 64 * quarter + 64)
    raw = g ^ np.array([0, 128, 128], np.uint8)
    want = np.asarray(Image.frombytes("LAB", (256, g.shape[0]), raw.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(lab_rgb(g), want)


@pytest.mark.parametrize("quarter", [0, 1])
def test_lab_to_rgb_full_sweep(quarter):
    """L from 0 to 127 (tests/test_torch_codecs_lab_upper.py: the rest)."""
    assert_lab_sweep(quarter)


@pytest.mark.parametrize("compression", [0, 1])
def test_cielab_psd_and_tiff(tmp_path, compression):
    rng = np.random.default_rng(compression)
    lab = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    lab[3:6] = lab[3]
    assert_like_pil(enc.psd_file([lab[..., c] for c in range(3)], 9, 8, compression), tmp_path, "lab.psd")
    assert_like_pil(tiff_file(lab, 8, 8, "<>"[compression], 5 if compression else 1), tmp_path, "lab.tif")
