"""Port parity, JPEG 2000 as PIL writes it (codecs/jp2.py over j2k.py,
j2k_t2.py, j2k_t1.py, j2k_dwt.py) against PIL's `convert("RGB")`
(OpenJPEG 2.5 beneath it) and the JAX package's `load_image`, bit for bit.

Raw codestreams and JP2 files; the 5/3 and the 9/7, MCT on and off; the
five progressions over tiles with tile and image offsets, precincts,
code-block sizes and quality layers; PIL's modes L, LA, RGB, RGBA and
I;16; signed components; PLT and COM; odd and one-sample sizes; the loft
textures losslessly.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from optixpathtracer_tpu_torch.io import image as timg
from torch_codec_encoders import assert_like_pil, photo, pil_bytes, pil_rgb

PROGRESSIONS = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]
SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("progression", PROGRESSIONS)
def test_progressions_tiles_precincts_layers(tmp_path, progression, irreversible):
    img = Image.fromarray(photo(45, 53, PROGRESSIONS.index(progression)))
    kw = dict(progression=progression, irreversible=irreversible, precinct_size=(16, 16), codeblock_size=(8, 8),
              quality_mode="rates", quality_layers=[30, 10, 4], tile_size=(24, 20), tile_offset=(3, 2),
              offset=(5, 4), num_resolutions=3)
    assert_like_pil(pil_bytes(img, "JPEG2000", no_jp2=True, **kw), tmp_path if irreversible else None, "t.j2k")
    kw.update(tile_size=None, tile_offset=None, offset=None, precinct_size=(32, 32), codeblock_size=(16, 8),
              quality_mode="dB", quality_layers=[25, 35, 45], num_resolutions=4)
    assert_like_pil(pil_bytes(img, "JPEG2000", **kw), tmp_path if not irreversible else None, "t.jp2")


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("mct", [0, 1])
def test_transforms_and_mct(mct, irreversible):
    img = Image.fromarray(photo(31, 27, 7 + mct))
    assert_like_pil(pil_bytes(img, "JPEG2000", mct=mct, irreversible=irreversible))
    assert_like_pil(pil_bytes(img, "JPEG2000", no_jp2=True, mct=mct, irreversible=irreversible, num_resolutions=1))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("no_jp2", [False, True])
def test_modes(tmp_path, mode, no_jp2):
    """PIL's modes from the component count (I;16 above 8 bits)."""
    if mode == "I;16":
        img = Image.fromarray((photo(23, 19, 3, 1)[..., 0].astype(np.uint16) * 257 // 2 + 300)).convert("I;16")
    else:
        img = Image.fromarray(photo(23, 19, 4, len(mode)) if len(mode) > 1 else photo(23, 19, 4, 1)[..., 0], mode)
    for irreversible in (False, True):
        data = pil_bytes(img, "JPEG2000", no_jp2=no_jp2, irreversible=irreversible, num_resolutions=3)
        assert Image.open(io.BytesIO(data)).mode == mode
        assert_like_pil(data, tmp_path if not irreversible else None, "m.jp2")


@pytest.mark.parametrize("irreversible", [False, True])
def test_signed_offsets_plt_comment(irreversible):
    img = Image.fromarray(photo(31, 27, 11))
    assert_like_pil(pil_bytes(img, "JPEG2000", signed=True, irreversible=irreversible, num_resolutions=3))
    assert_like_pil(pil_bytes(img, "JPEG2000", no_jp2=True, plt=True, comment="a comment", codeblock_size=(4, 4),
                              irreversible=irreversible, offset=(7, 9), tile_size=(16, 16), tile_offset=(1, 2),
                              num_resolutions=2))


@pytest.mark.parametrize("shape", [(1, 13), (7, 1), (1, 1), (2, 3), (17, 5), (33, 65)])
def test_odd_sizes(shape):
    """One-sample rows and columns (the lifting's one-sample cases) and odd
    sizes at every level."""
    img = Image.fromarray(photo(*shape, sum(shape)))
    res = 1 + min(5, max(0, min(shape).bit_length() - 1))
    for irreversible in (False, True):
        assert_like_pil(pil_bytes(img, "JPEG2000", no_jp2=True, irreversible=irreversible, num_resolutions=res))


@pytest.mark.parametrize("tex", [0, 1, 2])
def test_loft_textures_lossless(tex):
    """The loft's textures as 5/3 JP2: PIL's decode, and the PNG's pixels."""
    img = Image.open(os.path.join(SCENES, f"loft_tex{tex}.png")).convert("RGB")
    got = assert_like_pil(pil_bytes(img, "JPEG2000"))
    np.testing.assert_array_equal(got, np.asarray(img))
    lossy = pil_bytes(img, "JPEG2000", irreversible=True, quality_mode="rates", quality_layers=[20])
    assert_like_pil(lossy)
    assert np.abs(pil_rgb(lossy).astype(int) - np.asarray(img)).mean() < 8
    assert timg.rgb8_from_bytes(lossy).shape == (256, 256, 3)
