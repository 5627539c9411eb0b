"""Port parity, the AV1 decode of AVIF before any colour conversion: the
Y / U / V planes of the port's native tile decoder (csrc/host/av1_dec.cpp
through io/codecs/av1_obu.py) equal to dav1d's, as PIL's bundled libavif
returns them (`avifDecoderReadMemory` through ctypes,
tests/torch_avif_oracle.py), plane for plane and sample for sample, in
every chroma layout (4:2:0, 4:2:2, 4:4:4; Y alone for 4:0:0) and depth
(uint8 at 8 bits, uint16 at 10 and 12), and the alpha item's plane equal
to libavif's alpha plane.

Every AVIF fixture (the four quantizer buckets and lossless, speeds 0 / 5 /
6 / 10, one and 2 x 2 tiles, 64 and 128 superblocks, odd sizes, both
ranges, the loft with palette and IntraBC; AVIF step 2's layouts, straight
and premultiplied alpha, loop restoration at speeds 0 / 2 / 4, CDEF in
three layouts, both filters on 128 superblocks, the loft's sixth set; AVIF
step 3's 10- and 12-bit stills), and
seeded stills of aom's screen-content paths (palette, IntraBC over repeated
tiles, odd sizes at the frame edge) written here. Skips where PIL ships no
libavif.
"""
import io
import json
import os

import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io.codecs import avif
from torch_codec_encoders import photo
from torch_fixtures.make_textures import MANIFEST, OUT

pytestmark = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")

with open(MANIFEST) as f:
    AVIF_FIXTURES = sorted(n for n in json.load(f) if n.endswith(".avif"))


# libavif's yuvFormat of each sequence header layout: 4:4:4, 4:2:2, 4:2:0
LAYOUT = {(0, 0): 1, (1, 0): 2, (1, 1): 3}


def _assert_planes_equal(data: bytes) -> None:
    (w, h, depth, fmt, full), want = oracle.planes(data)
    y, u, v, seq, colour = avif.planes(data)
    assert depth == seq["bit_depth"] and fmt == (4 if seq["mono"] else LAYOUT[seq["ss"]]) and y.shape == (h, w)
    assert y.dtype == (np.uint8 if depth == 8 else np.uint16)
    assert colour[1] == full
    got = [y] if seq["mono"] else [y, u, v]
    assert len(got) == len(want)
    for g, ref in zip(got, want):
        np.testing.assert_array_equal(g, ref)
    want_alpha, want_premultiplied = oracle.alpha(data)
    alpha, premultiplied = avif.alpha_plane(data)
    assert (alpha is None) == (want_alpha is None) and premultiplied == bool(want_premultiplied)
    if alpha is not None:
        np.testing.assert_array_equal(alpha, want_alpha)


@pytest.mark.parametrize("name", AVIF_FIXTURES)
def test_fixture_planes_equal_dav1d(name):
    with open(os.path.join(OUT, name), "rb") as f:
        _assert_planes_equal(f.read())


def _screen(h: int, w: int, seed: int) -> np.ndarray:
    """Blocks of a few colours with sparse noise: palette territory."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (int(rng.integers(2, 9)), 3))
    idx = rng.integers(0, len(pal), (h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)[:h, :w]
    img = pal[idx].astype(np.uint8)
    img[rng.random((h, w)) < 0.05] = rng.integers(0, 256, 3)
    return img


def _tiles(h: int, w: int, seed: int) -> np.ndarray:
    """One 16 x 16 tile repeated: IntraBC territory."""
    t = np.random.default_rng(seed).integers(0, 256, (16, 16, 3))
    return np.tile(t, (h // 16 + 1, w // 16 + 1, 1))[:h, :w].astype(np.uint8)


STILLS = {
    "screen_97x131_q75": (lambda: _screen(97, 131, 1), dict()),
    "screen_64x200_q40_speed3": (lambda: _screen(64, 200, 2), dict(quality=40, speed=3)),
    "screen_150x75_q95_speed8": (lambda: _screen(150, 75, 3), dict(quality=95, speed=8)),
    "tiles_120x90_q60": (lambda: _tiles(120, 90, 4), dict(quality=60)),
    "tiles_201x45_q20_speed5": (lambda: _tiles(201, 45, 5), dict(quality=20, speed=5)),
    "tiles_77x77_lossless": (lambda: _tiles(77, 77, 6), dict(quality=100)),
    "photo_99x61_q0_speed9": (lambda: photo(99, 61, 7), dict(quality=0, speed=9)),
    "photo_35x140_q85_limited": (lambda: photo(35, 140, 8), dict(quality=85, range="limited")),
}


@pytest.mark.parametrize("name", list(STILLS))
def test_seeded_stills_planes_equal_dav1d(name):
    from PIL import Image

    make, kw = STILLS[name]
    buf = io.BytesIO()
    Image.fromarray(make()).save(buf, "AVIF", **kw)
    _assert_planes_equal(buf.getvalue())
