"""Port parity, AVIF step 5's colour matrices (io/codecs/avif_reformat.py,
libavif 1.3's own YUV -> RGB for the matrices libyuv does not take, and
avif_yuv.to_rgb's routing) and ROADMAP C.16 (the matrices libavif refuses
fail with PIL's message, not A.1).

- Each matrix fixture of tests/torch_fixtures/textures carries its nclx
  matrix, primaries and range, and its RGB equals PIL's (its planes equal
  dav1d's in test_torch_codecs_avif_planes.py): identity (0) in 4:4:4 at 8
  and 12 bits, FCC (4), SMPTE 240 (7), YCgCo (8) and chroma-derived NCL
  (12, on Display P3 and BT.2020 primaries) in 4:2:0 and 4:2:2, two of them
  in limited range, and YCgCo-Re (16) at 10 bits.
- The sweep: every matrix 0-18 and 255, in each layout (4:4:4, 4:2:2,
  4:2:0, 4:0:0), at 8, 10 and 12 bits, in both ranges, RGB and RGBA
  (straight and premultiplied alpha), on seeded planes of odd and even
  sizes through avif_yuv.to_rgb against libavif's `avifImageYUVToRGB`
  with PIL's settings: equal where libavif converts, DecodeError with
  "Conversion from YUV failed: Reformat failed" where it refuses. Matrix
  12 under each colour primaries libavif knows and some it does not.
- libavif's own conversion on every code of Y, U and V of each depth, for
  identity, FCC, YCgCo, YCgCo-Re and chroma-derived NCL.
- Whole files PIL refuses for their matrix (identity in 4:2:0 and 4:2:2,
  matrix 3 in 4:0:0, matrix 10) fail as PIL fails, no A.1.

The oracle cases skip where PIL ships no libavif, the high-depth encodes
where OpenCV ships none.
"""
import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import avif, avif_reformat, avif_yuv
from test_torch_codecs_avif_tools import _fixture
from torch_codec_encoders import photo, pil_bytes, pil_rgb
from torch_fixtures.make_textures import REFORMAT_FAILED, avif_colr

pytestmark = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
LAYOUTS = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: None}
MATRICES = list(range(19)) + [255]

# fixture -> (matrix, full range, colour primaries, depth, layout)
STEP5 = {
    "avif_matrix0_444.avif": (0, 1, 1, 8, (0, 0)),
    "avif12_matrix0_444.avif": (0, 1, 1, 12, (0, 0)),
    "avif_matrix4_420.avif": (4, 1, 1, 8, (1, 1)),
    "avif_matrix4_422.avif": (4, 1, 1, 8, (1, 0)),
    "avif_matrix7_420.avif": (7, 1, 1, 8, (1, 1)),
    "avif_matrix7_422_limited.avif": (7, 0, 1, 8, (1, 0)),
    "avif_matrix8_420.avif": (8, 1, 1, 8, (1, 1)),
    "avif_matrix8_422.avif": (8, 1, 1, 8, (1, 0)),
    "avif_matrix12_420.avif": (12, 1, 12, 8, (1, 1)),
    "avif_matrix12_422_limited.avif": (12, 0, 9, 8, (1, 0)),
    "avif10_matrix16_444.avif": (16, 1, 1, 10, (0, 0)),
}


@pytest.mark.parametrize("name", list(STEP5))
def test_fixture_matrix(name):
    data = _fixture(name)
    y, u, v, seq, colour = avif.planes(data)
    assert (*colour, seq["bit_depth"], tuple(seq["ss"])) == STEP5[name]
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


def _planes(depth: int, fmt: int, h: int, w: int, rng):
    dtype = np.uint8 if depth == 8 else np.uint16
    y = rng.integers(0, 1 << depth, (h, w)).astype(dtype)
    ss = LAYOUTS[fmt]
    if ss is None:
        return y, None, None
    shape = ((h + ss[1]) >> ss[1], (w + ss[0]) >> ss[0])
    return (y, *(rng.integers(0, 1 << depth, shape).astype(dtype) for _ in range(2)))


def _as_libavif(template, y, u, v, ss, matrix, full, depth, alpha, premultiplied, primaries=2) -> None:
    """to_rgb equals avifImageYUVToRGB, or both refuse."""
    try:
        want = oracle.yuv_to_rgb(template, y, u, v, matrix, full, alpha=alpha, premultiplied=int(premultiplied),
                                 primaries=primaries)
    except RuntimeError:
        want = None
    if want is None:
        assert avif_reformat.refused(matrix, None if u is None else ss, depth, full)
        with pytest.raises(codecs.DecodeError, match=f"^{REFORMAT_FAILED}$"):
            avif_yuv.to_rgb(y, u, v, ss, matrix, full, rgba=alpha is not None, depth=depth, primaries=primaries,
                            alpha=alpha if premultiplied else None)
        return
    got = avif_yuv.to_rgb(y, u, v, ss, matrix, full, rgba=alpha is not None, depth=depth, primaries=primaries,
                          alpha=alpha if premultiplied else None)
    np.testing.assert_array_equal(got, want, err_msg=f"matrix {matrix} full {full} primaries {primaries}")


@pytest.mark.parametrize("alpha", ["rgb", "rgba", "premultiplied"])
@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_every_matrix_layout_depth_range(depth, fmt, alpha):
    rng = np.random.default_rng(depth * 10 + fmt)
    for h, w in ((7, 9), (6, 10)):
        y, u, v = _planes(depth, fmt, h, w, rng)
        a = rng.integers(0, 1 << depth, (h, w)).astype(y.dtype) if alpha != "rgb" else None
        if a is not None:
            a[0, :2] = 0, (1 << depth) - 1
        for matrix in MATRICES:
            for full in (0, 1):
                _as_libavif((w, h, depth, fmt), y, u, v, LAYOUTS[fmt], matrix, full, depth, a,
                            alpha == "premultiplied")


@pytest.mark.parametrize("fmt", [1, 3])
def test_chroma_derived_under_every_primaries(fmt):
    """Matrix 12 derives kr / kb from the colour primaries (libavif's
    table, BT.709's for one it does not know), or hands BT.709, BT.601 and
    BT.2020 primaries to libyuv's constants."""
    rng = np.random.default_rng(fmt)
    y, u, v = _planes(8, fmt, 7, 9, rng)
    for primaries in list(range(14)) + [22, 23, 255]:
        for full in (0, 1):
            _as_libavif((9, 7, 8, fmt), y, u, v, LAYOUTS[fmt], 12, full, 8, None, False, primaries)


def _every_code(depth: int, fmt: int, seed: int):
    """Planes of a layout whose Y, U and V each take every code of the
    depth (a seeded permutation in each), 64 samples wide."""
    n = 1 << depth
    sub = LAYOUTS[fmt] or (0, 0)
    h, w = (n << sub[1]) // 64, 64 << sub[0]
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    y = np.resize(rng.permutation(n), h * w).reshape(h, w).astype(dtype)
    if LAYOUTS[fmt] is None:
        return y, None, None
    u, v = (rng.permutation(n).reshape(n // 64, 64).astype(dtype) for _ in range(2))
    return y, u, v


@pytest.mark.parametrize("fmt", [1, 2, 3])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_own_conversion_every_code(depth, fmt):
    y, u, v = _every_code(depth, fmt, depth + fmt)
    h, w = y.shape
    for matrix, primaries in ((0, 2), (4, 2), (7, 2), (8, 2), (12, 12), (16, 2)):
        for full in (0, 1):
            _as_libavif((w, h, depth, fmt), y, u, v, LAYOUTS[fmt], matrix, full, depth, None, False, primaries)


@pytest.mark.parametrize("case", ["identity_420", "identity_422", "matrix3_400", "matrix10_444", "matrix13_420",
                                  "ycgco_limited"])
def test_files_refused_for_their_matrix_fail_as_pil(case):
    """C.16: PIL raises "Conversion from YUV failed: Reformat failed" for a
    still whose nclx names a matrix libavif does not convert in its layout
    and range; the port raises the same reason (its DecodeError), no A.1."""
    subsampling, matrix, full = {"identity_420": ("4:2:0", 0, 1), "identity_422": ("4:2:2", 0, 1),
                                 "matrix3_400": ("4:0:0", 3, 1), "matrix10_444": ("4:4:4", 10, 1),
                                 "matrix13_420": ("4:2:0", 13, 1), "ycgco_limited": ("4:4:4", 8, 0)}[case]
    data = avif_colr(pil_bytes(photo(24, 40, 5), "AVIF", subsampling=subsampling), 1, 13, matrix, full)
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == REFORMAT_FAILED
