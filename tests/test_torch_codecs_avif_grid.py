"""Port parity, AVIF step 5's grid images (io/codecs/avif.py): a `grid`
primary item whose ImageGrid lays rows x columns av01 cells out row-major,
cropped to its output size, converted once; an alpha grid beside it; and
libavif 1.3's refusals, each with PIL's message.

- Each grid fixture of tests/torch_fixtures/textures (2 x 2 and 1 x 3 from
  libavif's own encoder, a 10-bit 4:4:4 RGBA 2 x 2 from OpenCV's, the 2 x 2
  cropped by an ImageGrid edit) has the geometry it stands for and its RGB
  equals PIL's (its planes, assembled, equal libavif's in
  test_torch_codecs_avif_planes.py).
- A seeded sweep of grids written here (tests/torch_codec_encoders.avif_grid
  around 64 x 64 cells): 1 x 2 up to 3 x 3, cropped and not, with and
  without alpha (straight and premultiplied), the cells in another dimg
  order; 4:4:4, 4:2:2 and 4:0:0 cells at 8, 10 and 12 bits; assembled
  planes equal to libavif's, RGB equal to PIL's.
- The colour of the grid item's colr over the cells' sequence headers (its
  matrix and range); 32-bit output sizes; an alpha grid of another
  geometry and the same output size.
- libavif's refusals: at parse ("Failed to decode image: Invalid image
  grid") a cell count other than rows x columns, a missing, repeated or
  dangling reference, a cell that is not av01, cells with an unknown
  essential property (in place of their av1C), an ImageGrid of another
  version, trailing bytes, a zero or too large output size; at decode
  ("Failed to decode frame 0: Invalid image grid") cells that do not cover
  the output or leave a row or column out, cells under 64, odd sizes under
  subsampled chroma, cells of another size, depth, layout, range or
  colour, an alpha grid of another output size.
- PIL sizes a grid by its ispe and reads libavif's buffer at that size: a
  smaller ispe runs rows on, a larger one is cut data; the port does the
  same. A cell whose AV1 frame is of another size than its ispe (libavif
  scales it) raises A.1, as a still's does.
- A glTF textured with a grid of segmented cells loads as the JAX loader
  loads it.

The oracle cases skip where PIL ships no libavif, the high-depth cells
where OpenCV ships none.
"""
import functools
import struct

import numpy as np
import pytest
from PIL import Image

import torch_avif_oracle as oracle
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import avif
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_codecs_avif_tools import _fixture
from test_torch_obj_gltf import _assert_same_gltf, _textured_glb
from torch_codec_encoders import _box, _full_box, avif_grid, image_grid, photo, pil_bytes, pil_rgb, yuv_photo
from torch_fixtures.make_textures import INVALID_GRID, avif_parts

pytestmark = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
needs_encoder = pytest.mark.skipif(not oracle.hbd_available(), reason="OpenCV ships no libavif here")
GRID_FAILED = avif.GRID_FAILED


def _geometry(data: bytes) -> tuple:
    image, _, alpha, _ = avif._read(data)
    y, u, _, seq = avif._decode_image(image)
    layout = "400" if u is None else {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[seq["ss"]]
    return (*image.grid, seq["bit_depth"], layout, alpha is not None)


# fixture -> (rows, cols, output width, output height, depth, layout, alpha)
GRIDS = {
    "avif_grid.avif": (2, 2, 128, 128, 8, "420", False),
    "avif_grid_1x3.avif": (1, 3, 192, 64, 8, "420", False),
    "avif10_grid_rgba_444.avif": (2, 2, 128, 128, 10, "444", True),
    "avif_grid_cropped.avif": (2, 2, 120, 100, 8, "420", False),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_fixture_grid(name):
    data = _fixture(name)
    assert _geometry(data) == GRIDS[name]
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


def _check(data: bytes) -> None:
    _assert_planes_equal(data)
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


@functools.lru_cache(maxsize=None)
def _cells(n: int, size: tuple = (64, 64), subsampling: str = "4:2:0") -> tuple:
    """n cells of PIL's AVIF (OBUs) and their shared av1C."""
    w, h = size
    parts = [avif_parts(pil_bytes(photo(h, w, 40 + k), "AVIF", subsampling=subsampling)) for k in range(n)]
    assert len({p[1] for p in parts}) == 1
    return tuple(p[0] for p in parts), parts[0][1]


@functools.lru_cache(maxsize=None)
def _alpha_cells(n: int, size: tuple = (64, 64)) -> tuple:
    """n alpha items of PIL's RGBA AVIF (OBUs) and their shared av1C."""
    w, h = size
    out = []
    for k in range(n):
        data = pil_bytes(Image.fromarray(photo(h, w, 60 + k, 4), "RGBA"), "AVIF")
        _, _, alpha, _ = avif._read(data)
        start = data.index(b"ipco") + 4
        end = start - 8 + int.from_bytes(data[start - 8:start - 4], "big")
        av1c = [data[s - 8:e] for kind, s, e in avif._boxes(data, start, end) if kind == b"av1C"]
        out.append((alpha.cells[0], av1c[-1]))
    assert len({a[1] for a in out}) == 1
    return tuple(a[0] for a in out), out[0][1]


GEOMETRIES = [(1, 2), (2, 1), (2, 2), (1, 3), (3, 1), (2, 3), (3, 3)]


@pytest.mark.parametrize("alpha", ["none", "straight", "premultiplied"])
@pytest.mark.parametrize("cropped", [False, True], ids=["whole", "cropped"])
@pytest.mark.parametrize("rows,cols", GEOMETRIES)
def test_grid_sweep(rows, cols, cropped, alpha):
    rng = np.random.default_rng(rows * 100 + cols * 10 + cropped)
    n = rows * cols
    cells, av1c = _cells(n)
    width, height = 64 * cols, 64 * rows
    if cropped:
        width -= 2 * int(rng.integers(1, 32))
        height -= 2 * int(rng.integers(1, 32))
    order = [int(i) for i in rng.permutation(n)]  # the cells' items in one order, their dimg references in this
    kw = {}
    if alpha != "none":
        a_cells, a_av1c = _alpha_cells(n)
        kw = dict(alpha=([a_cells[i] for i in order], a_av1c, image_grid(rows, cols, width, height)),
                  premultiplied=alpha == "premultiplied", channels=4)
    data = avif_grid(list(cells), rows, cols, width, height, (64, 64), av1c, dimg=order, **kw)
    assert _geometry(data)[:4] == (rows, cols, width, height)
    _check(data)


@needs_encoder
@pytest.mark.parametrize("fmt", [1, 2, 4])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_grid_layouts_and_depths(depth, fmt):
    """1 x 2 and 2 x 1 grids of 4:4:4, 4:2:2 and 4:0:0 cells at each depth
    from OpenCV's libavif, and the 4:4:4 / 4:0:0 ones cropped to odd sizes
    (no chroma rule there)."""
    planes = yuv_photo(64, 128, depth * 10 + fmt, depth, fmt)
    data = oracle.encode_hbd(planes, depth, fmt, grid=(1, 2))
    _check(data)
    tall = oracle.encode_hbd(yuv_photo(128, 64, depth * 10 + fmt + 1, depth, fmt), depth, fmt, grid=(2, 1))
    _check(tall)
    if fmt != 2:
        cells, av1c, _ = _cells_of(data)
        _check(avif_grid(cells, 1, 2, 127, 61, (64, 64), av1c, depth=depth))


def _cells_of(data: bytes):
    """(cells' OBUs, their av1C box, the grid item's colr box or None) of a
    grid AVIF."""
    image, _, _, _ = avif._read(data)
    start = data.index(b"ipco") + 4
    end = start - 8 + int.from_bytes(data[start - 8:start - 4], "big")
    boxes = {kind: data[s - 8:e] for kind, s, e in avif._boxes(data, start, end)}
    return image.cells, boxes[b"av1C"], boxes.get(b"colr")


def _nclx(matrix: int, full: int, primaries: int = 1) -> bytes:
    return _box(b"colr", b"nclx" + struct.pack(">HHHB", primaries, 13, matrix, full << 7))


@pytest.mark.parametrize("colr", ["none", "bt709_full", "bt709_limited", "fcc_full", "p3_derived"])
def test_grid_colour(colr):
    """The grid item's nclx, where there is one, over the cells' sequence
    headers (which say unspecified, full range): its matrix and range, and
    the primaries matrix 12 derives its coefficients from."""
    cells, av1c = _cells(4)
    box = {"none": None, "bt709_full": _nclx(1, 1), "bt709_limited": _nclx(1, 0), "fcc_full": _nclx(4, 1),
           "p3_derived": _nclx(12, 1, 12)}[colr]
    data = avif_grid(list(cells), 2, 2, 128, 128, (64, 64), av1c, colr=box)
    _check(data)


def test_grid_32_bit_sizes():
    cells, av1c = _cells(4)
    grid = bytes([0, 1, 1, 1]) + struct.pack(">II", 124, 126)
    _check(avif_grid(list(cells), 2, 2, 124, 126, (64, 64), av1c, grid=grid))


def test_alpha_grid_of_another_geometry():
    """An alpha grid of 1 x 2 cells of 64 x 128 beside a 2 x 2 colour grid of
    the same output size decodes; the colour premultiplied by it too."""
    cells, av1c = _cells(4)
    a_cells, a_av1c = _alpha_cells(2, (64, 128))
    for premultiplied in (False, True):
        data = avif_grid(list(cells), 2, 2, 128, 128, (64, 64), av1c, channels=4, premultiplied=premultiplied,
                         alpha=(list(a_cells), a_av1c, image_grid(1, 2, 128, 128), (64, 128)))
        _check(data)


def _pil_fails_as_port(data: bytes, message: str) -> None:
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(data)
    assert str(got.value) == str(pil_error.value) == message


def _refused(case: str) -> bytes:
    cells, av1c = _cells(4)
    cells = list(cells)
    g = functools.partial(avif_grid, cells, 2, 2, 128, 128, (64, 64), av1c)
    if case == "too_many_cells":
        return avif_grid(cells, 1, 2, 128, 64, (64, 64), av1c)
    if case == "missing_cell":
        return g(dimg=[0, 1, 2])
    if case == "repeated_cell":
        return g(dimg=[0, 1, 1, 3])
    if case == "dangling_reference":
        return g(dimg=[0, 1, 2, 4])
    if case == "cell_not_av01":
        return g(cell_types=[b"av01", b"hvc1", b"av01", b"av01"])
    if case == "first_cell_not_av01":
        return g(cell_types=[b"hvc1", b"av01", b"av01", b"av01"])
    if case == "unknown_essential_property":
        return g().replace(av1c, _box(b"xxxx", av1c[8:]))
    if case == "version_1":
        return g(grid=bytes([1, 0, 1, 1, 0, 128, 0, 128]))
    if case == "trailing_byte":
        return g(grid=bytes([0, 0, 1, 1, 0, 128, 0, 128, 0]))
    if case == "zero_width":
        return g(grid=bytes([0, 0, 1, 1, 0, 0, 0, 128]))
    if case == "wider_than_32768":
        return g(grid=bytes([0, 1, 1, 1]) + struct.pack(">II", 32769, 128))
    if case == "more_than_16384_squared":
        return g(grid=bytes([0, 1, 1, 1]) + struct.pack(">II", 16385, 16384))
    if case == "not_covered":
        return avif_grid(cells, 2, 2, 130, 128, (64, 64), av1c)
    if case == "column_left_out":
        return avif_grid(cells, 2, 2, 64, 128, (64, 64), av1c)
    if case == "width_32768_not_covered":  # within the limits: refused at decode
        return g(grid=bytes([0, 1, 1, 1]) + struct.pack(">II", 32768, 128))
    if case == "odd_width_420":
        return avif_grid(cells, 2, 2, 121, 100, (64, 64), av1c)
    if case == "odd_height_420":
        return avif_grid(cells, 2, 2, 120, 101, (64, 64), av1c)
    if case == "cells_under_64":
        small, av1c32 = _cells(4, (32, 32))
        return avif_grid(list(small), 2, 2, 64, 64, (32, 32), av1c32)
    if case == "odd_cell_width_422":
        odd, av1c65 = _cells(4, (65, 64), "4:2:2")
        return avif_grid(list(odd), 2, 2, 130, 128, (65, 64), av1c65)
    if case == "odd_output_width_422":
        c422, av1c422 = _cells(4, (64, 64), "4:2:2")
        return avif_grid(list(c422), 2, 2, 127, 128, (64, 64), av1c422)
    if case in ("cell_of_another_range", "cell_of_another_layout", "cell_of_another_size"):
        kw = {"cell_of_another_range": dict(range="limited"), "cell_of_another_layout": dict(subsampling="4:4:4"),
              "cell_of_another_size": {}}[case]
        size = (66, 64) if case == "cell_of_another_size" else (64, 64)
        other, other_av1c, _ = avif_parts(pil_bytes(photo(size[1], size[0], 70), "AVIF", **kw))
        # the odd cell under an ispe of its own size, so that libavif does not scale it
        return avif_grid(cells[:3] + [other], 2, 2, 128, 128, [(64, 64)] * 3 + [size], av1c)
    if case == "alpha_grid_of_another_size":
        a_cells, a_av1c = _alpha_cells(4)
        return g(alpha=(list(a_cells), a_av1c, image_grid(2, 2, 120, 100)), channels=4)
    raise AssertionError(case)


PARSE_REFUSALS = ["too_many_cells", "missing_cell", "repeated_cell", "dangling_reference", "cell_not_av01",
                  "first_cell_not_av01", "unknown_essential_property", "version_1", "trailing_byte", "zero_width",
                  "wider_than_32768", "more_than_16384_squared"]
DECODE_REFUSALS = ["not_covered", "column_left_out", "width_32768_not_covered", "odd_width_420", "odd_height_420",
                   "cells_under_64", "odd_cell_width_422", "odd_output_width_422", "cell_of_another_range",
                   "cell_of_another_layout", "cell_of_another_size", "alpha_grid_of_another_size"]


@pytest.mark.parametrize("case", PARSE_REFUSALS + DECODE_REFUSALS)
def test_grid_refusals_as_pil(case):
    _pil_fails_as_port(_refused(case), INVALID_GRID if case in PARSE_REFUSALS else GRID_FAILED)


def test_cells_of_another_depth_fail_as_pil():
    """A 10-bit cell among 8-bit ones (its own av1C); libavif refuses the
    mismatch once the cells are decoded."""
    if not oracle.hbd_available():
        pytest.skip("OpenCV ships no libavif here")
    cells, av1c = _cells(4)
    deep = avif_parts(oracle.encode_hbd(yuv_photo(64, 64, 71, 10, 3), 10, 3))
    data = avif_grid(list(cells[:3]) + [deep[0]], 2, 2, 128, 128, (64, 64), av1c)
    _pil_fails_as_port(data, GRID_FAILED)


def _with_grid_ispe(data: bytes, size: tuple) -> bytes:
    old = _full_box(b"ispe", 0, struct.pack(">II", 128, 128))
    assert data.count(old) == 1
    return data.replace(old, _full_box(b"ispe", 0, struct.pack(">II", *size)))


@pytest.mark.parametrize("alpha", [False, True])
def test_grid_ispe_of_another_size_read_as_pil(alpha):
    """PIL sizes the image by the grid item's ispe and reads libavif's
    128 x 128 RGB(A) buffer at that size: a 120 x 120 or 100 x 130 ispe runs
    the rows on; a larger one is cut data to PIL and to the port."""
    cells, av1c = _cells(4)
    kw = {}
    if alpha:
        a_cells, a_av1c = _alpha_cells(4)
        kw = dict(alpha=(list(a_cells), a_av1c, image_grid(2, 2, 128, 128)), channels=4)
    data = avif_grid(list(cells), 2, 2, 128, 128, (64, 64), av1c, **kw)
    for size in ((120, 120), (130, 100)):
        edited = _with_grid_ispe(data, size)
        got = codecs.rgb8(edited)
        assert got.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(got, pil_rgb(edited))
    edited = _with_grid_ispe(data, (130, 140))
    with pytest.raises(OSError) as pil_error:
        pil_rgb(edited)
    with pytest.raises(codecs.DecodeError) as got:
        codecs.rgb8(edited)
    assert str(pil_error.value).startswith(str(got.value)) and str(got.value) == "image file is truncated"


def test_cell_of_another_size_than_its_ispe_raises_a1():
    """A cell coded 66 wide under an ispe of 64: libavif scales it to its
    ispe (PIL reads the grid), and so does the port (avif_scale); so it
    does a still whose frame is of another size than its ispe."""
    cells, av1c = _cells(4)
    other, _, _ = avif_parts(pil_bytes(photo(64, 66, 72), "AVIF"))
    data = avif_grid(list(cells[:3]) + [other], 2, 2, 128, 128, (64, 64), av1c)
    assert pil_rgb(data).shape == (128, 128, 3)
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))
    still = pil_bytes(photo(64, 66, 3), "AVIF")
    old = _full_box(b"ispe", 0, struct.pack(">II", 66, 64))
    still = still.replace(old, _full_box(b"ispe", 0, struct.pack(">II", 64, 64)))
    assert pil_rgb(still).shape == (64, 64, 3)
    np.testing.assert_array_equal(codecs.rgb8(still), pil_rgb(still))


@needs_encoder
def test_gltf_textured_with_a_segmented_grid(tmp_path):
    """A glTF whose texture is a 2 x 2 grid of cells each coded with
    variance AQ (AV1 segmentation) loads as the JAX loader loads it."""
    parts = [avif_parts(oracle.encode_hbd(yuv_photo(64, 64, 80 + k, 8, 3), 8, 3, quality=50, single=False,
                                          options={"aq-mode": 1})) for k in range(4)]
    data = avif_grid([p[0] for p in parts], 2, 2, 128, 128, (64, 64), parts[0][1], colr=parts[0][2])
    assert pil_rgb(data).shape == (128, 128, 3)
    seg = [avif.av1_obu.frame_header(avif.av1_obu.Bits(pl), avif.av1_obu.sequence_header(sq))["segmentation_enabled"]
           for cell in avif._read(data)[0].cells
           for sq in [next(p for k, p in avif.av1_obu.split_obus(cell) if k == 1)]
           for k, pl in avif.av1_obu.split_obus(cell) if k == 6]
    assert seg == [1, 1, 1, 1]
    got, _ = _assert_same_gltf(_textured_glb(tmp_path / "t.glb", data))
    np.testing.assert_array_equal(got.textures[0], pil_rgb(data).astype(np.float32) / 255.0)
