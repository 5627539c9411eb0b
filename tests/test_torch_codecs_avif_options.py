"""Port parity, AVIF step 2: the 8-bit stills PIL 12 writes with its own
save options, decoded by the port (io/codecs/avif.py, av1_obu.py,
avif_yuv.py and csrc/host/av1_dec.cpp) as PIL decodes them.

- Each step-2 fixture of tests/torch_fixtures/textures uses the tool it
  stands for (its layout, alpha, CDEF strengths, loop restoration types,
  superblock size and tiles, read from its headers).
- A seeded sweep over PIL's options (`subsampling` x `speed` 0-10 x RGB /
  RGBA / premultiplied RGBA x `enable-cdef` x `range`): Y / U / V and alpha planes
  equal to dav1d's (tests/torch_avif_oracle.py) and RGB equal to PIL's
  `convert("RGB")`.
- libavif's conversions for the new layouts on seeded planes (4:4:4 and
  4:2:2 through libyuv, libavif's grey path for 4:0:0 on every code, and
  libyuv's I400ToARGB in its place where the image has alpha) and
  its un-premultiply on every (colour, alpha) pair, each equal to
  libavif's own (`avifImageYUVToRGB`, `avifRGBImageUnpremultiplyAlpha`).
- The alpha item as libavif takes it: without data it is ignored, of
  another size it changes nothing PIL returns for straight alpha and
  raises A.1 premultiplied; one that does not decode, or whose extent
  runs or starts past the end of the file, fails with libavif's reason.
- A glTF and an OBJ textured with a 4:4:4, a premultiplied RGBA, a
  speed-0 loop-restoration and an enable-cdef AVIF load to the JAX
  loaders' scenes, texture for texture.

The oracle cases skip where PIL ships no libavif.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

import torch_avif_oracle as oracle
from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io import obj as tobj
from optixpathtracer_tpu_torch.io.codecs import DecodeError, av1_obu, avif, avif_yuv
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_obj_gltf import _assert_same_gltf, _assert_same_scene, _textured_glb
from torch_codec_encoders import photo, pil_rgb
from torch_fixtures.make_textures import OUT, _iloc
from torch_fixtures.make_textures import avif_with_alpha_of as _with_alpha_of

needs_oracle = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")


def _fixture(name: str) -> bytes:
    with open(os.path.join(OUT, name), "rb") as f:
        return f.read()


def _tools(data: bytes) -> dict:
    """What the primary item's headers say: layout, CDEF and restoration
    in use, superblock size and tiles."""
    obus, _ = avif.parse(data)
    seq = None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
            h = av1_obu.frame_header(av1_obu.Bits(payload), seq)
            return {"layout": "400" if seq["mono"] else {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[seq["ss"]],
                    "cdef": any(map(any, h["cdef_strengths"])), "lr": tuple(h["lr_type"]), "sb128": seq["use_128"],
                    "tiles": (len(h["mi_col_starts"]) - 1, len(h["mi_row_starts"]) - 1)}
    raise AssertionError("no frame header")


W, S, X = av1_obu.RESTORE_WIENER, av1_obu.RESTORE_SGRPROJ, av1_obu.RESTORE_SWITCHABLE
# fixture -> (layout, alpha: None / "straight" / "premultiplied", CDEF, restoration types, 128 superblocks, tiles)
STEP2 = {
    "avif_444.avif": ("444", None, False, (0, 0, 0), 0, (1, 1)),
    "avif_422.avif": ("422", None, False, (0, 0, 0), 0, (1, 1)),
    "avif_400.avif": ("400", None, False, (0, 0, 0), 0, (1, 1)),
    "avif_rgba.avif": ("420", "straight", False, (0, 0, 0), 0, (1, 1)),
    "avif_rgba_premultiplied.avif": ("420", "premultiplied", False, (0, 0, 0), 0, (1, 1)),
    "avif_rgba_444_premultiplied_odd.avif": ("444", "premultiplied", False, (0, 0, 0), 0, (1, 1)),
    "avif_speed0_restoration.avif": ("420", None, False, (0, S, 0), 1, (1, 1)),
    "avif_lr_speed0_256.avif": ("420", None, False, (W, S, W), 1, (1, 1)),
    "avif_lr_speed2_256.avif": ("420", None, False, (0, W, W), 0, (1, 1)),
    "avif_lr_speed4_256.avif": ("420", None, False, (W, W, W), 0, (1, 1)),
    "avif_lr_197x131_tiles.avif": ("420", None, False, (S, W, W), 1, (2, 2)),
    "avif_cdef_420.avif": ("420", None, True, (0, 0, 0), 0, (1, 1)),
    "avif_cdef_422.avif": ("422", None, True, (0, 0, 0), 0, (1, 1)),
    "avif_cdef_444.avif": ("444", None, True, (0, 0, 0), 0, (1, 1)),
    "avif_sb128_cdef_lr.avif": ("420", None, True, (W, S, W), 1, (1, 1)),
    "avif_sequence_32.avif": ("420", None, True, (0, 0, 0), 0, (1, 1)),
    "loft_tex0_444_cdef.avif": ("444", None, True, (0, S, S), 0, (1, 1)),
    "loft_tex1_rgba_prem_lr.avif": ("420", "premultiplied", False, (S, 0, 0), 0, (1, 1)),
    "loft_tex2_422.avif": ("422", None, False, (0, 0, 0), 0, (1, 1)),
}


@pytest.mark.parametrize("name", list(STEP2))
def test_fixture_uses_its_tool(name):
    data = _fixture(name)
    layout, alpha, cdef, lr, sb128, tiles = STEP2[name]
    assert _tools(data) == {"layout": layout, "cdef": cdef, "lr": lr, "sb128": sb128, "tiles": tiles}
    _, _, alpha_obus, premultiplied = avif._parse(data)
    assert (alpha_obus is not None, premultiplied) == (alpha is not None, alpha == "premultiplied")
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


def _sweep_case(seed: int):
    """One seeded draw of PIL's save options and an image for them."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 130)), int(rng.integers(1, 130))
    kw = dict(subsampling=str(rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])), speed=int(rng.integers(0, 11)),
              quality=int(rng.choice([30, 50, 60, 75, 90])))
    if rng.random() < 0.5:
        kw["advanced"] = {"enable-cdef": "1"}
    if rng.random() < 0.3:
        kw["range"] = "limited"
    mode = str(rng.choice(["RGB", "RGBA", "RGBA_premultiplied"]))
    img = photo(h, w, seed, 4 if mode != "RGB" else 3)
    if mode != "RGB":
        img[..., 3] = np.where(rng.random((h, w)) < 0.3, rng.integers(0, 256, (h, w)), img[..., 3])
        kw["alpha_premultiplied"] = mode == "RGBA_premultiplied"
    buf = io.BytesIO()
    Image.fromarray(img, mode[:4]).save(buf, "AVIF", **kw)
    return buf.getvalue()


@needs_oracle
@pytest.mark.parametrize("seed", range(24))
def test_seeded_options_planes_equal_dav1d_rgb_equal_pil(seed):
    data = _sweep_case(seed)
    _assert_planes_equal(data)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


# a template of each layout and size, for libavif to own the planes
TEMPLATES = [(ss, h, w) for ss in ("4:4:4", "4:2:2", "4:0:0") for h, w in ((23, 37), (1, 17), (16, 1), (1, 1))]


@needs_oracle
@pytest.mark.parametrize("ss,h,w", TEMPLATES)
def test_layout_yuv_to_rgb_equals_libavif(ss, h, w):
    buf = io.BytesIO()
    Image.fromarray(photo(h, w, 1)).save(buf, "AVIF", subsampling=ss)
    template = buf.getvalue()
    _, want_planes = oracle.planes(template)
    layout = {"4:4:4": (0, 0), "4:2:2": (1, 0), "4:0:0": None}[ss]
    rng = np.random.default_rng(h * 100 + w)
    for matrix in (1, 2, 5, 6, 9):
        for full in (0, 1):
            planes = [rng.integers(0, 256, p.shape, dtype=np.uint8) for p in want_planes]
            u, v = (planes[1], planes[2]) if layout else (None, None)
            want = oracle.yuv_to_rgb(template, planes[0], u, v, matrix, full)
            np.testing.assert_array_equal(avif_yuv.to_rgb(planes[0], u, v, layout, matrix, full), want)


@needs_oracle
@pytest.mark.parametrize("full", [0, 1])
def test_grey_path_every_code_equals_libavif(full):
    """libavif's own grey conversion, for every Y code, whatever the matrix
    (matrix 0 too, which libyuv would not take)."""
    buf = io.BytesIO()
    Image.fromarray(photo(16, 16, 2)).save(buf, "AVIF", subsampling="4:0:0")
    y = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for matrix in (0, 1, 6, 9):
        want = oracle.yuv_to_rgb(buf.getvalue(), y, None, None, matrix, full)
        np.testing.assert_array_equal(avif_yuv.yuv400_to_rgb(y, full), want)


@needs_oracle
@pytest.mark.parametrize("full", [0, 1])
def test_grey_path_with_alpha_every_code_equals_libavif(full):
    """An image with alpha is asked for in RGBA, and libavif converts 4:0:0
    through libyuv's I400ToARGBMatrix then (it parts from the grey path in
    limited range), identity (0) among them as BT.601."""
    buf = io.BytesIO()
    Image.fromarray(photo(16, 16, 2, 4), "RGBA").save(buf, "AVIF", subsampling="4:0:0")
    y = np.arange(256, dtype=np.uint8).reshape(16, 16)
    alpha = np.full((16, 16), 255, np.uint8)
    for matrix in (1, 2, 5, 6, 9):
        want = oracle.yuv_to_rgb(buf.getvalue(), y, None, None, matrix, full, alpha=alpha)
        np.testing.assert_array_equal(avif_yuv.to_rgb(y, None, None, None, matrix, full, rgba=True), want)
    want = oracle.yuv_to_rgb(buf.getvalue(), y, None, None, 0, full, alpha=alpha)
    np.testing.assert_array_equal(avif_yuv.to_rgb(y, None, None, None, 0, full, rgba=True), want)


@needs_oracle
def test_unpremultiply_every_pair_equals_libavif():
    c, a = np.meshgrid(np.arange(256), np.arange(256))
    rgba = np.stack([c, 255 - c, c // 2, a], -1).astype(np.uint8)
    want = oracle.unpremultiply(rgba)
    np.testing.assert_array_equal(avif_yuv.unpremultiply(rgba[..., :3], rgba[..., 3]), want[..., :3])


def _rgba_avif(h: int, w: int, seed: int, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(photo(h, w, seed, 4), "RGBA").save(buf, "AVIF", **kw)
    return buf.getvalue()


def _edit(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


@pytest.mark.parametrize("case", ["no_location", "empty", "other_size", "other_size_premultiplied", "corrupt",
                                  "cut_short", "past_the_end"])
def test_alpha_item_as_libavif(case):
    prem = case.endswith("premultiplied")
    data = _rgba_avif(40, 48, 10, alpha_premultiplied=prem)
    at2, off2, _ = _iloc(data)[2]
    if case == "no_location":
        data = _edit(data, at2, (9).to_bytes(2, "big"))
    elif case == "empty":
        data = _edit(data, at2 + 10, bytes(4))
    elif case.startswith("other_size"):
        data = _with_alpha_of(data, _rgba_avif(40, 32, 11, alpha_premultiplied=prem))
    elif case == "cut_short":  # the alpha extent runs 10 bytes past the end of the file
        data = _edit(data, at2 + 10, (len(data) - off2 + 10).to_bytes(4, "big"))
    elif case == "past_the_end":  # the alpha extent starts past the end of the file
        data = _edit(data, at2 + 6, (len(data) + 5).to_bytes(4, "big"))
    else:
        data = _edit(data, off2, b"\xff" * 4)
    if case == "other_size_premultiplied":  # libavif scales the alpha to its ispe before it un-premultiplies
        assert pil_rgb(data).shape == (40, 48, 3)
        np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))
    elif case in ("corrupt", "cut_short", "past_the_end"):
        with pytest.raises((RuntimeError, SyntaxError)) as pil_error:
            pil_rgb(data)
        with pytest.raises(DecodeError) as got:
            timg.rgb8_from_bytes(data)
        want = {"corrupt": avif.ALPHA_FAILED, "cut_short": avif.TRUNCATED, "past_the_end": avif.BMFF_FAILED}[case]
        assert str(got.value) == str(pil_error.value) == want
    else:
        np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


SCENE_TEXTURES = ["avif_444.avif", "avif_rgba_premultiplied.avif", "avif_lr_speed0_256.avif", "avif_cdef_420.avif"]


@pytest.mark.parametrize("name", SCENE_TEXTURES)
def test_gltf_and_obj_textured_with_step2_avif(tmp_path, name):
    data = _fixture(name)
    got, _ = _assert_same_gltf(_textured_glb(tmp_path / "t.glb", data))
    np.testing.assert_array_equal(got.textures[0], pil_rgb(data).astype(np.float32) / 255.0)
    (tmp_path / name).write_bytes(data)
    (tmp_path / "m.mtl").write_text(f"newmtl tex\nKd 0.3 0.3 0.3\nmap_Kd {name}\n")
    (tmp_path / "s.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
                                    "usemtl tex\nf 1/1 2/2 3/3\n")
    path = str(tmp_path / "s.obj")
    scene = tobj.load_obj(path)
    _assert_same_scene(scene, jobj.load_obj(path, prefer_native=False))
    assert len(scene.textures) == 1
