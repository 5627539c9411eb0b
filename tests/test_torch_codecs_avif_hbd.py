"""Port parity, AVIF step 3: 10- and 12-bit AV1 stills (profiles 0-2, every
layout, alpha, CDEF, loop restoration) decoded by the port
(io/codecs/avif.py, av1_obu.py, avif_yuv.py and the uint16 decoder of
csrc/host/av1_dec.cpp) as PIL decodes them.

- Each step-3 fixture of tests/torch_fixtures/textures uses the tool it
  stands for (profile, depth, layout, range, alpha, CDEF, restoration
  types, superblock size, tiles, screen-content tools and IntraBC, read
  from its headers), and its RGB equals PIL's `convert("RGB")`; its planes
  equal dav1d's in test_torch_codecs_avif_planes.py.
- A seeded sweep encoded here through OpenCV's libavif
  (tests/torch_avif_oracle.py `encode_hbd`): depth x layout x range x RGB /
  RGBA / premultiplied x CDEF / restoration, Y / U / V and alpha planes
  equal to dav1d's and RGB equal to PIL's; and 12-bit loop restoration,
  which aom does not write, on 10-bit stills relabelled 12-bit
  (make_textures.avif_as_12bit).
- libavif 1.3's high-depth conversions to 8-bit RGB(A) on every code:
  the Y, U and V maps of each route (the planes brought to 8 bits, libyuv's
  YuvPixel10 / YuvPixel12 after 10-bit upsampling or nearest chroma, the
  grey path at the depth) for matrices 1, 2, 5, 6 and 9 in both ranges,
  the alpha brought to 8 bits beside each layout, and the un-premultiply
  after it, each equal to libavif's `avifImageYUVToRGB`.
- An alpha item of another depth than the colour's fails as PIL fails;
  high-depth stills with the step-4 tools (quantizer matrices, delta q),
  which once raised A.1, decode as PIL decodes them (the rest of step 4 is
  test_torch_codecs_avif_tools.py); under OPTIX_TPU_NO_NATIVE=1 a 10-bit
  still raises naming the switch.
- A glTF and an OBJ textured with a 10-bit AVIF load to the JAX loaders'
  scenes, texture for texture.

The oracle cases skip where PIL ships no libavif, the encoded ones where
OpenCV ships none.
"""
import os

import numpy as np
import pytest

import torch_avif_oracle as oracle
from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io import obj as tobj
from optixpathtracer_tpu_torch.io.codecs import DecodeError, av1_obu, avif, avif_yuv
from test_torch_codecs_avif import _color_config_bit
from test_torch_codecs_avif_planes import _assert_planes_equal
from test_torch_obj_gltf import _assert_same_gltf, _assert_same_scene, _textured_glb
from torch_codec_encoders import pil_rgb, yuv_photo
from torch_fixtures.make_textures import OUT, avif_as_12bit

needs_oracle = pytest.mark.skipif(not oracle.available(), reason="PIL ships no libavif here")
needs_encoder = pytest.mark.skipif(not (oracle.available() and oracle.hbd_available()),
                                   reason="PIL or OpenCV ships no libavif here")
LAYOUTS = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: None}  # libavif yuvFormat -> subsampling


def _fixture(name: str) -> bytes:
    with open(os.path.join(OUT, name), "rb") as f:
        return f.read()


def _tools(data: bytes) -> dict:
    """What the primary item's headers say."""
    obus, _ = avif.parse(data)
    seq = None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
            h = av1_obu.frame_header(av1_obu.Bits(payload), seq)
            layout = "400" if seq["mono"] else {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[seq["ss"]]
            return {"profile": seq["profile"], "depth": seq["bit_depth"], "layout": layout,
                    "full": seq["color_range"], "cdef": any(map(any, h["cdef_strengths"])),
                    "lr": tuple(h["lr_type"]), "sb128": seq["use_128"],
                    "tiles": (len(h["mi_col_starts"]) - 1, len(h["mi_row_starts"]) - 1),
                    "sct": h["allow_screen_content_tools"], "intrabc": h["allow_intrabc"]}
    raise AssertionError("no frame header")


W, S = av1_obu.RESTORE_WIENER, av1_obu.RESTORE_SGRPROJ
NO_LR = (0, 0, 0)
# fixture -> (profile, depth, layout, full range, alpha: None / "straight" / "premultiplied", CDEF,
#             restoration types, 128 superblocks, tiles, screen-content tools, IntraBC)
STEP3 = {
    "avif10_420.avif": (0, 10, "420", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_444.avif": (1, 10, "444", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_422.avif": (2, 10, "422", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_400.avif": (0, 10, "400", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_420.avif": (2, 12, "420", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_444.avif": (2, 12, "444", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_422.avif": (2, 12, "422", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_400.avif": (2, 12, "400", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_rgba.avif": (0, 10, "420", 1, "straight", False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_rgba_444_premultiplied.avif": (1, 10, "444", 1, "premultiplied", False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_400_rgba_premultiplied.avif": (0, 10, "400", 1, "premultiplied", False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_rgba_422.avif": (2, 12, "422", 1, "straight", True, NO_LR, 0, (1, 1), 0, 0),
    "avif12_rgba_premultiplied.avif": (2, 12, "420", 1, "premultiplied", True, NO_LR, 0, (1, 1), 0, 0),
    "avif10_limited_37x23.avif": (0, 10, "420", 0, None, True, NO_LR, 0, (1, 1), 0, 0),
    "avif10_bt709_limited_444.avif": (1, 10, "444", 0, None, True, NO_LR, 0, (1, 1), 0, 0),
    "avif12_bt2020_limited_422.avif": (2, 12, "422", 0, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_bt709.avif": (2, 12, "420", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif10_cdef_lr_speed0_128.avif": (0, 10, "420", 1, None, True, (W, W, W), 1, (1, 1), 0, 0),
    "avif10_cdef_lr_speed2_128.avif": (1, 10, "444", 1, None, True, (W, W, W), 0, (1, 1), 0, 0),
    "avif10_cdef_lr_speed4_128.avif": (2, 10, "422", 1, None, True, (W, S, W), 0, (1, 1), 0, 0),
    "avif12_cdef_sb128.avif": (2, 12, "420", 1, None, True, NO_LR, 1, (1, 1), 0, 0),
    "avif12_lr_relabelled_420.avif": (2, 12, "420", 1, None, True, (W, S, W), 0, (1, 1), 0, 0),
    "avif12_17x1.avif": (2, 12, "420", 1, None, True, NO_LR, 0, (1, 1), 0, 0),
    "avif10_1x9_444.avif": (1, 10, "444", 1, None, False, NO_LR, 0, (1, 1), 0, 0),
    "avif12_tiles_197x131.avif": (2, 12, "420", 1, None, True, NO_LR, 0, (2, 2), 0, 0),
    "avif10_loft_tex1_intrabc.avif": (0, 10, "420", 1, None, False, NO_LR, 0, (1, 1), 1, 1),
    "avif12_palette.avif": (2, 12, "444", 1, None, False, NO_LR, 0, (1, 1), 1, 0),
}


@pytest.mark.parametrize("name", list(STEP3))
def test_fixture_uses_its_tool(name):
    data = _fixture(name)
    profile, depth, layout, full, alpha, cdef, lr, sb128, tiles, sct, intrabc = STEP3[name]
    assert _tools(data) == {"profile": profile, "depth": depth, "layout": layout, "full": full, "cdef": cdef,
                            "lr": lr, "sb128": sb128, "tiles": tiles, "sct": sct, "intrabc": intrabc}
    _, _, alpha_obus, premultiplied = avif._parse(data)
    assert (alpha_obus is not None, premultiplied) == (alpha is not None, alpha == "premultiplied")
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


def _sweep_case(seed: int) -> bytes:
    """One seeded draw: depth, layout, range, matrix, RGB / RGBA /
    premultiplied, CDEF, and a size and speed where aom restores in every
    fourth, at 96 x 64 or less."""
    rng = np.random.default_rng(seed)
    depth, fmt = (10, 12)[seed % 2], 1 + (seed // 2) % 4
    h, w = int(rng.integers(1, 65)), int(rng.integers(1, 97))
    full = int(rng.random() < 0.6)
    mode = ("RGB", "RGBA", "premultiplied")[(seed // 8) % 3]
    kw = dict(speed=int(rng.choice([1, 3, 6, 8])), quality=int(rng.choice([30, 50, 70, 90])),
              matrix=int(rng.choice([1, 2, 5, 6, 9])))
    if rng.random() < 0.5:
        kw["options"] = {"enable-cdef": 1}
    if depth == 10 and seed % 4 == 0:  # where aom restores (it writes no restoration at 12 bits)
        h, w, kw["speed"] = 64, 96, 1
    alpha = None
    if mode != "RGB":
        alpha = yuv_photo(h, w, seed + 500, depth, 4)[0]
        alpha[rng.random((h, w)) < 0.3] = rng.integers(0, 1 << depth)
    return oracle.encode_hbd(yuv_photo(h, w, seed, depth, fmt, full), depth, fmt, full=full, alpha=alpha,
                             premultiplied=mode == "premultiplied", **kw)


@needs_encoder
@pytest.mark.parametrize("seed", range(24))
def test_seeded_sweep_planes_equal_dav1d_rgb_equal_pil(seed):
    data = _sweep_case(seed)
    _assert_planes_equal(data)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


@needs_encoder
@pytest.mark.parametrize("seed", [0, 4, 5, 6, 7, 8])
def test_12bit_restoration_of_relabelled_stills_equals_dav1d(seed):
    """aom writes no loop restoration at 12 bits; a 10-bit still with it,
    relabelled 12-bit (its tiles as coded), is decoded by dav1d and the port
    with the 12-bit Wiener rounding (InterRound0 5, InterRound1 9) and the
    self-guided filter's BitDepth - 8 shifts: planes equal, RGB equal to
    PIL's."""
    rng = np.random.default_rng(seed)
    fmt = 3 if seed % 2 else 2
    h, w = int(rng.integers(48, 129)), int(rng.integers(48, 129))
    data = avif_as_12bit(oracle.encode_hbd(yuv_photo(h, w, seed, 10, fmt), 10, fmt, speed=int(rng.integers(0, 5)),
                                           quality=int(rng.choice([30, 50, 70])), options={"enable-cdef": 1}))
    tools = _tools(data)
    assert (tools["profile"], tools["depth"]) == (2, 12) and any(tools["lr"])
    _assert_planes_equal(data)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


def _every_code(depth: int, fmt: int, seed: int):
    """Planes of a layout whose Y, U and V each take every code of the
    depth (a seeded permutation in each), 64 samples wide."""
    n = 1 << depth
    sub = LAYOUTS[fmt] or (0, 0)
    h, w = (n << sub[1]) // 64, 64 << sub[0]
    rng = np.random.default_rng(seed)
    y = np.resize(rng.permutation(n), h * w).reshape(h, w).astype(np.uint16)
    if LAYOUTS[fmt] is None:
        return y, None, None
    u, v = (rng.permutation(n).reshape(n // 64, 64).astype(np.uint16) for _ in range(2))
    return y, u, v


@needs_oracle
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("fmt", [1, 2, 3])
@pytest.mark.parametrize("rgba", [False, True], ids=["rgb", "rgba"])
def test_conversion_every_code_equals_libavif(depth, fmt, rgba):
    """Each route's per-sample maps on every code of Y, U and V: the
    planes brought to 8 bits (RGB; RGBA at 12 bits in 4:4:4 / 4:2:2),
    YuvPixel10 after 10-bit upsampling (RGBA at 10 bits), YuvPixel12 on
    nearest chroma (RGBA in 12-bit 4:2:0)."""
    y, u, v = _every_code(depth, fmt, depth * 10 + fmt)
    h, w = y.shape
    alpha = np.full((h, w), (1 << depth) - 1, np.uint16) if rgba else None
    for matrix in (1, 2, 5, 6, 9):
        for full in (0, 1):
            want = oracle.yuv_to_rgb((w, h, depth, fmt), y, u, v, matrix, full, alpha=alpha)
            got = avif_yuv.to_rgb(y, u, v, LAYOUTS[fmt], matrix, full, rgba=rgba, depth=depth)
            np.testing.assert_array_equal(got, want, err_msg=f"matrix {matrix} full {full}")


@needs_oracle
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("full", [0, 1])
def test_grey_every_code_equals_libavif(depth, full):
    """4:0:0 on every Y code: RGB through libavif's grey path at the depth,
    whatever matrix it takes; RGBA through I400ToARGBMatrix on the 8-bit Y,
    identity (0) as BT.601 there."""
    y, _, _ = _every_code(depth, 4, depth + full)
    h, w = y.shape
    for matrix in (0, 1, 6, 9):
        want = oracle.yuv_to_rgb((w, h, depth, 4), y, None, None, matrix, full)
        np.testing.assert_array_equal(avif_yuv.to_rgb(y, None, None, None, matrix, full, depth=depth), want)
    alpha = np.full((h, w), (1 << depth) - 1, np.uint16)
    for matrix in (1, 2, 5, 6, 9):
        want = oracle.yuv_to_rgb((w, h, depth, 4), y, None, None, matrix, full, alpha=alpha)
        np.testing.assert_array_equal(avif_yuv.to_rgb(y, None, None, None, matrix, full, rgba=True, depth=depth),
                                      want)
    want = oracle.yuv_to_rgb((w, h, depth, 4), y, None, None, 0, full, alpha=alpha)
    np.testing.assert_array_equal(avif_yuv.to_rgb(y, None, None, None, 0, full, rgba=True, depth=depth), want)


@needs_oracle
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_alpha_every_code_and_unpremultiply_equal_libavif(depth, fmt):
    """The alpha brought to 8 bits on every code beside each layout, and
    the un-premultiply libavif runs after it on the 8-bit RGBA."""
    n = 1 << depth
    a = np.arange(n, dtype=np.uint16).reshape(n // 64, 64)
    y, u, v = _every_code(depth, fmt, depth * 7 + fmt)
    y = np.resize(y, a.shape)
    if u is not None:
        sx, sy = LAYOUTS[fmt]
        u, v = (np.resize(c, ((a.shape[0] + sy) >> sy, (64 + sx) >> sx)) for c in (u, v))
    h, w = a.shape
    want = oracle.yuv_to_rgb((w, h, depth, fmt), y, u, v, 6, 1, alpha=a, rgba=True)
    ss = LAYOUTS[fmt]
    np.testing.assert_array_equal(avif_yuv.alpha8(a, depth, ss), want[..., 3])
    rgb = avif_yuv.to_rgb(y, u, v, ss, 6, 1, rgba=True, depth=depth)
    np.testing.assert_array_equal(rgb, want[..., :3])
    prem = oracle.yuv_to_rgb((w, h, depth, fmt), y, u, v, 6, 1, alpha=a, premultiplied=1)
    np.testing.assert_array_equal(avif_yuv.unpremultiply(rgb, avif_yuv.alpha8(a, depth, ss)), prem)


def _with_alpha_depth_flipped(data: bytes) -> bytes:
    """`data` with its alpha item's high_bitdepth bit flipped."""
    _, _, alpha_obus, _ = avif._parse(data)
    payload = next(p for k, p in av1_obu.split_obus(alpha_obus) if k == av1_obu.OBU_SEQUENCE_HEADER)
    at = data.index(payload)
    edited = bytearray(payload)
    bit = _color_config_bit(payload)
    edited[bit >> 3] ^= 0x80 >> (bit & 7)
    return data[:at] + bytes(edited) + data[at + len(payload):]


@pytest.mark.parametrize("name", ["avif10_rgba.avif", "avif10_rgba_444_premultiplied.avif", "avif_rgba.avif",
                                  "avif_rgba_premultiplied.avif"])
def test_alpha_of_another_depth_fails_as_pil(name):
    """A 10-bit colour with an 8-bit alpha item, or an 8-bit colour with a
    10-bit one: libavif fails the alpha plane, and so does the port."""
    data = _with_alpha_depth_flipped(_fixture(name))
    with pytest.raises(RuntimeError) as pil_error:
        pil_rgb(data)
    with pytest.raises(DecodeError) as got:
        timg.rgb8_from_bytes(data)
    assert str(got.value) == str(pil_error.value) == avif.ALPHA_FAILED


@needs_encoder
@pytest.mark.parametrize("depth,size,options,variant", [
    (10, 64, {"enable-qm": 1}, "AV1 quantizer matrices"), (12, 64, {"enable-qm": 1}, "AV1 quantizer matrices"),
    (10, 128, {"deltaq-mode": 3}, "AV1 delta q / delta lf")])
def test_step4_tools_at_high_depth_raise_a1(depth, size, options, variant):
    """Once A.1 here (AVIF step 4), now decoded: the high-depth still with
    quantizer matrices or delta q (aom writes delta q on 128 x 128 with
    deltaq-mode 3, not on 64 x 64) carries its tool, its planes equal
    dav1d's and its RGB PIL's."""
    data = oracle.encode_hbd(yuv_photo(size, size, 3, depth, 3), depth, 3, options=options)
    obus, _ = avif.parse(data)
    seq = av1_obu.sequence_header(av1_obu.split_obus(obus)[1][1])
    h = av1_obu.frame_header(av1_obu.Bits(av1_obu.split_obus(obus)[2][1]), seq)
    assert seq["bit_depth"] == depth
    assert h["using_qmatrix"] if variant == "AV1 quantizer matrices" else h["delta_q_present"]
    _assert_planes_equal(data)
    np.testing.assert_array_equal(codecs.rgb8(data), pil_rgb(data))


def test_no_native_raises_naming_the_switch(monkeypatch):
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    with pytest.raises(NotImplementedError, match="OPTIX_TPU_NO_NATIVE"):
        codecs.rgb8(_fixture("avif10_420.avif"))


@pytest.mark.parametrize("name", ["avif10_loft_tex1_intrabc.avif", "avif12_rgba_premultiplied.avif"])
def test_gltf_and_obj_textured_with_high_depth_avif(tmp_path, name):
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
