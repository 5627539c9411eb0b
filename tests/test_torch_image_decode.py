"""Port parity, io/image decoders: the port's JPEG and PNG decoding against
PIL's `Image.open(...).convert("RGB")` (what the JAX package's
`load_image` and glTF loader use), bit for bit.

JPEG (PIL links libjpeg-turbo; the port follows libjpeg's ISLOW IDCT,
fancy upsampling and fixed-point colour tables): qualities 50 / 75 / 95 in
4:4:4, 4:2:2 and 4:2:0, grey, progressive (PIL's successive-approximation
script), restart intervals, optimised Huffman tables, RGB kept by an Adobe
marker, sizes that are not multiples of the MCU, and 4:4:0 and other
sampling factors PIL does not write, from a test encoder built on the
port's own entropy coder. PNG, every colour type at every bit depth it
allows, plain and Adam7-interlaced, written by an encoder in this file.
Then a glTF with an embedded JPEG and an OBJ with a `.jpg` `map_Kd` load
to host scenes equal to the JAX loaders' array for array, and what stays
unported raises NotImplementedError naming A.1.
"""
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from optixpathtracer_tpu.io import image as jimg
from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch.io import gltf as tgltf
from optixpathtracer_tpu_torch.io import image as timg
from optixpathtracer_tpu_torch.io import obj as tobj
from test_torch_obj_gltf import _assert_same_gltf, _assert_same_scene, _textured_glb
from torch_fixtures.make_textures import AVIF_RAISES, OUT


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients with noise: every coefficient band in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0), 128 + 90 * np.cos(x / 5.0 - y / 3.0),
                    (x * 3 + y * 5) % 256], -1) + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _assert_decodes_like_pil(data: bytes):
    got = timg.rgb8_from_bytes(data)
    want = _pil(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_jpeg_quality_and_subsampling(quality, subsampling):
    _assert_decodes_like_pil(_pil_jpeg(_photo(40, 56, quality), quality=quality,
                                       subsampling=subsampling))


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_grey(quality):
    _assert_decodes_like_pil(_pil_jpeg(_photo(27, 35, 1)[..., 0], quality=quality))


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_jpeg_progressive(mode):
    img = _photo(45, 61, 2)
    kw = dict(quality=80, progressive=True)
    data = _pil_jpeg(img[..., 1], **kw) if mode == "grey" else _pil_jpeg(img, subsampling=mode, **kw)
    assert b"\xff\xc2" in data  # SOF2
    _assert_decodes_like_pil(data)


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=3), dict(restart_marker_rows=1),
                                dict(restart_marker_rows=2, progressive=True),
                                dict(restart_marker_blocks=1, subsampling="4:4:4")])
def test_jpeg_restart_intervals(kw):
    data = _pil_jpeg(_photo(45, 61, 3), quality=75, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI, RST0
    _assert_decodes_like_pil(data)


@pytest.mark.parametrize("size", [(1, 1), (3, 2), (3, 3), (9, 7), (17, 33), (16, 31), (24, 1)])
@pytest.mark.parametrize("subsampling", ["4:2:2", "4:2:0"])
def test_jpeg_sizes_off_the_mcu(size, subsampling):
    _assert_decodes_like_pil(_pil_jpeg(_photo(*size, 4), quality=75, subsampling=subsampling))


@pytest.mark.parametrize("kw", [dict(optimize=True), dict(keep_rgb=True),
                                dict(keep_rgb=True, progressive=True)])
def test_jpeg_optimised_tables_and_rgb(kw):
    _assert_decodes_like_pil(_pil_jpeg(_photo(33, 47, 5), quality=85, **kw))


def _sampled_jpeg(img: np.ndarray, hy: int, vy: int, quality: int = 75) -> bytes:
    """Baseline JPEG with luma sampling factors (hy, vy) and chroma 1x1,
    from the port's encoder pieces (`_scan_bits`, `_pack_bits`, the
    tables): the sampling PIL cannot write, 4:4:0 among them."""
    h, w = img.shape[:2]
    x = torch.as_tensor(img, dtype=torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    ycc = torch.stack([0.299 * r + 0.587 * g + 0.114 * b,
                       -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                       0.5 * r - 0.418688 * g - 0.081312 * b + 128.0])
    pad = (0, -w % (8 * hy), 0, -h % (8 * vy))
    ycc = torch.nn.functional.pad(ycc[None], pad, mode="replicate")[0]
    hp, wp = ycc.shape[1:]
    chroma = ycc[1:].reshape(2, hp // vy, vy, wp // hy, hy).mean((2, 4))
    dct = timg._dct_matrix(torch.device("cpu"))
    luma_q, chroma_q = timg.jpeg_quant_tables(quality)

    def quantise(plane, q_table):
        f = dct @ timg._blocks(plane - 128.0) @ dct.T
        q = torch.as_tensor(q_table.reshape(8, 8), dtype=torch.float32)
        z = torch.round(f / q).to(torch.int32).reshape(*f.shape[:2], 64)[..., timg.JPEG_ZIGZAG]
        z[..., 1:] = z[..., 1:].clamp(-1023, 1023)
        return z

    my, mx = hp // (8 * vy), wp // (8 * hy)
    yb = quantise(ycc[0], luma_q).reshape(my, vy, mx, hy, 64).permute(0, 2, 1, 3, 4)
    cb, cr = (quantise(c, chroma_q).reshape(my * mx, 1, 64) for c in chroma)
    coefs = torch.cat([yb.reshape(my * mx, vy * hy, 64), cb, cr], 1).reshape(-1, 64)
    comp = np.tile(np.array([0] * (hy * vy) + [1, 2]), my * mx)
    scan = timg._pack_bits(*timg._scan_bits(coefs.numpy(), comp))
    dqt = b"".join(bytes([i]) + q[timg.JPEG_ZIGZAG].astype(np.uint8).tobytes()
                   for i, q in enumerate((luma_q, chroma_q)))
    dht = b"".join(bytes([tc_th]) + bytes(timg.JPEG_HUFFMAN[n][0]) + bytes(timg.JPEG_HUFFMAN[n][1])
                   for n, tc_th in (("dc_luma", 0x00), ("ac_luma", 0x10), ("dc_chroma", 0x01),
                                    ("ac_chroma", 0x11)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, hy << 4 | vy, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + timg._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + timg._segment(0xDB, dqt) + timg._segment(0xC0, sof) + timg._segment(0xC4, dht)
            + timg._segment(0xDA, sos) + scan + b"\xff\xd9")


@pytest.mark.parametrize("hy,vy", [(1, 2), (2, 1), (2, 2), (1, 1)])
@pytest.mark.parametrize("size", [(19, 13), (32, 48), (2, 9)])
def test_jpeg_sampling_factors(hy, vy, size):
    """(1, 2) is 4:4:0, libjpeg's h1v2 fancy upsampling."""
    _assert_decodes_like_pil(_sampled_jpeg(_photo(*size, 6), hy, vy))


def test_unported_formats_raise_naming_a1():
    """What this test once held unported now decodes as PIL does (arithmetic
    and CMYK JPEG, BMP, GIF, TIFF, WebP, MSP, JPEG 2000;
    tests/test_torch_codecs_*.py case by case) and AVIF at PIL's defaults
    and in 4:4:4, an AVIF with quantizer matrices, an AVIF grid, a
    premultiplied AVIF alpha of another size than the colour and an AVIF
    inter frame; a variant PIL reads and the port does not (an inter frame
    with AVIF step 8's motion-field projection) still raises A.1;
    what PIL cannot read (a 12-bit JPEG, bytes of no format) raises an
    OSError as PIL's UnidentifiedImageError is one."""
    base = _pil_jpeg(_photo(16, 16, 7), quality=75)
    sof = base.index(b"\xff\xc0")
    arithmetic = base[:sof] + b"\xff\xc9" + base[sof + 2:]
    twelve_bit = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    buf = io.BytesIO()
    Image.fromarray(_photo(16, 16, 7)).convert("CMYK").save(buf, format="JPEG")
    cmyk = buf.getvalue()
    for data in (arithmetic, cmyk):
        _assert_decodes_like_pil(data)
    for fmt in ("BMP", "GIF", "TIFF", "WEBP"):
        buf = io.BytesIO()
        Image.fromarray(_photo(8, 8, 9)).save(buf, format=fmt)
        assert _pil(buf.getvalue()).shape == (8, 8, 3)  # PIL reads it, and so does the port
        _assert_decodes_like_pil(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_photo(8, 8, 9)).convert("1").save(buf, format="MSP")
    assert _pil(buf.getvalue()).shape == (8, 8, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_photo(8, 8, 9)).save(buf, format="JPEG2000")
    assert _pil(buf.getvalue()).shape == (8, 8, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_photo(8, 8, 9)).save(buf, format="AVIF")
    assert _pil(buf.getvalue()).shape == (8, 8, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_photo(8, 8, 9)).save(buf, format="AVIF", subsampling="4:4:4")
    assert _pil(buf.getvalue()).shape == (8, 8, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_photo(8, 8, 9)).save(buf, format="AVIF", advanced={"enable-qm": "1"})
    assert _pil(buf.getvalue()).shape == (8, 8, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(buf.getvalue())
    with open(os.path.join(OUT, "avif_grid.avif"), "rb") as f:
        grid = f.read()
    assert _pil(grid).shape == (128, 128, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(grid)
    with open(os.path.join(OUT, "avif_prem_alpha_other_size.avif"), "rb") as f:
        prem = f.read()
    assert _pil(prem).shape == (40, 48, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(prem)
    with open(os.path.join(OUT, "avif_inter_420.avif"), "rb") as f:
        inter = f.read()
    assert _pil(inter).shape == (96, 64, 3)  # once unported here, now decoded as PIL decodes it
    _assert_decodes_like_pil(inter)
    with open(os.path.join(AVIF_RAISES, "avif_inter_shown_first.avif"), "rb") as f:
        step8 = f.read()
    assert _pil(step8).shape == (32, 48, 3)
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*A.1"):
        timg.rgb8_from_bytes(step8)
    for data in (twelve_bit, b"no image format" + bytes(20)):
        with pytest.raises(OSError, match="cannot identify"):
            _pil(data)
        with pytest.raises(OSError, match="cannot identify"):
            timg.rgb8_from_bytes(data)


# ---- PNG ----------------------------------------------------------------------

_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_CASES = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
                                  6: (8, 16)}.items() for d in ds]


def _pack_row(samples: np.ndarray, depth: int) -> bytes:
    """One scanline's samples (flat) packed at `depth` bits, MSB first."""
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = ((samples[:, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits).tobytes()


def _filtered(rows: list[bytes], bpp: int) -> bytes:
    """Each row filtered with filter y % 5 (PNG spec 9.2)."""
    out, prior = [], None
    for y, row in enumerate(rows):
        cur = np.frombuffer(row, np.uint8).astype(np.int32)
        up = np.zeros_like(cur) if prior is None else prior
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:len(cur)]
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:len(cur)]
        f = y % 5
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(out)


def _png(samples: np.ndarray, color: int, depth: int, interlace: int, plte=None) -> bytes:
    """PNG bytes of (H, W, C) samples, written independently of the decoder."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered([_pack_row(r.reshape(-1), depth) for r in sub], bpp)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        data += chunk(b"PLTE", plte.tobytes())
    return data + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", PNG_CASES)
def test_png_every_colour_type_depth_and_interlace(color, depth, interlace):
    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    h, w = 13, 11  # Adam7 passes of every shape, partial bytes at low depths
    samples = rng.integers(0, 1 << depth, (h, w, _CH[color]), dtype=np.int64)
    samples[4:7] //= 3  # smooth rows make the predictors matter
    if depth == 16:  # PIL's clamp of 16-bit grey and high byte of the rest
        samples[0, :6, 0] = [0, 255, 256, 1000, 65535, 32768]
    plte = rng.integers(0, 256, (min(1 << depth, 200), 3), dtype=np.uint8) if color == 3 else None
    data = _png(samples, color, depth, interlace, plte)
    _assert_decodes_like_pil(data)
    px, got_color, _, got_depth = timg.decode_png(data)
    assert (got_color, got_depth) == (color, depth)
    np.testing.assert_array_equal(px, samples)


def test_png_16_bit_conversion_pinned():
    """PIL's two 16-bit conversions, measured on PIL 12.1.0: RGB keeps the high
    byte, grey (mode I;16) clamps to 255."""
    vals = np.array([[[255, 256, 65535]]], np.int64)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(_png(vals, 2, 16, 0))[0, 0], [0, 1, 255])
    grey = np.array([[0, 255, 256, 1000, 65535, 32768]], np.int64)[..., None]
    np.testing.assert_array_equal(timg.rgb8_from_bytes(_png(grey, 0, 16, 0))[0, :, 0],
                                  [0, 255, 255, 255, 255, 255])


# ---- scenes with JPEG and 16-bit PNG textures -----------------------------------

def test_gltf_embedded_jpeg_equal_to_jax(tmp_path):
    data = _pil_jpeg(_photo(12, 20, 10), quality=90, subsampling="4:2:0")
    got, _ = _assert_same_gltf(_textured_glb(tmp_path / "jpeg.glb", data))
    np.testing.assert_array_equal(got.textures[0], _pil(data).astype(np.float32) / 255.0)


@pytest.mark.parametrize("ext", ["jpg", "png16"])
def test_obj_map_kd_jpeg_and_16_bit_png_equal_to_jax(tmp_path, ext):
    img = _photo(9, 14, 11)
    if ext == "jpg":
        (tmp_path / "tex.jpg").write_bytes(_pil_jpeg(img, quality=75, progressive=True))
        name = "tex.jpg"
    else:
        (tmp_path / "tex.png").write_bytes(_png(img.astype(np.int64) * 257 + 3, 2, 16, 1))
        name = "tex.png"
    (tmp_path / "m.mtl").write_text(f"newmtl tex\nKd 0.3 0.3 0.3\nmap_Kd {name}\n")
    (tmp_path / "s.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
                                    "usemtl tex\nf 1/1 2/2 3/3\n")
    path = str(tmp_path / "s.obj")
    got, want = tobj.load_obj(path), jobj.load_obj(path, prefer_native=False)
    _assert_same_scene(got, want)
    assert len(got.textures) == 1
    np.testing.assert_array_equal(timg.load_image(str(tmp_path / name)),
                                  jimg.load_image(str(tmp_path / name)))


def test_gltf_arithmetic_jpeg_raises(tmp_path):
    """An arithmetic-coded JPEG once raised A.1 here; it now loads to the JAX
    loader's scene (its PIL decodes the texture), array for array. A
    12-bit one, which PIL cannot read, gives both loaders' factor-only
    material with a warning."""
    base = _pil_jpeg(_photo(8, 8, 12), quality=75)
    sof = base.index(b"\xff\xc0")
    path = _textured_glb(tmp_path / "arith.glb", base[:sof] + b"\xff\xc9" + base[sof + 2:])
    got, _ = _assert_same_gltf(path)
    assert len(got.textures) == 1
    path = _textured_glb(tmp_path / "twelve.glb", base[:sof + 4] + b"\x0c" + base[sof + 5:])
    with pytest.warns(UserWarning, match="undecodable"):
        got, _ = _assert_same_gltf(path)
    assert not got.textures and got.meshes[0].material["texture_id"] == -1
