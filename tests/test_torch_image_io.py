"""Port parity, io/image: the port's own PNG codec against PIL (the JAX
package's `load_image` / `save_png`), and the Radiance .hdr and PFM code
against the JAX package's.

Every comparison is exact: decoded uint8 values, the float32 images after
`/ 255.0` and the y-flip, RGBE bytes, and PFM files byte for byte.
"""
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from optixpathtracer_tpu.io import image as jimg
from optixpathtracer_tpu_torch.io import image as timg
from test_torch_image_decode import _png as adam7_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOFT_PNGS = [os.path.join(REPO, "scenes", f"loft_tex{i}.png") for i in range(3)]
MODES = {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}  # PIL mode -> PNG colour type


def _png(raw_rows: np.ndarray, color: int, filters, depth=8, interlace=0, plte=None) -> bytes:
    """PNG bytes of (H, stride) unfiltered uint8 scanlines, row y filtered
    with filters[y % len(filters)] (PNG spec 9.2, written here
    independently of the decoder under test)."""
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, stride = raw_rows.shape
    x = raw_rows.astype(np.int32)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
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

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    w = stride // bpp
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        data += chunk(b"PLTE", plte.tobytes())
    return data + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b"")


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("flip_y", [True, False])
def test_loft_pngs_equal_to_jax_load_image(flip_y):
    for path in LOFT_PNGS:
        got = timg.load_image(path, flip_y=flip_y)
        want = jimg.load_image(path, flip_y=flip_y)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_loft_png_sums_of_the_card_check_come_from_pil():
    """chip_smoke.py checks the port's decode on the card's machine, which
    has no PIL, against these channel sums."""
    for path in LOFT_PNGS:
        want = np.asarray(Image.open(path).convert("RGB")).reshape(-1, 3).sum(0, dtype=np.int64)
        assert chip_smoke.LOFT_PNG_SUMS[os.path.basename(path)] == want.tolist()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_colour_type_written_by_pil(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    px = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    img = Image.fromarray(px, "RGBA")
    if mode == "P":
        img = img.convert("RGB").convert("P", palette=Image.Palette.ADAPTIVE, colors=37)
    else:
        img = img.convert(mode)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    assert timg.decode_png(open(path, "rb").read())[1] == MODES[mode]
    np.testing.assert_array_equal(timg.read_rgb8(path), np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(timg.load_image(path), jimg.load_image(path))


@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_every_filter(color, filters):
    rng = np.random.default_rng(7 * color + len(filters))
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rows = rng.integers(0, 256, (11, 9 * bpp), dtype=np.uint8)
    rows[3:6] //= 17  # smooth rows make the predictors matter
    plte = rng.integers(0, 256, (200, 3), dtype=np.uint8) if color == 3 else None
    if color == 3:
        rows %= 230  # some indices past the 200-entry palette read black
    data = _png(rows, color, filters, plte=plte)
    np.testing.assert_array_equal(timg.rgb8_from_png(data), _pil_rgb(data))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((19, 23, 3)).astype(np.float32)
    img[0, 0] = (-0.5, 1.5, 0.5)  # clipped
    for arr in (img, (img.clip(0, 1) * 255).astype(np.uint8),
                rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)):
        tp, jp = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
        timg.save_png(tp, arr)
        jimg.save_png(jp, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(tp)), np.asarray(Image.open(jp)))
        np.testing.assert_array_equal(timg.load_image(tp, flip_y=False), jimg.load_image(jp, flip_y=False))


def _hdr_image(seed=2):
    rng = np.random.default_rng(seed)
    img = (rng.random((9, 12, 3)) * np.logspace(-3, 4, 12)[None, :, None]).astype(np.float32)
    img[0, :3] = 0.0
    return img


def test_hdr_round_trip_across_packages(tmp_path):
    img = _hdr_image()
    tp, jp = str(tmp_path / "port.hdr"), str(tmp_path / "jax.hdr")
    timg.save_hdr(tp, img)
    jimg.save_hdr(jp, img)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    want = jimg.load_hdr(jp)
    for got in (timg.load_hdr(jp), jimg.load_hdr(tp), timg.load_hdr(tp)):
        assert got.dtype == want.dtype and got.shape == (9, 12, 3)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timg.float_to_rgbe(img), jimg.float_to_rgbe(img))
    rgbe = jimg.float_to_rgbe(img)
    np.testing.assert_array_equal(timg.rgbe_to_float(rgbe), jimg.rgbe_to_float(rgbe))
    # 8-bit mantissas under the pixel's shared exponent
    assert (np.abs(want - img) <= img.max(-1, keepdims=True) * 2 ** -7).all()


def test_hdr_rle_scanlines(tmp_path):
    """New-style RLE scanlines (runs and literals) decode as the reference's."""
    rgbe = jimg.float_to_rgbe(_hdr_image(3))
    h, w = rgbe.shape[:2]
    body = b""
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            ch = rgbe[y, :, c]
            body += bytes([128 + 4, ch[0]]) + bytes([w - 4]) + ch[4:].tobytes()  # a run, then literals
    path = str(tmp_path / "rle.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode() + body)
    np.testing.assert_array_equal(timg.load_hdr(path), jimg.load_hdr(path))


def test_pfm_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    for img in (rng.random((7, 5, 3)).astype(np.float32), rng.random((7, 5)).astype(np.float32)):
        tp, jp = str(tmp_path / "port.pfm"), str(tmp_path / "jax.pfm")
        timg.save_pfm(tp, img)
        jimg.save_pfm(jp, img)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        np.testing.assert_array_equal(timg.load_pfm(tp), jimg.load_pfm(jp))
        np.testing.assert_array_equal(timg.load_pfm(tp), img)


def test_unported_formats_raise(tmp_path):
    """The formats this test once held unported now decode as PIL does
    (tests/test_torch_image_decode.py and tests/test_torch_codecs_*.py
    cover them case by case), an arithmetic-coded JPEG and XBM too, JPEG
    2000 and AVIF at PIL's defaults (once here) as well, and AVIF with
    alpha and with quantizer matrices (each once the example here), and an
    AVIF whose nclx names matrix coefficients 0 (identity, which libavif
    converts without libyuv: AVIF step 5), once the example of a variant
    raising A.1 here, and a premultiplied alpha of another size (AVIF step
    6); an AVIF whose item shows an inter frame first, which PIL reads,
    raises A.1 naming it (AVIF step 7)."""
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    buf16, jpg = io.BytesIO(), io.BytesIO()
    Image.fromarray(px[..., 0].astype(np.uint16) * 257).save(buf16, format="PNG")
    Image.fromarray(px).save(jpg, format="JPEG")
    interlaced = adam7_png(px.astype(np.int64), 2, 8, 1)
    assert _pil_rgb(buf16.getvalue()).shape == _pil_rgb(jpg.getvalue()).shape == (6, 8, 3)  # PIL decodes them
    for data in (buf16.getvalue(), jpg.getvalue(), interlaced):
        np.testing.assert_array_equal(timg.rgb8_from_bytes(data), _pil_rgb(data))
    # plain scanlines under an interlaced header: PIL rejects them, and so does the port
    malformed = _png(px.reshape(6, -1), 2, (0,), interlace=1)
    with pytest.raises(OSError):
        _pil_rgb(malformed)
    with pytest.raises(ValueError):
        timg.rgb8_from_bytes(malformed)
    path = str(tmp_path / "photo.jpg")
    with open(path, "wb") as f:
        f.write(jpg.getvalue())
    np.testing.assert_array_equal(timg.load_image(path), jimg.load_image(path))
    sof = jpg.getvalue().index(b"\xff\xc0")
    arithmetic = jpg.getvalue()[:sof] + b"\xff\xc9" + jpg.getvalue()[sof + 2:]
    np.testing.assert_array_equal(timg.rgb8_from_bytes(arithmetic), _pil_rgb(arithmetic))
    xbm = io.BytesIO()
    Image.fromarray(px).convert("1").save(xbm, format="XBM")
    assert _pil_rgb(xbm.getvalue()).shape == (6, 8, 3)  # PIL reads it, and so does the port
    np.testing.assert_array_equal(timg.rgb8_from_bytes(xbm.getvalue()), _pil_rgb(xbm.getvalue()))
    j2k = io.BytesIO()
    Image.fromarray(px).save(j2k, format="JPEG2000")
    assert _pil_rgb(j2k.getvalue()).shape == (6, 8, 3)  # PIL reads it, and so does the port
    np.testing.assert_array_equal(timg.rgb8_from_bytes(j2k.getvalue()), _pil_rgb(j2k.getvalue()))
    avif = io.BytesIO()
    Image.fromarray(px).save(avif, format="AVIF")
    assert _pil_rgb(avif.getvalue()).shape == (6, 8, 3)  # PIL reads it, and so does the port
    np.testing.assert_array_equal(timg.rgb8_from_bytes(avif.getvalue()), _pil_rgb(avif.getvalue()))
    avif = io.BytesIO()
    Image.fromarray(np.dstack([px, px[..., :1]]), "RGBA").save(avif, format="AVIF")
    assert _pil_rgb(avif.getvalue()).shape == (6, 8, 3)  # PIL reads it, and so does the port (once A.1)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(avif.getvalue()), _pil_rgb(avif.getvalue()))
    avif = io.BytesIO()
    Image.fromarray(px).save(avif, format="AVIF", advanced={"enable-qm": "1"})
    assert _pil_rgb(avif.getvalue()).shape == (6, 8, 3)  # PIL reads it, and so does the port (once A.1)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(avif.getvalue()), _pil_rgb(avif.getvalue()))
    avif = io.BytesIO()  # libavif converts matrix 0 (identity) only from 4:4:4
    Image.fromarray(px).save(avif, format="AVIF", subsampling="4:4:4")
    identity = avif.getvalue().replace(b"colrnclx\x00\x01\x00\x0d\x00\x06", b"colrnclx\x00\x01\x00\x0d\x00\x00")
    assert identity != avif.getvalue() and _pil_rgb(identity).shape == (6, 8, 3)  # PIL reads it, and so does the port
    np.testing.assert_array_equal(timg.rgb8_from_bytes(identity), _pil_rgb(identity))
    from torch_fixtures.make_textures import AVIF_RAISES, OUT

    with open(os.path.join(OUT, "avif_prem_alpha_other_size.avif"), "rb") as f:
        prem = f.read()
    np.testing.assert_array_equal(timg.rgb8_from_bytes(prem), _pil_rgb(prem))
    with open(os.path.join(AVIF_RAISES, "avif_inter_shown_first.avif"), "rb") as f:
        step7 = f.read()
    assert _pil_rgb(step7).shape == (32, 48, 3)  # PIL reads it; the port raises A.1 naming it
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*ROADMAP A.1"):
        timg.rgb8_from_bytes(step7)
    with pytest.raises(ValueError, match="not a PNG"):
        timg.rgb8_from_png(b"GIF89a" + bytes(40))
