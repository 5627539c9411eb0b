"""Port parity, the small raster formats (codecs/blp.py, ftex.py, pcx.py's
DCX, icns.py, sun.py, xbm.py, xpm.py, msp.py, im.py, spider.py, fits.py,
iptc.py, pixar.py, mcidas.py, gbr.py, fli.py, xvthumb.py, imt.py, pcd.py
and pnm.py's test modes) against PIL's `convert("RGB")` and, for one file of each format,
the JAX package's `load_image`, bit for bit.

PIL writes BLP (palette), DCX's PCX frames, ICNS's PNG entries, XBM, MSP
v1, IM, SPIDER and JPEG; tests/torch_codec_encoders.py writes the rest
(BLP1 JPEG and BLP2 DXT, FTEX, DCX, ICNS RLE, SUN, XPM, MSP v2, FITS and
its gzip tiles, IPTC, PIXAR, McIdas, GBR, FLI / FLC chunks, XV thumbnails,
IMT, PhotoCD base images). PIL's
quirks are the contract: BLP's BGR JPEG and its rows read at the
header's width whatever the decoder gave, FITS' little-endian samples,
SUN RLE rows without their padding, XBM's lone hex digits.
"""
import numpy as np
import pytest

import torch_codec_encoders as enc
from torch_codec_encoders import assert_as_pil, assert_fails_like_pil, assert_like_pil, photo, pil_bytes, pil_rgb


def _blp_cases():
    from PIL import Image

    rng = np.random.default_rng(1)
    ph, ph4 = photo(13, 11, 1), photo(13, 11, 2, 4)
    jp = pil_bytes(ph, "JPEG", quality=80)
    cases = {"p1": pil_bytes(Image.fromarray(ph).convert("P"), "BLP", blp_version="BLP1"),
             "p2": pil_bytes(Image.fromarray(ph).convert("P"), "BLP"),
             "pa2": pil_bytes(Image.fromarray(ph4, "RGBA").convert("P"), "BLP"),
             "jpeg": enc.blp1_jpeg(jp, 11, 13), "jpeg_split": enc.blp1_jpeg(jp, 11, 13, split=200),
             "jpeg_alpha": enc.blp1_jpeg(jp, 11, 13, alpha=8),
             "jpeg_grey": enc.blp1_jpeg(pil_bytes(ph, "JPEG", "L", quality=80), 11, 13),
             "jpeg_cmyk": enc.blp1_jpeg(pil_bytes(ph, "JPEG", "CMYK", quality=80), 11, 13),
             "jpeg_narrow": enc.blp1_jpeg(jp, 9, 13)}
    for ae, size in ((0, 8), (1, 16), (7, 16)):
        for a in (0, 1):
            body = rng.integers(0, 256, 3 * 4 * size, dtype=np.uint8).tobytes()
            cases[f"dxt{ae}_alpha{a}"] = enc.blp2_file(11, 13, body, 2, ae, a)
    pal = rng.integers(0, 256, (256, 4))
    cases["raw_palette"] = enc.blp2_file(11, 13, rng.integers(0, 256, 143, dtype=np.uint8).tobytes(), 1, 0, 1, pal)
    cases["short"] = enc.blp2_file(11, 13, bytes(100), 1, 0, 0, pal)
    cases["bad_alpha_encoding"] = enc.blp2_file(11, 13, bytes(300), 2, 3, 0)
    return cases


BLP = _blp_cases()


@pytest.mark.parametrize("name", list(BLP))
def test_blp(tmp_path, name):
    assert_as_pil(BLP[name], tmp_path if name == "jpeg" else None, "t.blp")


@pytest.mark.parametrize("fmt", [0, 1])
def test_ftex(tmp_path, fmt):
    rng = np.random.default_rng(fmt)
    body = photo(13, 11, 1).tobytes() if fmt else rng.integers(0, 256, 12 * 8, dtype=np.uint8).tobytes()
    assert_like_pil(enc.ftex_file(11, 13, fmt, body), tmp_path, "t.ftc")
    assert_fails_like_pil(enc.ftex_file(11, 13, fmt, body[:40]))


def test_dcx(tmp_path):
    frames = [pil_bytes(photo(13, 11, 1), "PCX", "P"), pil_bytes(photo(5, 5, 3), "PCX")]
    assert_like_pil(enc.dcx_file(frames), tmp_path, "t.dcx")
    assert_like_pil(enc.dcx_file(frames[::-1]))
    assert_like_pil(enc.dcx_file([pil_bytes(photo(9, 7, 4), "PCX", "1")]))


def test_icns(tmp_path):
    from PIL import Image

    sq = photo(16, 16, 3)
    pngs = [pil_bytes(Image.fromarray(photo(n, n, 5, 4), "RGBA"), "PNG") for n in (16, 32)]
    assert_like_pil(enc.icns_file([(b"icp4", pngs[0]), (b"icp5", pngs[1]), (b"is32", sq.tobytes())]),
                    tmp_path, "t.icns")
    assert_like_pil(enc.icns_file([(b"is32", enc.icns_rle24(sq)), (b"s8mk", bytes(256))]))
    assert_like_pil(enc.icns_file([(b"is32", sq.tobytes())]))
    assert_like_pil(enc.icns_file([(b"il32", enc.icns_rle24(photo(32, 32, 6))), (b"is32", sq.tobytes())]))
    blocks = np.repeat(np.repeat(photo(16, 16, 4), 8, 0), 8, 1)  # runs and literals, a fast 128x128
    blocks[::7] = photo(19, 128, 5)[:19]
    assert_like_pil(enc.icns_file([(b"it32", bytes(4) + enc.icns_rle24(blocks))]))
    assert_fails_like_pil(enc.icns_file([(b"is32", enc.icns_rle24(sq)[:-40])]))
    j2k = pil_bytes(photo(16, 16, 2), "JPEG2000")  # once A.1, now decoded as PIL decodes it
    assert_like_pil(enc.icns_file([(b"icp4", j2k)]))


@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("kind", [1, 2, 3])
def test_sun(tmp_path, depth, kind):
    rng = np.random.default_rng(depth + kind)
    if depth >= 24:
        v = photo(13, 11, 1, depth // 8)
        v[3:6] = v[3]
    else:
        v = rng.integers(0, 1 << depth, (13, 11)).astype(np.uint8)
        v[4:7] = v[4]
        v[1, 2:5] = (1 << depth) - 1 if depth == 8 else v[1, 2]
    assert_like_pil(enc.sun_file(v, depth, kind), tmp_path if depth == 24 else None, "t.ras")
    if depth in (4, 8):
        assert_like_pil(enc.sun_file(v, depth, kind, cmap=rng.integers(0, 256, (5, 3))))


def test_sun_rle_escape_and_truncation():
    v = np.full((5, 7), 0x80, np.uint8)
    v[2] = [0x80, 1, 0x80, 2, 2, 2, 2]
    data = enc.sun_file(v, 8, 2)
    assert_like_pil(data)
    assert_fails_like_pil(data[:-3])


def test_xbm_xpm_msp(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    ink = Image.fromarray(photo(13, 19, 1)).convert("1")
    assert_like_pil(pil_bytes(ink, "XBM"), tmp_path, "t.xbm")
    assert_like_pil(b"#define x_width 4\n#define x_height 2\nstatic char x_bits[] = {\n0x1, 0xF, };\n")
    assert_like_pil(b"#define a_width 9\n#define a_height 2\n#define a_x_hot 1\n#define a_y_hot 1\n"
                    b"static unsigned char a_bits[] = { 0xff, 0x01, 0x0a, 0x00 };")
    assert_fails_like_pil(b"#define x_width 8\n#define x_height 4\nstatic char x_bits[] = { 0x11, 0x22 };\n")
    for chars, n in ((1, 16), (2, 70), (3, 300)):
        idx = rng.integers(0, n, (7, 9))
        colours = [b"#%06X" % rng.integers(0, 1 << 24) for _ in range(n)]
        assert_like_pil(enc.xpm_file(idx, colours, chars), tmp_path if chars == 2 else None, "t.xpm")
    idx = rng.integers(0, 15, (5, 6))
    assert_like_pil(enc.xpm_file(idx, [b"#102030"] * 16, 1, none=15))  # an unused transparent colour
    idx[2, 3] = 15
    assert_fails_like_pil(enc.xpm_file(idx, [b"#102030"] * 16, 1, none=15))  # a pixel of it: PIL fails
    assert_like_pil(pil_bytes(ink, "MSP"), tmp_path, "t.msp")
    bits = rng.integers(0, 2, (13, 27))
    bits[:, 20:] = 1
    bits[5] = 1  # an all-white row: no bytes in the row map
    assert_like_pil(enc.msp_rle(bits))
    bad = bytearray(pil_bytes(ink, "MSP"))
    bad[30] ^= 1  # the checksum no longer holds: no MSP, and no other format takes it
    assert_fails_like_pil(bytes(bad))


def _im_cases():
    from PIL import Image

    ph = photo(13, 11, 1)
    g = ph[..., 0]
    ims = {"1": Image.fromarray(ph).convert("1"), "L": Image.fromarray(g), "P": Image.fromarray(ph).convert("P"),
           "P_grey": Image.fromarray(g).convert("P"), "LA": Image.fromarray(ph).convert("LA"),
           "PA": Image.fromarray(ph).convert("P").convert("PA"),
           "I": Image.fromarray(g.astype(np.int32) * 3 - 100),
           "I;16": Image.frombytes("I;16", (11, 13), (g.astype("<u2") * 3).tobytes()),
           "I;16B": Image.frombytes("I;16B", (11, 13), (g.astype(">u2") * 3).tobytes()),
           "F": Image.fromarray(g.astype(np.float32) * 1.7 - 40), "RGB": Image.fromarray(ph),
           "RGBA": Image.fromarray(photo(13, 11, 2, 4), "RGBA"), "RGBX": Image.fromarray(ph).convert("RGBX"),
           "CMYK": Image.fromarray(photo(13, 11, 2, 4), "CMYK"), "YCbCr": Image.fromarray(ph).convert("YCbCr")}
    cases = {k: pil_bytes(v, "IM") for k, v in ims.items()}
    head = b"Image type: %s image\r\nImage size (x*y): 11*13\r\n" + bytes(1) * 60 + b"\x1a"
    raw = photo(13, 11, 3).tobytes()
    cases["X 24"] = head % b"X 24" + raw
    cases["RGB3"] = head % b"RGB3" + raw
    cases["L 16S"] = head % b"L 16S" + raw
    cases["L 8S"] = head % b"L 8S" + raw
    cases["L 32F"] = head % b"L 32F" + (photo(13, 11, 4)[..., 0].astype("<f4") * 1.3 - 20).tobytes()
    cases["truncated"] = cases["RGB"][:-30]
    rng = np.random.default_rng(11)
    for kind in (b"B2", b"B4", b"RLB", b"L*2", b"L*7", b"L*12", b"L*31"):  # no Lut; no unpacker; PIL's bit decoder
        cases[kind.decode()] = head % kind + rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    cases["L*7 truncated"] = head % b"L*7" + raw[:40]
    return cases


IM = _im_cases()


@pytest.mark.parametrize("name", list(IM))
def test_im(tmp_path, name):
    assert_as_pil(IM[name], tmp_path if name == "RGB" else None, "t.im")


def test_ycbcr_to_rgb_full_sweep():
    """PIL's YCbCr -> RGB, which IM's YCC images take, on every (Y, Cb, Cr)."""
    from PIL import Image

    from optixpathtracer_tpu_torch.io.codecs import im

    g = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"), -1).astype(np.uint8)
    g = g.reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), g.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(im.ycbcr_rgb(g), want)


def test_spider(tmp_path):
    from PIL import Image

    f = photo(13, 11, 1)[..., 0].astype(np.float32) * 1.5 - 30
    f[0, :3] = [np.nan, np.inf, -np.inf]
    assert_like_pil(pil_bytes(Image.fromarray(f), "SPIDER"), tmp_path, "t.spi")
    little = bytearray(pil_bytes(Image.fromarray(f), "SPIDER"))
    n = len(little) // 4
    swapped = np.frombuffer(bytes(little), ">f4").astype("<f4").tobytes()  # the other byte order
    assert len(swapped) == 4 * n
    assert_like_pil(swapped)


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_fits(tmp_path, bitpix):
    v = photo(13, 11, 1)[..., 0].astype(np.int64) * (1 if bitpix == 8 else 3) - (0 if bitpix == 8 else 50)
    assert_like_pil(enc.fits_file(v, bitpix, [b"COMMENT a card PIL skips"]), tmp_path if bitpix == 16 else None,
                    "t.fits")
    if bitpix != -64:
        assert_as_pil(enc.fits_gzip(v - v.min(), bitpix))  # PIL fails the float tiles


def test_fits_header_cases():
    v = photo(5, 7, 2)[..., 0]
    assert_fails_like_pil(enc.fits_file(v, 8)[:2880])  # no data after the header
    one_axis = enc.fits_file(v[:1], 8).replace(b"NAXIS   =                    2", b"NAXIS   =                    1")
    assert_as_pil(one_axis)


def test_iptc(tmp_path):
    ph = photo(13, 11, 1)
    g = ph[..., 0]
    assert_like_pil(enc.iptc_file(g), tmp_path, "t.iim")
    assert_like_pil(enc.iptc_file(g, 3, 1, band=1, split=3))
    assert_like_pil(enc.iptc_file(g, 4, 1, band=2))
    assert_like_pil(enc.iptc_file(g, 3, 1))
    assert_like_pil(enc.iptc_file(ph, 3, 1, band=0, jpeg=pil_bytes(ph, "JPEG", "L", quality=80)))
    assert_as_pil(enc.iptc_file(ph, jpeg=pil_bytes(ph, "JPEG", quality=80)))
    assert_fails_like_pil(enc.iptc_file(g)[:60])


def test_pixar_mcidas_gbr_xvthumb_imt(tmp_path):
    rng = np.random.default_rng(4)
    ph = photo(7, 9, 1)
    g = ph[..., 0].astype(np.int64)
    cases = {"t.pxr": enc.pixar_file(ph), "t.area": enc.mcidas_file(g * 3, 2), "t.gbr": enc.gbr_file(g, 1),
             "t.xv": enc.xvthumb_file(rng.integers(0, 256, (7, 9))), "t.imt": enc.imt_file(g)}
    for name, data in cases.items():
        assert_like_pil(data, tmp_path, name)
    assert_like_pil(enc.mcidas_file(g, 1, 3))
    assert_like_pil(enc.mcidas_file(g * 5 - 300, 4, 2))
    assert_like_pil(enc.gbr_file(photo(7, 9, 2, 4)))
    assert_fails_like_pil(enc.gbr_file(photo(7, 9, 2, 4))[:-9])
    assert_fails_like_pil(enc.pixar_file(ph)[:-5])


@pytest.mark.parametrize("head", [b"PyP 3 2 255\n", b"PyCMYK 3 2 200\n", b"P0CMYK 3 2 255\n", b"PyRGBA 3 2 1000\n",
                                  b"PyRGBA 3 2 255\n", b"PyCMYK 3 2 65535\n"])
def test_pnm_test_modes(tmp_path, head):
    rng = np.random.default_rng(len(head))
    maxval = int(head.split()[-1])
    bands = 1 if head.startswith(b"PyP") else 4
    v = rng.integers(0, maxval + 1, 6 * bands)
    body = v.astype(">u2" if maxval > 255 else "u1").tobytes()
    assert_like_pil(head + body, tmp_path, "t.pnm")
    assert_fails_like_pil(head + body[:-3])


def _fli_cases():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 8, (13, 17)).astype(np.uint8) * 30
    img[3:6] = 77
    img[8] = 0
    pal, pal64 = rng.integers(0, 256, (256, 3)), rng.integers(0, 64, (200, 3))
    sparse = img.copy()
    sparse[::2, 3:9] = 0
    sparse[10:] = 0
    return {"brun": enc.fli_file(17, 13, [enc.fli_color(pal), enc.fli_brun(img)]),
            "brun_fli_color64": enc.fli_file(17, 13, [enc.fli_color(pal64, True, 5), enc.fli_brun(img)],
                                             magic=0xAF11),
            "copy": enc.fli_file(17, 13, [enc.fli_copy(img)]),
            "copy_black": enc.fli_file(17, 13, [enc.fli_copy(img), (13, bytes(4))]),
            "lc": enc.fli_file(17, 13, [enc.fli_color(pal), enc.fli_lc(sparse, 2)]),
            "ss2": enc.fli_file(16, 13, [enc.fli_color(pal), enc.fli_ss2(sparse[:, :16])]),
            "ss2_odd_width": enc.fli_file(17, 13, [enc.fli_color(pal), enc.fli_ss2(sparse)]),
            "pstamp": enc.fli_file(17, 13, [(18, bytes(20)), enc.fli_brun(img)]),
            "prefix_chunk": enc.fli_file(17, 13, [enc.fli_brun(img)], prefix=bytes(10)),  # PIL fails it
            "unknown_chunk": enc.fli_file(17, 13, [(99, bytes(4))]),
            "truncated": enc.fli_file(17, 13, [enc.fli_copy(img)])[:-30]}


FLI = _fli_cases()


@pytest.mark.parametrize("name", list(FLI))
def test_fli(tmp_path, name):
    assert_as_pil(FLI[name], tmp_path if name == "brun" else None, "t.flc")


@pytest.mark.parametrize("orientation", [0, 1, 3])
def test_pcd(tmp_path, orientation):
    """The 768x512 base image (generated here, 0.8 MB): random PhotoYCC,
    and a sweep of every luma against every C2 and C1."""
    rng = np.random.default_rng(orientation)
    y = rng.integers(0, 256, (512, 768), dtype=np.uint8)
    c1 = rng.integers(0, 256, (256, 384), dtype=np.uint8)
    c2 = rng.integers(0, 256, (256, 384), dtype=np.uint8)
    if orientation == 0:  # every (Y, C) pair: Y along the row pairs, C along the half columns
        y[:] = (np.arange(512) // 2)[:, None]
        c1[:] = np.arange(384)[None, :] % 256
        c2[:] = (np.arange(384)[None, :] + 128) % 256
    assert_like_pil(enc.pcd_file(y, c1, c2, orientation), tmp_path if orientation == 1 else None, "t.pcd")
    if orientation == 3:
        assert_fails_like_pil(enc.pcd_file(y, c1, c2)[:-100])


def test_unported_formats_left():
    """AVIF at PIL's defaults, a 4:4:4 AVIF, an AVIF with quantizer
    matrices, JPEG 2000, an AVIF grid and a premultiplied AVIF alpha of
    another size than its colour (each once A.1) decode as PIL decodes
    them; an AVIF whose item shows an inter frame first, which PIL reads,
    still raises A.1 (AVIF step 7)."""
    import os

    from optixpathtracer_tpu_torch.io import image as timg
    from torch_fixtures.make_textures import AVIF_RAISES, OUT

    assert_like_pil(pil_bytes(photo(8, 8, 1), "AVIF"))
    assert_like_pil(pil_bytes(photo(8, 8, 1), "AVIF", subsampling="4:4:4"))
    assert_like_pil(pil_bytes(photo(8, 8, 1), "AVIF", advanced={"enable-qm": "1"}))
    with open(os.path.join(OUT, "avif_grid.avif"), "rb") as f:
        assert assert_like_pil(f.read()).shape == (128, 128, 3)
    with open(os.path.join(OUT, "avif_prem_alpha_other_size.avif"), "rb") as f:
        assert assert_like_pil(f.read()).shape == (40, 48, 3)
    with open(os.path.join(AVIF_RAISES, "avif_inter_shown_first.avif"), "rb") as f:
        step7 = f.read()
    assert pil_rgb(step7).shape == (32, 48, 3)
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*A.1"):
        timg.rgb8_from_bytes(step7)
    assert_like_pil(pil_bytes(photo(8, 8, 1), "JPEG2000"))
