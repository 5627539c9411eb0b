"""Write the texture fixtures of the port's codecs (tests/torch_fixtures/
textures/) and their manifest: PIL's decode of each, as shape, per-channel
sums and the SHA-256 of the uint8 RGB bytes.

The loft's three textures (scenes/loft_tex*.png) in three lossless formats
(TGA RLE, TIFF LZW, WebP lossless), in three more (DCX, an orientation-
tagged LZMA TIFF, ICNS) and in a lossy set (WebP lossy, DDS BC1,
arithmetic-coded JPEG) and a JPEG 2000 set (a 5/3 JP2, a tiled RPCL
codestream with precincts and three layers, an ICNS of a JPEG 2000 entry)
and in AVIF at PIL's defaults (a fifth set, lossy) and with PIL's own
AVIF options (a sixth: 4:4:4 with CDEF, a premultiplied RGBA with loop
restoration, 4:2:2);
then one small image for each other variant the port decodes. PIL writes what it can write; the 10- and
12-bit AVIF stills PIL's aom does not write come from OpenCV's libavif
(tests/torch_avif_oracle.py `encode_hbd`, so this script needs cv2 too);
AVIF step 4's grain comes from aom's test vectors and its grain tables
(`film-grain-table`), one still's clip_to_restricted_range from a header
edit; AVIF step 5's segmented stills, grids and matrices from OpenCV's
libavif and libavif's own encoder, a grid muxed from cells and one
cropped by an ImageGrid edit;
tests/torch_codec_encoders.py
writes the rest (arithmetic, lossless and YCCK JPEG, RLE BMP, colour-mapped
TGA, GIF with an offset frame, PSD, RLE SGI, JPEG-in-TIFF, CUR, a WebP
animation, BC6H, a VP8 frame with the simple filter and four partitions) and
tests/torch_j2k_encoders.py the JPEG 2000 files PIL does not write (through
OpenJPEG's own encoder, spliced JP2 boxes, PPT / PPM). AVIF step 7's inter
frames come from image sequences of OpenCV's libavif (`encode_seq`) behind a
hidden key frame. The AVIF files the port refuses (the inter tools of steps
8 and 9, and those PIL refuses) go to avif_raises/ with expected.json.
chip_smoke.py's `codecs_scene` decodes every fixture on a machine without
PIL and holds it to the manifest; the CPU tests decode the committed files
with PIL and hold the manifest to them.

Run from the repository root: python tests/torch_fixtures/make_textures.py
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "textures")
MANIFEST = os.path.join(OUT, "manifest.json")
LOSSLESS = {"loft_tex0.png": "loft_tex0.tga", "loft_tex1.png": "loft_tex1.tif", "loft_tex2.png": "loft_tex2.webp"}
LOSSY = {"loft_tex0.png": "loft_tex0_lossy.webp", "loft_tex1.png": "loft_tex1_bc1.dds",
         "loft_tex2.png": "loft_tex2_arith.jpg"}
# three more lossless forms: a DCX (PCX RLE), an LZMA TIFF storing the
# texture transposed under orientation 5, an ICNS with a 256x256 PNG entry
LOSSLESS2 = {"loft_tex0.png": "loft_tex0.dcx", "loft_tex1.png": "loft_tex1_orient5_lzma.tif",
             "loft_tex2.png": "loft_tex2.icns"}
# and in JPEG 2000: a 5/3 JP2, a tiled RPCL codestream with precincts and
# three layers (the last lossless), an ICNS whose 256x256 entry is JPEG 2000
LOSSLESS3 = {"loft_tex0.png": "loft_tex0_53.jp2", "loft_tex1.png": "loft_tex1_rpcl_tiles.j2k",
             "loft_tex2.png": "loft_tex2_j2k.icns"}
# and in AVIF at PIL's defaults (aom, quality 75, speed 6), where the screen-
# content tools appear: palette in all three, IntraBC in loft_tex1
LOSSY2 = {"loft_tex0.png": "loft_tex0.avif", "loft_tex1.png": "loft_tex1.avif", "loft_tex2.png": "loft_tex2.avif"}
# and in AVIF with PIL's save options: 4:4:4 with CDEF at speed 4, an RGBA
# (an alpha ramp) premultiplied at speed 2 with loop restoration, 4:2:2
LOSSY3 = {"loft_tex0.png": "loft_tex0_444_cdef.avif", "loft_tex1.png": "loft_tex1_rgba_prem_lr.avif",
          "loft_tex2.png": "loft_tex2_422.avif"}
# AVIF files the port must refuse as PIL does or raise A.1 for (AVIF step
# 6), beside the textures: name -> (exception class name, message pattern)
AVIF_RAISES = os.path.join(HERE, "avif_raises")
AVIF_RAISES_EXPECTED = os.path.join(AVIF_RAISES, "expected.json")


def digest(rgb: np.ndarray) -> dict:
    """What the manifest keeps of one decode."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    return {"shape": list(rgb.shape), "sums": rgb.reshape(-1, 3).sum(0, dtype=np.int64).tolist(),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def _fixtures() -> dict[str, bytes]:
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, REPO)
    from PIL import Image

    import torch_codec_encoders as enc

    def pil(img, fmt, mode=None, **kw):
        return enc.pil_bytes(img, fmt, mode, **kw)

    out = {}
    for png, name in LOSSLESS.items():
        img = Image.open(os.path.join(REPO, "scenes", png)).convert("RGB")
        kw = {"tga": dict(compression="tga_rle"), "tif": dict(compression="tiff_lzw"),
              "webp": dict(lossless=True)}[name.rsplit(".", 1)[1]]
        out[name] = pil(img, {"tga": "TGA", "tif": "TIFF", "webp": "WEBP"}[name.rsplit(".", 1)[1]], **kw)
    for png, name in LOSSY.items():
        img = Image.open(os.path.join(REPO, "scenes", png)).convert("RGB")
        if name.endswith(".webp"):
            out[name] = pil(img, "WEBP", quality=80)
        elif name.endswith(".dds"):
            out[name] = pil(img, "DDS", pixel_format="DXT1")
        else:
            out[name] = enc.arith_jpeg(pil(img, "JPEG", quality=90))
    for png, name in LOSSLESS2.items():
        img = np.asarray(Image.open(os.path.join(REPO, "scenes", png)).convert("RGB"))
        if name.endswith(".dcx"):
            out[name] = enc.dcx_file([pil(img, "PCX")])
        elif name.endswith(".tif"):
            out[name] = enc.tiff_file(img.transpose(1, 0, 2), 8, 2, "<", 34925, predictor=2, rows_per_strip=64,
                                      extra_tags={274: (3, [5])})
        else:
            with open(os.path.join(REPO, "scenes", png), "rb") as f:
                out[name] = enc.icns_file([(b"ic08", f.read())])
    rng = np.random.default_rng(17)
    ph = enc.photo(37, 45, 1)
    ph4 = enc.photo(37, 45, 2, 4)
    idx = rng.integers(0, 16, (23, 31))
    idx[5:9] = idx[5]
    pal = rng.integers(0, 256, (16, 3))
    out["bmp_rle4.bmp"] = enc.bmp_file(enc.bmp_rle(idx, True), 31, 23, 4, compression=2, palette=pal)
    out["bmp_rle8.bmp"] = enc.bmp_file(enc.bmp_rle(idx * 9, False), 31, 23, 8, compression=1,
                                       palette=rng.integers(0, 256, (256, 3)))
    px565 = rng.integers(0, 256, 23 * 64, dtype=np.uint8).tobytes()
    out["bmp_565_topdown.bmp"] = enc.bmp_file(px565, 31, 23, 16, 124, 3, masks=(0xF800, 0x7E0, 0x1F, 0),
                                              top_down=True)
    out["bmp_os2_8.bmp"] = enc.bmp_file(rng.integers(0, 256, 32 * 5, dtype=np.uint8).tobytes(), 29, 5, 8, 12,
                                        palette=rng.integers(0, 256, (256, 3)))
    out["tga_cmap16_rle.tga"] = enc.tga_file((idx * 3).astype(np.uint8), 9, 8,
                                             rng.integers(0, 256, (60, 2), dtype=np.uint8), 16, cmap_start=2,
                                             origin=0x20, image_id=b"fixture", rng=rng)
    out["tga_grey_mirrored.tga"] = enc.tga_file(ph[..., 0], 3, 8, origin=0x10)
    out["gif_offset_interlaced.gif"] = enc.gif_file(idx, pal, (40, 30), at=(5, 3), local=True, interlace=True,
                                                    transparency=2, clear_every=200)
    out["gif_pil.gif"] = pil(ph, "GIF")
    out["pnm_p6_maxval100.ppm"] = b"P6\n# a comment\n45 37\n100\n" + (ph.astype(np.int64) * 100 // 255).astype(
        np.uint8).tobytes()
    out["pnm_p2_16bit.pgm"] = b"P2 5 3 1000\n" + b" ".join(b"%d" % v for v in rng.integers(0, 1001, 15)) + b"\n"
    out["pnm_p4.pbm"] = pil(ph, "PPM", "1")
    out["dds_bc3.dds"] = pil(Image.fromarray(ph4, "RGBA"), "DDS", pixel_format="DXT5")
    bc7 = rng.integers(0, 256, (12 * 10, 16), dtype=np.uint8)
    for i in range(len(bc7)):
        m = i % 8
        bc7[i, 0] = (int(bc7[i, 0]) & (0xFF ^ ((1 << (m + 1)) - 1))) | (1 << m)
    out["dds_bc7_modes.dds"] = enc.dds_file(45, 37, bc7.tobytes(), dxgi=98)
    out["dds_bc5s.dds"] = enc.dds_file(16, 8, rng.integers(0, 256, 8 * 16, dtype=np.uint8).tobytes(), b"BC5S")
    out["dds_rgb565.dds"] = enc.dds_file(9, 7, rng.integers(0, 256, 126, dtype=np.uint8).tobytes(), pf_flags=0x40,
                                         bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0))
    out["tiff_deflate_tiles_planar.tif"] = enc.tiff_file(ph, 8, 2, "<", 8, predictor=2, planar=2, tile=(16, 16))
    out["tiff_packbits_palette_mm.tif"] = enc.tiff_file(idx[..., None], 4, 3, ">", 32773, rows_per_strip=5,
                                                        colormap=rng.integers(0, 65536, (16, 3)))
    out["tiff_lzw_rgba16_assoc.tif"] = enc.tiff_file(
        np.minimum(ph4.astype(np.uint64) * 257, (ph4[..., 3:4].astype(np.uint64) * 257)), 16, 2, "<", 5,
        predictor=2, rows_per_strip=8, extra=(1,))
    out["tiff_cmyk.tif"] = pil(ph, "TIFF", "CMYK", compression="tiff_lzw")
    out["tiff_float_bigtiff.tif"] = enc.tiff_file((ph[..., :1].astype(np.float32) * 1.3 - 20), 32, 1, "<", 8,
                                                  sample_format=3, big=True)
    strips = [pil(ph[y:y + 16], "JPEG", quality=85, subsampling=2) for y in range(0, 37, 16)]
    out["tiff_jpeg_ycbcr.tif"] = enc.tiff_file(np.zeros((37, 45, 3), np.uint8), 8, 6, "<", 7, rows_per_strip=16,
                                               jpeg_chunks=strips, extra_tags={530: (3, [2, 2])})
    frames = [pil(enc.photo(10, 14, s), "WEBP", quality=70) for s in range(2)]
    out["webp_anim_offset.webp"] = enc.webp_animation((30, 21), [(frames[0], 6, 4, 14, 10), (frames[1], 0, 0, 14, 10)])
    out["webp_lossy_alpha.webp"] = pil(Image.fromarray(ph4, "RGBA"), "WEBP", quality=60)
    out["webp_lossless_palette.webp"] = pil(Image.fromarray(pal.astype(np.uint8)[idx]), "WEBP", lossless=True)
    base = pil(ph, "JPEG", quality=75, subsampling=1)
    out["jpeg_arith_progressive_restart.jpg"] = enc.arith_jpeg(base, progressive=True, restart_mcus=2,
                                                               dac=(1, 4, 3))
    cmyk = pil(ph, "JPEG", "CMYK", quality=80)
    out["jpeg_cmyk.jpg"] = cmyk
    i = cmyk.index(b"Adobe")
    out["jpeg_ycck.jpg"] = cmyk[:i + 11] + b"\x02" + cmyk[i + 12:]
    out["jpeg_lossless.jpg"] = enc.lossless_jpeg(ph, 6, restart_rows=8)
    out["psd_rgb_rle.psd"] = enc.psd_file([ph[..., c] for c in range(3)], 3, 8, 1)
    out["psd_cmyk.psd"] = enc.psd_file([ph4[..., c] for c in range(4)], 4, 8, 0)
    out["qoi_rgba.qoi"] = pil(Image.fromarray(ph4, "RGBA"), "QOI")
    out["sgi_rle16.sgi"] = enc.sgi_rle(ph.astype(np.uint16) * 257 + 1, 2)
    out["sgi_raw.sgi"] = pil(ph, "SGI")
    out["pcx_rgb.pcx"] = pil(ph, "PCX")
    out["pcx_palette.pcx"] = pil(ph, "PCX", "P")
    out["ico_png_bmp.ico"] = pil(Image.fromarray(enc.photo(32, 32, 5, 4), "RGBA"), "ICO",
                                 sizes=[(16, 16), (32, 32)], bitmap_format="bmp")
    out["cur_two.cur"] = enc.cur_file([(8, 8, 24), (16, 16, 8)], rng)
    rng2 = np.random.default_rng(18)
    bc6 = rng2.integers(0, 256, (12 * 10, 16), dtype=np.uint8)
    lows = [0, 1] + [2 + 4 * k for k in range(8)] + [3 + 4 * k for k in range(4)]
    bc6[:, 0] = [(int(b) & (0xE0 if lows[i % 14] > 1 else 0xFC)) | lows[i % 14] for i, b in enumerate(bc6[:, 0])]
    out["dds_bc6h_sf16.dds"] = enc.dds_file(45, 37, bc6.tobytes(), dxgi=96)
    out["webp_vp8_simple_partitions.webp"] = enc.webp_vp8(enc.vp8_frame(
        45, 37, rng2, simple=1, level=25, sharpness=3, log2_parts=2,
        segments=(1, 0, [0, 12, -9, 30], [0, 6, -4, 15], [90, 160, 220]), lf_delta=([4, 0, 0, 0], [-3, 0, 0, 0]),
        quant=(30, 2, -3, 4, -5, 6), big=0.03, big_max=40))
    out.update(_fixtures_raster(enc, pil, Image))
    out.update(_fixtures_j2k(enc, pil, Image))
    out.update(_fixtures_avif(enc, pil, Image))
    return out


def _fixtures_j2k(enc, pil, Image) -> dict[str, bytes]:
    """The loft in JPEG 2000, and one small file for each JPEG 2000 variant:
    PIL's writer for what it writes, OpenJPEG's encoder through ctypes and
    spliced JP2 boxes / relocated packet headers (tests/torch_j2k_encoders.py)
    for the rest."""
    import torch_j2k_encoders as je

    out = {}
    for png, name in LOSSLESS3.items():
        img = Image.open(os.path.join(REPO, "scenes", png)).convert("RGB")
        if name.endswith(".jp2"):
            out[name] = pil(img, "JPEG2000")
        elif name.endswith(".j2k"):
            out[name] = pil(img, "JPEG2000", no_jp2=True, tile_size=(96, 96), progression="RPCL",
                            precinct_size=(32, 32), quality_mode="rates", quality_layers=[40, 10, 0],
                            num_resolutions=4)
        else:
            out[name] = enc.icns_file([(b"ic08", pil(img, "JPEG2000", no_jp2=True))])
    ph = Image.fromarray(enc.photo(29, 37, 21))
    odd = Image.fromarray(enc.photo(13, 31, 22))
    out["j2k_97_mct0_lrcp.j2k"] = pil(ph, "JPEG2000", no_jp2=True, irreversible=True, mct=0,
                                      quality_mode="rates", quality_layers=[30, 8])
    out["j2k_53_rlcp_tiles_offsets.j2k"] = pil(ph, "JPEG2000", no_jp2=True, progression="RLCP", tile_size=(16, 12),
                                               tile_offset=(3, 2), offset=(5, 4), precinct_size=(16, 16),
                                               num_resolutions=3)
    out["j2k_97_rpcl_precincts_layers.j2k"] = pil(ph, "JPEG2000", no_jp2=True, irreversible=True,
                                                  progression="RPCL", precinct_size=(16, 16),
                                                  codeblock_size=(8, 8), quality_mode="dB",
                                                  quality_layers=[28, 36, 44], num_resolutions=4)
    out["j2k_53_pcrl_cblk16x8.jp2"] = pil(ph, "JPEG2000", progression="PCRL", codeblock_size=(16, 8),
                                          precinct_size=(32, 32), num_resolutions=4)
    out["j2k_97_cprl_odd.j2k"] = pil(odd, "JPEG2000", no_jp2=True, irreversible=True, progression="CPRL",
                                     num_resolutions=3)
    out["j2k_signed_plt.j2k"] = pil(ph, "JPEG2000", no_jp2=True, signed=True, plt=True, num_resolutions=3)
    out["j2k_la.jp2"] = pil(Image.fromarray(enc.photo(23, 19, 23, 2), "LA"), "JPEG2000", num_resolutions=3)
    out["j2k_rgba_97.jp2"] = pil(Image.fromarray(enc.photo(23, 19, 24, 4), "RGBA"), "JPEG2000", irreversible=True,
                                 num_resolutions=3)
    grey16 = (enc.photo(23, 19, 25, 1)[..., 0].astype(np.uint16) * 3 + 100)
    out["j2k_i16.jp2"] = pil(Image.fromarray(grey16).convert("I;16"), "JPEG2000", num_resolutions=3)
    p3 = je.planes(27, 33, 3, 26)
    out["j2k_poc.j2k"] = je.opj_encode(p3, numresolution=4, rates=(10, 1),
                                       pocs=[(0, 0, 1, 2, 3, 0), (2, 0, 2, 4, 2, 2), (0, 2, 2, 4, 3, 4)])
    out["j2k_cblk_all_styles.j2k"] = je.opj_encode(p3, numresolution=3, mode=63, cblockw_init=8, cblockh_init=8,
                                                   rates=(20, 6, 1))
    out["j2k_bypass_reset_97.j2k"] = je.opj_encode(p3, numresolution=3, mode=3, irreversible=1, rates=(12, 3))
    out["j2k_termall_vsc.j2k"] = je.opj_encode(p3, numresolution=3, mode=12, cblockw_init=16, cblockh_init=16)
    out["j2k_pterm_segsym_97.j2k"] = je.opj_encode(p3, numresolution=3, mode=48, irreversible=1, rates=(8,))
    out["j2k_sop_eph_tileparts.j2k"] = je.opj_encode(p3, numresolution=3, csty=6, tp_on=1, tp_flag=ord("R"),
                                                     tile_size_on=1, cp_tdx=16, cp_tdy=16, rates=(10, 1))
    out["j2k_roi.j2k"] = je.opj_encode(p3, numresolution=3, roi_compno=0, roi_shift=5, rates=(15, 1))
    out["j2k_prec12_signed_97.j2k"] = je.opj_encode(je.planes(21, 19, 3, 27, 12, True), prec=12, sgnd=True,
                                                    irreversible=1, numresolution=3)
    out["j2k_odd_offsets_97.j2k"] = je.opj_encode(je.planes(13, 31, 3, 34), offset=(3, 5), irreversible=1,
                                                  numresolution=3, prog_order=4, tile_size_on=1, cp_tx0=1,
                                                  cp_ty0=2, cp_tdx=9, cp_tdy=7)
    out["j2k_prec5_grey.j2k"] = je.opj_encode(je.planes(21, 19, 1, 28, 5), prec=5, numresolution=3)
    full, half = je.planes(22, 20, 1, 29)[0], je.planes(11, 10, 2, 30)
    out["j2k_subsampled_chroma.j2k"] = je.opj_encode([full] + half, dxy=[(1, 1), (2, 2), (2, 2)], tcp_mct=0,
                                                     numresolution=3)
    cs3 = je.opj_encode(p3, numresolution=3)
    cs4 = je.opj_encode(je.planes(27, 33, 4, 31), numresolution=3, tcp_mct=0)
    cs1 = je.opj_encode(je.planes(27, 33, 1, 32), numresolution=3)
    rng = np.random.default_rng(33)
    colours = rng.integers(0, 256, (256, 3))
    colours[7] = colours[3]  # PIL keeps each colour once
    out["j2k_cmyk.jp2"] = je.jp2_file(cs4, 27, 33, 4, 7, je.colr(12))
    out["j2k_sycc.jp2"] = je.jp2_file(cs3, 27, 33, 3, 7, je.colr(18))
    out["j2k_palette.jp2"] = je.jp2_file(cs1, 27, 33, 1, 7, je.colr(16), je.pclr(colours))
    out["j2k_cdef_icc.jp2"] = je.jp2_file(cs3, 27, 33, 3, 7, je.colr_icc(bytes(64)),
                                          je.cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)]), brand=b"jpx ")
    tiled = je.opj_encode(p3, numresolution=3, csty=6, tile_size_on=1, cp_tdx=16, cp_tdy=16, rates=(10, 1))
    out["j2k_ppt.j2k"] = je.to_ppt(tiled, 40)
    out["j2k_ppm.j2k"] = je.to_ppm(tiled, 1000)
    return out


def avif_colr(data: bytes, primaries: int, transfer: int, matrix: int, full: int) -> bytes:
    """An AVIF whose nclx colr box says other colour coefficients."""
    i = data.index(b"colrnclx") + 8
    nclx = primaries.to_bytes(2, "big") + transfer.to_bytes(2, "big") + matrix.to_bytes(2, "big") + bytes([full << 7])
    return data[:i] + nclx + data[i + 7:]


def avif_as_12bit(data: bytes) -> bytes:
    """A 10-bit AVIF of profile 0 (4:2:0) or 2 (4:2:2) without alpha, as
    libavif writes it (a temporal delimiter, then a reduced still-picture
    sequence header), relabelled as 12-bit profile 2: the sequence header
    rewritten (seq_profile 2, twelve_bit 1, subsampling_x / _y after
    color_range), the tiles left as coded, so that a decoder reads the same
    symbols at 12 bits; aom writes no loop restoration at 12 bits, and this
    is how a 12-bit restored frame is had. The header grows by at most two
    bytes, taken from the dropped temporal delimiter."""
    at = data.index(b"\x12\x00\x0a")
    assert data.count(b"\x12\x00\x0a") == 1, "one item (no alpha)"
    n = data[at + 3]
    payload = data[at + 4:at + 4 + n]
    bits = [(payload[i >> 3] >> (7 - (i & 7))) & 1 for i in range(8 * n)]

    def read(pos: int, k: int) -> int:
        return int("".join(map(str, bits[pos:pos + k])), 2)
    profile = read(0, 3)
    assert read(4, 1) == 1, "reduced still-picture header"
    wbits, hbits = read(10, 4) + 1, read(14, 4) + 1
    high = 18 + wbits + hbits + 6  # after the six tool flags: color_config
    assert profile in (0, 2) and bits[high] == 1 and (profile == 0 or bits[high + 1] == 0), "10-bit, profile 0 / 2"
    mono = high + 1 + (profile == 2)
    assert bits[mono] == 0, "not monochrome"
    color_range = mono + 2 + 24 * bits[mono + 1]
    sy = 1 if profile == 0 else 0  # 4:2:0, or 4:2:2
    end = color_range + 1 + 2 * sy + 2  # chroma_sample_position, separate_uv_delta_q, film grain
    new = [0, 1, 0] + bits[3:high] + [1, 1] + bits[mono:color_range + 1] + [1, sy] + bits[color_range + 1:end] + [1]
    new += [0] * (-len(new) % 8)
    out = bytes(int("".join(map(str, new[i:i + 8])), 2) for i in range(0, len(new), 8))
    assert len(out) <= n + 2
    out += bytes(n + 2 - len(out))  # zero bytes after the trailing bits
    return data[:at] + bytes([0x0A, len(out)]) + out + data[at + 4 + n:]


def _smooth(h: int, w: int, seed: int) -> np.ndarray:
    """Slow colour waves with a little noise: a large image in few bytes."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 37.0 + y / 53.0), 128 + 90 * np.cos(x / 29.0 - y / 41.0),
                    (x + y) / 8 % 256], -1) + np.random.default_rng(seed).normal(0, 2, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _fixtures_avif(enc, pil, Image) -> dict[str, bytes]:
    """The loft at PIL's defaults, and the AVIF stills PIL's encoder (aom)
    writes that step 1 of the port decodes: the four coefficient-CDF
    quantizer buckets (quality 95 / 90 / 75 / 40: base_q_idx 12 / 24 / 64 /
    152) and lossless (quality 100), speeds 5, 10 and 0 (64 x 64: 128 x 128
    superblocks, loop restoration enabled and unused), 1024 x 1024 (2 x 2
    tiles, 128 superblocks), odd sizes, limited range, the colr box edited
    to BT.709 and BT.2020 in both ranges, and an EXIF orientation (irot)."""
    out = {}
    for png, name in LOSSY2.items():
        out[name] = pil(Image.open(os.path.join(REPO, "scenes", png)).convert("RGB"), "AVIF")
    ph = enc.photo(128, 128, 1)
    for q in (95, 90, 75, 40):
        out[f"avif_q{q}.avif"] = pil(ph, "AVIF", quality=q)
    out["avif_lossless.avif"] = pil(enc.photo(64, 64, 2), "AVIF", quality=100)
    for speed in (5, 10):
        out[f"avif_speed{speed}.avif"] = pil(ph, "AVIF", speed=speed)
    out["avif_speed0_sb128.avif"] = pil(enc.photo(64, 64, 3), "AVIF", speed=0)
    out["avif_1024_tiles.avif"] = pil(_smooth(1024, 1024, 4), "AVIF", quality=50)
    small = enc.photo(23, 37, 5)
    out["avif_37x23.avif"] = pil(small, "AVIF")
    out["avif_1x1.avif"] = pil(enc.photo(1, 1, 6), "AVIF")
    out["avif_17x1.avif"] = pil(enc.photo(1, 17, 7), "AVIF")
    limited = pil(small, "AVIF", range="limited")
    out["avif_limited.avif"] = limited
    out["avif_bt709.avif"] = avif_colr(out["avif_37x23.avif"], 1, 1, 1, 1)
    out["avif_bt709_limited.avif"] = avif_colr(limited, 1, 1, 1, 0)
    out["avif_bt2020.avif"] = avif_colr(out["avif_37x23.avif"], 9, 16, 9, 1)
    out["avif_bt2020_limited.avif"] = avif_colr(limited, 9, 16, 9, 0)
    exif = Image.Exif()
    exif[0x0112] = 6
    out["avif_orient6.avif"] = pil(small, "AVIF", exif=exif.tobytes())
    out.update(_fixtures_avif_options(enc, pil, Image))
    out.update(_fixtures_avif_hbd(enc, Image))
    out.update(_fixtures_avif_tools(enc, pil, Image))
    out.update(_fixtures_avif_step5(enc, pil, Image))
    out.update(_fixtures_avif_step6(enc, pil, Image))
    out.update(_fixtures_avif_step7(enc, pil, Image))
    return out


def _loft_rgba(png: str):
    """A loft texture with an alpha ramp (255 at the left edge, 1 at the
    right), as the premultiplied loft texture is written."""
    from PIL import Image

    rgb = np.asarray(Image.open(os.path.join(REPO, "scenes", png)).convert("RGB"))
    h, w, _ = rgb.shape
    a = np.broadcast_to(np.linspace(255, 1, w).round().astype(np.uint8), (h, w))
    return Image.fromarray(np.dstack([rgb, a]), "RGBA")


def _fixtures_avif_options(enc, pil, Image) -> dict[str, bytes]:
    """The AVIF stills PIL writes with its own save options (AVIF step 2):
    each chroma layout (4:4:4, 4:2:2, 4:0:0), straight and premultiplied
    RGBA (an alpha item; 4:4:4 and an odd size too), loop restoration at
    speeds 0 / 2 / 4 on 256 x 256 and on 197 x 131 in 2 x 2 tiles, CDEF
    (enable-cdef) on 4:2:0, 4:2:2 and 4:4:4, 128 x 128 superblocks at speed
    0 with both filters, a 32 x 32 two-frame sequence whose still uses CDEF,
    and the loft's sixth set."""
    out = {}
    for png, name in LOSSY3.items():
        if "rgba" in name:
            out[name] = pil(_loft_rgba(png), "AVIF", speed=2, alpha_premultiplied=True)
        else:
            img = Image.open(os.path.join(REPO, "scenes", png)).convert("RGB")
            kw = dict(subsampling="4:4:4", speed=4, quality=50, advanced={"enable-cdef": "1"}) if "444" in name \
                else dict(subsampling="4:2:2")
            out[name] = pil(img, "AVIF", **kw)
    out["avif_444.avif"] = pil(enc.photo(32, 32, 9), "AVIF", subsampling="4:4:4")
    out["avif_422.avif"] = pil(enc.photo(37, 29, 11), "AVIF", subsampling="4:2:2")
    out["avif_400.avif"] = pil(enc.photo(29, 37, 12), "AVIF", subsampling="4:0:0")
    out["avif_rgba.avif"] = pil(Image.fromarray(enc.photo(32, 32, 10, 4), "RGBA"), "AVIF")
    out["avif_rgba_premultiplied.avif"] = pil(Image.fromarray(enc.photo(32, 32, 10, 4), "RGBA"), "AVIF",
                                              alpha_premultiplied=True)
    out["avif_rgba_444_premultiplied_odd.avif"] = pil(Image.fromarray(enc.photo(23, 41, 13, 4), "RGBA"), "AVIF",
                                                      subsampling="4:4:4", alpha_premultiplied=True)
    out["avif_speed0_restoration.avif"] = pil(enc.photo(128, 128, 1), "AVIF", speed=0)
    ph = enc.photo(256, 256, 1)
    for speed in (0, 2, 4):
        out[f"avif_lr_speed{speed}_256.avif"] = pil(ph, "AVIF", quality=60, speed=speed)
    out["avif_lr_197x131_tiles.avif"] = pil(enc.photo(131, 197, 14), "AVIF", quality=60, speed=0, tile_rows=1,
                                            tile_cols=1)
    cdef = enc.photo(128, 128, 2)
    for ss in ("4:2:0", "4:2:2", "4:4:4"):
        out[f"avif_cdef_{ss.replace(':', '')}.avif"] = pil(cdef, "AVIF", quality=30, subsampling=ss,
                                                          advanced={"enable-cdef": "1"})
    out["avif_sb128_cdef_lr.avif"] = pil(ph, "AVIF", quality=60, speed=0, advanced={"enable-cdef": "1"})
    out["avif_sequence_32.avif"] = pil(Image.fromarray(enc.photo(32, 32, 6)), "AVIF", save_all=True,
                                       append_images=[Image.fromarray(enc.photo(32, 32, 7))])
    return out


def _fixtures_avif_hbd(enc, Image) -> dict[str, bytes]:
    """AVIF step 3: 10- and 12-bit stills from OpenCV's libavif 1.4 (aom
    3.14; oracle.encode_hbd) on BT.601 planes of our own: each layout at
    both depths (profile 0 4:2:0 / 4:0:0, profile 1 4:4:4 at 10 bits,
    profile 2 4:2:2 and 12 bits), straight and premultiplied alpha of the
    colour's depth (4:2:0, 4:4:4, 4:0:0: each of libavif's alpha routes),
    limited range with BT.709 and BT.2020, CDEF (enable-cdef) and loop
    restoration at speeds 0 / 2 / 4 (aom writes no restoration at 12 bits:
    a 10-bit still relabelled 12-bit, `avif_as_12bit`, stands for it),
    128 x 128 superblocks, odd sizes and a row of one, 2 x 2 tiles, and
    the loft's tex1 at 10 bits and a few-colour still at 12 (screen-content
    tools: palette, and IntraBC in the loft)."""
    import torch_avif_oracle as oracle

    out = {}
    hbd = oracle.encode_hbd
    for depth in (10, 12):
        for k, (fmt, tag) in enumerate(((3, "420"), (1, "444"), (2, "422"), (4, "400"))):
            out[f"avif{depth}_{tag}.avif"] = hbd(enc.yuv_photo(40, 48, 40 + k, depth, fmt), depth, fmt)
    alpha = enc.yuv_photo(32, 40, 50, 10, 4)[0]
    out["avif10_rgba.avif"] = hbd(enc.yuv_photo(32, 40, 51, 10, 3), 10, 3, alpha=alpha)
    out["avif10_rgba_444_premultiplied.avif"] = hbd(enc.yuv_photo(32, 40, 52, 10, 1), 10, 1, alpha=alpha,
                                                    premultiplied=True)
    out["avif10_400_rgba_premultiplied.avif"] = hbd(enc.yuv_photo(32, 40, 53, 10, 4), 10, 4, alpha=alpha,
                                                    premultiplied=True)
    alpha12 = enc.yuv_photo(29, 35, 54, 12, 4)[0]
    out["avif12_rgba_422.avif"] = hbd(enc.yuv_photo(29, 35, 55, 12, 2), 12, 2, alpha=alpha12)
    out["avif12_rgba_premultiplied.avif"] = hbd(enc.yuv_photo(29, 35, 56, 12, 3), 12, 3, alpha=alpha12,
                                                premultiplied=True)
    out["avif10_limited_37x23.avif"] = hbd(enc.yuv_photo(23, 37, 57, 10, 3, 0), 10, 3, full=0)
    out["avif10_bt709_limited_444.avif"] = hbd(enc.yuv_photo(23, 37, 58, 10, 1, 0), 10, 1, full=0, matrix=1)
    out["avif12_bt2020_limited_422.avif"] = hbd(enc.yuv_photo(23, 37, 59, 12, 2, 0), 12, 2, full=0, matrix=9)
    out["avif12_bt709.avif"] = hbd(enc.yuv_photo(23, 37, 60, 12, 3), 12, 3, matrix=1)
    for speed, fmt in ((0, 3), (2, 1), (4, 2)):
        out[f"avif10_cdef_lr_speed{speed}_128.avif"] = hbd(enc.yuv_photo(128, 128, 61 + speed, 10, fmt), 10, fmt,
                                                           speed=speed, quality=50, options={"enable-cdef": 1})
    out["avif12_cdef_sb128.avif"] = hbd(enc.yuv_photo(96, 96, 65, 12, 3), 12, 3, speed=0, quality=40,
                                        options={"enable-cdef": 1})
    out["avif12_lr_relabelled_420.avif"] = avif_as_12bit(hbd(enc.yuv_photo(102, 113, 5, 10, 3), 10, 3, speed=2,
                                                             quality=70, options={"enable-cdef": 1}))
    out["avif12_17x1.avif"] = hbd(enc.yuv_photo(1, 17, 66, 12, 3), 12, 3)
    out["avif10_1x9_444.avif"] = hbd(enc.yuv_photo(9, 1, 67, 10, 1), 10, 1)
    out["avif12_tiles_197x131.avif"] = hbd(enc.yuv_photo(131, 197, 68, 12, 3), 12, 3, quality=50,
                                           tiles_log2=(1, 1))
    loft = np.asarray(Image.open(os.path.join(REPO, "scenes", "loft_tex1.png")).convert("RGB"))
    out["avif10_loft_tex1_intrabc.avif"] = hbd(enc.yuv_planes(loft, 10, 3), 10, 3, speed=4, quality=75)
    rng = np.random.default_rng(69)
    pal = rng.integers(0, 256, (5, 3))
    few = pal[rng.integers(0, 5, (12, 16)).repeat(8, 0).repeat(8, 1)].astype(np.uint8)
    out["avif12_palette.avif"] = hbd(enc.yuv_planes(few, 12, 1), 12, 1, speed=4, quality=75)
    return out


def aom_grain_table(lag: int, y_points, cb_points, cr_points, seed: int = 4321, shifts=(7, 1, 9),
                    chroma_from_luma: int = 0, overlap: int = 1, cb=(128, 192, 256), cr=(128, 192, 256),
                    coeff_seed: int = 0) -> str:
    """A film grain table in aom's text format (`film-grain-table`, read by
    aom_film_grain_table_read): one entry for all time with its seed, the
    AR lag, shifts (ar_coeff_shift, grain_scale_shift, scaling_shift),
    chroma-from-luma, overlap, the Cb / Cr multipliers and offsets, the
    scaling points, and seeded AR coefficients in [-24, 24) (aom reads the
    luma ones whatever the points)."""
    n = 2 * lag * (lag + 1)
    rng = np.random.default_rng(coeff_seed)

    def row(v):
        return " ".join(str(int(x)) for x in v)
    points = [f"{len(p)} " + row(np.ravel(p)) if p else "0" for p in (y_points, cb_points, cr_points)]
    return (f"filmgrn1\nE 0 9223372036854775807 1 {seed} 1\n"
            f"\tp {lag} {shifts[0]} {shifts[1]} {shifts[2]} {chroma_from_luma} {overlap} {row(cb)} {row(cr)}\n"
            f"\tsY {points[0]}\n\tsCb {points[1]}\n\tsCr {points[2]}\n"
            f"\tcY {row(rng.integers(-24, 24, n))}\n\tcCb {row(rng.integers(-24, 24, n + 1))}\n"
            f"\tcCr {row(rng.integers(-24, 24, n + 1))}\n")


def with_grain_table(encode, table: str) -> bytes:
    """encode(options) with aom's film-grain-table option on `table`
    written to a temporary file."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grain.tbl")
        with open(path, "w") as f:
            f.write(table)
        return encode({"film-grain-table": path})


def avif_grain_clipped(data: bytes) -> bytes:
    """An AVIF with film grain whose frame header is edited to set
    clip_to_restricted_range: the header's last bit, so nothing moves
    (no encoder here sets it: aom's 16 test vectors and its grain tables
    leave it 0)."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif

    obus, _ = avif.parse(data)
    seq = None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind == av1_obu.OBU_FRAME:
            b = av1_obu.Bits(payload)
            h = av1_obu.frame_header(b, seq)
            assert h["grain"]["apply_grain"] and not h["grain"]["clip_to_restricted_range"]
            edited = bytearray(payload)
            edited[(b.bit - 1) >> 3] |= 0x80 >> ((b.bit - 1) & 7)
            at = data.index(payload)
            return data[:at] + bytes(edited) + data[at + len(payload):]
    raise ValueError("no frame OBU")


# which tool each of aom's 16 film-grain-test vectors exercises, read from
# their headers: ar_coeff_lag 2 (1, 9, 10, 12-15) or 3, overlap off in 1
# and 12, no chroma points in 6, 13 and 14, chroma from luma in 15,
# grain_scale_shift 1 in 3 and 2 in 16; none has lag 0 or 1, no luma
# points or clip_to_restricted_range (aom's grain tables and a header edit
# give those)
GRAIN_TEST_VECTORS = {1: "lag 2, overlap off", 6: "no chroma points", 15: "chroma from luma",
                      16: "grain_scale_shift 2"}


def _fixtures_avif_tools(enc, pil, Image) -> dict[str, bytes]:
    """AVIF step 4: the coding tools aom writes into stills. At 8 bits
    through PIL: film grain from four of aom's test vectors
    (`film-grain-test`, GRAIN_TEST_VECTORS), from grain tables
    (`film-grain-table`: AR lags 0 and 1, no luma points in 4:4:4), with
    clip_to_restricted_range set by a header edit, in the four layouts at
    37 x 23 and estimated from a smooth noisy image (`denoise-noise-level`);
    quantizer matrices at levels 0 and 13; delta q (`deltaq-mode` 2) and
    delta q with delta lf (`delta-lf-mode` 1) on 128 x 128; all of them
    together in RGBA. At 10 and 12 bits through OpenCV's libavif
    (oracle.encode_hbd): grain, quantizer matrices and delta q
    (`deltaq-mode` 3, 128 x 128 at quality 70: aom writes none at 50), two
    layouts each."""
    import torch_avif_oracle as oracle

    out = {}  # the two step-3 refusals, which decode now: grain signalled and not applied (too few flat
    # blocks in 16 x 16 to estimate it), and quantizer matrices at aom's default levels
    out["avif_film_grain.avif"] = pil(enc.photo(16, 16, 9), "AVIF", advanced={"denoise-noise-level": "20"})
    out["avif_qm.avif"] = pil(enc.photo(16, 16, 10), "AVIF", advanced={"enable-qm": "1"})
    ph = enc.photo(64, 64, 80)
    for n in GRAIN_TEST_VECTORS:
        out[f"avif_grain_test{n}.avif"] = pil(ph, "AVIF", advanced={"film-grain-test": str(n)})
    y, c = [(0, 20), (90, 60), (255, 40)], [(0, 30), (128, 70), (255, 30)]
    for name, ss, table in (
            ("avif_grain_lag0.avif", "4:2:0", aom_grain_table(0, y, c, c, shifts=(7, 1, 9), cb=(120, 200, 300))),
            ("avif_grain_lag1_422.avif", "4:2:2", aom_grain_table(1, y, c, [(10, 50)], shifts=(6, 0, 10),
                                                                    overlap=0, cr=(140, 180, 200), coeff_seed=1)),
            ("avif_grain_no_luma_444.avif", "4:4:4", aom_grain_table(2, [], c, c, shifts=(7, 1, 9), coeff_seed=2))):
        out[name] = with_grain_table(lambda o, ss=ss: pil(ph, "AVIF", subsampling=ss, advanced=o), table)
    out["avif_grain_clipped.avif"] = avif_grain_clipped(pil(enc.photo(64, 64, 81), "AVIF",
                                                            advanced={"film-grain-test": "5"}))
    small = enc.photo(23, 37, 82)
    for ss in ("4:4:4", "4:2:2", "4:2:0", "4:0:0"):
        out[f"avif_grain_37x23_{ss.replace(':', '')}.avif"] = pil(small, "AVIF", subsampling=ss,
                                                                  advanced={"film-grain-test": "10"})
    noisy = _smooth(128, 128, 83).astype(int) + np.random.default_rng(83).normal(0, 6, (128, 128, 3)).round()
    out["avif_grain_estimated_128.avif"] = pil(np.clip(noisy, 0, 255).astype(np.uint8), "AVIF",
                                               advanced={"denoise-noise-level": "10"})
    for level in (0, 13):
        out[f"avif_qm{level}.avif"] = pil(enc.photo(48, 80, 84 + level), "AVIF", subsampling="4:4:4" if level else "4:2:0",
                                          advanced={"enable-qm": "1", "qm-min": str(level), "qm-max": str(level)})
    big = enc.photo(128, 128, 86)
    out["avif_deltaq_128.avif"] = pil(big, "AVIF", advanced={"deltaq-mode": "2"})
    out["avif_deltaq_deltalf_128.avif"] = pil(big, "AVIF", advanced={"deltaq-mode": "2", "delta-lf-mode": "1"})
    rgba = Image.fromarray(enc.photo(128, 128, 87, 4), "RGBA")
    out["avif_tools_rgba_128.avif"] = pil(rgba, "AVIF", advanced={
        "deltaq-mode": "2", "delta-lf-mode": "1", "enable-qm": "1", "qm-min": "5", "qm-max": "9",
        "film-grain-test": "2"})
    hbd = oracle.encode_hbd
    for depth, fmt, tag in ((10, 2, "422"), (12, 1, "444")):
        out[f"avif{depth}_grain_{tag}.avif"] = hbd(enc.yuv_photo(40, 56, 88 + fmt, depth, fmt), depth, fmt,
                                                   options={"film-grain-test": "16" if depth == 12 else "5"})
    for depth, fmt, tag in ((10, 3, "420"), (12, 4, "400")):
        out[f"avif{depth}_qm_{tag}.avif"] = hbd(enc.yuv_photo(40, 56, 90 + fmt, depth, fmt), depth, fmt,
                                                options={"enable-qm": 1, "qm-min": 3, "qm-max": 11})
    for depth, fmt, tag in ((10, 1, "444"), (12, 3, "420")):
        out[f"avif{depth}_deltaq_{tag}_128.avif"] = hbd(enc.yuv_photo(128, 128, 92 + fmt, depth, fmt), depth, fmt,
                                                        quality=70, options={"deltaq-mode": 3})
    return out


def _iloc(data: bytes) -> dict:
    """item id -> (entry offset, data offset, length) of a PIL-written iloc
    (version 0, 4-byte offsets and lengths, one extent each)."""
    i = data.index(b"iloc") + 4
    assert data[i] == 0 and data[i + 4:i + 6] == b"\x44\x00"
    out, at = {}, i + 8
    for _ in range(int.from_bytes(data[i + 6:i + 8], "big")):
        out[int.from_bytes(data[at:at + 2], "big")] = (at, int.from_bytes(data[at + 6:at + 10], "big"),
                                                       int.from_bytes(data[at + 10:at + 14], "big"))
        at += 14
    return out


def avif_with_alpha_of(data: bytes, other: bytes) -> bytes:
    """A PIL-written RGBA AVIF `data` with its alpha item's OBUs (item 2,
    stored before the colour item's) replaced by `other`'s."""
    (at2, off2, len2), (at1, off1, _) = _iloc(data)[2], _iloc(data)[1]
    _, off, ln = _iloc(other)[2]
    new = other[off:off + ln]
    out = bytearray(data[:off2] + new + data[off2 + len2:])
    out[at2 + 10:at2 + 14] = len(new).to_bytes(4, "big")
    out[at1 + 6:at1 + 10] = (off1 + len(new) - len2).to_bytes(4, "big")
    mdat = data.index(b"mdat") - 4
    out[mdat:mdat + 4] = (int.from_bytes(data[mdat:mdat + 4], "big") + len(new) - len2).to_bytes(4, "big")
    return bytes(out)


def avif_frame_bit_flipped(data: bytes, bit: int) -> bytes:
    """An AVIF with one bit of its (first) frame OBU's payload flipped, bit
    0 the payload's first (show_existing_frame in a full frame header; bits
    1-2 frame_type)."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif

    obus, _ = avif.parse(data)
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_FRAME:
            at = data.index(payload)
            edited = bytearray(payload)
            edited[bit >> 3] ^= 0x80 >> (bit & 7)
            return data[:at] + bytes(edited) + data[at + len(payload):]
    raise ValueError("no frame OBU")


def avif_parts(data: bytes):
    """(the primary item's OBUs, its av1C box, its colr box or None) of a
    one-item still."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import avif

    start = data.index(b"ipco") + 4
    end = start - 8 + int.from_bytes(data[start - 8:start - 4], "big")
    boxes = {kind: data[s - 8:e] for kind, s, e in avif._boxes(data, start, end)}
    return avif.parse(data)[0], boxes[b"av1C"], boxes.get(b"colr")


def avif_grid_edited(data: bytes, width: int, height: int) -> bytes:
    """A grid AVIF from libavif's encoder (16-bit output sizes) with its
    ImageGrid output size and the grid item's ispe both set to width x
    height: the cells cropped."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import avif

    for kind, s, e in avif._boxes(data, 0, len(data)):
        if kind == b"meta":
            meta = avif._parse_meta(data, s, e)
    assert meta.items[meta.primary] == b"grid"
    (off, ln), = meta.locs[meta.primary][2]
    assert ln == 8 and data[off + 1] & 1 == 0, "16-bit output sizes"
    data = data[:off + 4] + width.to_bytes(2, "big") + height.to_bytes(2, "big") + data[off + 8:]
    for i, _ in meta.assoc[meta.primary]:
        kind, s, e = meta.props[i - 1]
        if kind == b"ispe":
            data = data[:s + 4] + width.to_bytes(4, "big") + height.to_bytes(4, "big") + data[s + 12:]
    return data


def _bits(data: bytes, n: int | None = None) -> list:
    n = len(data) * 8 if n is None else n
    return [(data[k >> 3] >> (7 - (k & 7))) & 1 for k in range(n)]


def _bytes(bits: list) -> bytes:
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[k:k + 8])), 2) for k in range(0, len(bits), 8))


def _uint_bits(value: int, n: int) -> list:
    return [(value >> (n - 1 - k)) & 1 for k in range(n)]


def leb128(n: int) -> bytes:
    out = b""
    while True:
        b, n = n & 0x7F, n >> 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def obu(kind: int, payload: bytes) -> bytes:
    """An OBU with its size field and no extension."""
    return bytes([kind << 3 | 2]) + leb128(len(payload)) + payload


def _logged_reads(parse, payload: bytes, *args):
    """Run parse(Bits, *args) over payload -> (its result, the reads as
    (bit position, width, value, the av1_obu source line that read them),
    the bit where it stopped)."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu

    class Logged(av1_obu.Bits):
        def f(self, n):
            at, caller = self.bit, sys._getframe(1)
            if caller.f_code.co_name in ("su", "ns", "uvlc"):
                caller = caller.f_back
            value = super().f(n)
            log.append((at, n, value, caller.f_lineno))
            return value
    log = []
    b = Logged(payload)
    return parse(b, *args), log, b.bit


def _line(func, text: str) -> int:
    """The source line of func that holds text."""
    import inspect

    lines, first = inspect.getsourcelines(func)
    return first + next(i for i, line in enumerate(lines) if text in line)


def _reads_at(log: list, line: int) -> list:
    return [r for r in log if r[3] == line]


def _edited(bits: list, edits: list) -> list:
    """bits with each (position, old width, new bits) edit applied."""
    for at, width, new in sorted(edits, key=lambda e: -e[0]):
        bits = bits[:at] + list(new) + bits[at + width:]
    return bits


def _seq_superres(payload: bytes, width: int):
    """A full sequence header with enable_superres set and its maximum
    frame width made `width` (more width bits where it needs them) -> (the
    new payload, its parse)."""
    from optixpathtracer_tpu_torch.io.codecs import av1_obu

    seq, log, end = _logged_reads(av1_obu.sequence_header, payload)
    (bits_at, _, wbits1, _), _ = _reads_at(log, _line(av1_obu.sequence_header, "wbits, hbits = "))
    (max_at, old_wbits, _, _), _ = _reads_at(log, _line(av1_obu.sequence_header, 's["max_width"], s["max_height"]'))
    superres_at = _reads_at(log, _line(av1_obu.sequence_header, 's["enable_superres"], s["enable_cdef"]'))[0][0]
    wbits = max(wbits1 + 1, (width - 1).bit_length())
    bits = _edited(_bits(payload, end), [(bits_at, 4, _uint_bits(wbits - 1, 4)),
                                         (max_at, old_wbits, _uint_bits(width - 1, wbits)),
                                         (superres_at, 1, [1])])
    new = _bytes(bits + [1])  # trailing_bits
    return new, av1_obu.sequence_header(new)


def avif_superres(data: bytes, width: int, denom: int) -> bytes:
    """A still of width W' = (8 width + denom / 2) / denom, or 16 where
    that is less (written with a full sequence header, `single=False`),
    made a superres still of `width`:
    enable_superres and the maximum width in its sequence header (and its
    av1C's copy), use_superres and coded_denom = denom - 9 in its frame
    header, `width` in its ispe; the tile data as coded."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
    from torch_codec_encoders import avif_still

    obus, av1c, colr = avif_parts(data)
    out, seq, new_seq = b"", None, None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
            payload, new_seq = _seq_superres(payload, width)
            av1c = av1c[:12] + (obu(kind, payload) if len(av1c) > 12 else b"")
            av1c = (len(av1c)).to_bytes(4, "big") + av1c[4:]
        elif kind in (av1_obu.OBU_FRAME, av1_obu.OBU_FRAME_HEADER):
            h, log, end = _logged_reads(av1_obu.frame_header, payload, seq)
            # dav1d's downscaled width: (8 W + d / 2) / d, but not under 16 (or W)
            assert h["width"] == max((8 * width + denom // 2) // denom, min(16, width)), (h["width"], width, denom)
            fh = av1_obu.frame_header
            render_at = _reads_at(log, _line(fh, "# render_and_frame_size_different"))[0][0]
            edits = [(render_at, 0, [1] + _uint_bits(denom - 9, 3))]
            for at, n, value, _ in _reads_at(log, _line(fh, 'h["width"] = b.f(s["frame_width_bits"]) + 1')):
                edits.append((at, n, _uint_bits(width - 1, new_seq["frame_width_bits"])))
            for at, n, value, _ in _reads_at(log, _line(fh, 'h["allow_intrabc"] = b.f(1)')):
                assert value == 0, "IntraBC is off under superres"
                edits.append((at, n, []))
            head = _bytes(_edited(_bits(payload, end), edits))
            payload = head + payload[(end + 7) // 8:] if kind == av1_obu.OBU_FRAME else _bytes(
                _edited(_bits(payload, end), edits) + [1])
        out += obu(kind, payload)
    return avif_still(out, (width, avif._ispe(data, *_primary(data))[1]), av1c, depth=seq["bit_depth"], colr=colr)


def key_frame_as(payload: bytes, seq: dict, frame_type: int = 0, show_frame: int = 1, refresh: int = 0xFF,
                 showable: int = 1) -> bytes:
    """A shown key frame's OBU_FRAME payload (full header) with its header
    rewritten: frame_type (0 key, 2 intra-only), show_frame, showable_frame
    and refresh_frame_flags, read where the frame is not a shown key frame,
    and error_resilient_mode 0 (film grain parameters dropped from a frame
    neither shown nor showable); the tile data as coded."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu

    fh = av1_obu.frame_header
    h, log, end = _logged_reads(fh, payload, seq)
    assert h["frame_type"] == av1_obu.KEY_FRAME and h["show_frame"] and not seq["decoder_model_info_present"]
    ft_at = _reads_at(log, _line(fh, "frame_type = b.f(2)"))[0][0]
    shown_at = _reads_at(log, _line(fh, "show_frame = b.f(1)"))[0][0]
    edits = [(ft_at, 2, _uint_bits(frame_type, 2)), (shown_at, 1, [show_frame])]
    extra = ([] if show_frame else [showable]) + [0]  # showable_frame, error_resilient_mode
    edits.append((shown_at + 1, 0, extra))
    if frame_type != av1_obu.KEY_FRAME or not show_frame:
        assert frame_type == av1_obu.KEY_FRAME or refresh != 0xFF
        size_line = _line(fh, "# frame_size, superres_params, render_size")
        at = min(r[0] for r in log if r[3] > size_line)
        edits.append((at, 0, _uint_bits(refresh, 8)))
    if not (show_frame or showable) and h["grain"]["apply_grain"]:  # film_grain_params no longer read
        import inspect

        lines, first = inspect.getsourcelines(av1_obu.film_grain_params)
        grain_at = min(r[0] for r in log if first <= r[3] < first + len(lines))
        edits.append((grain_at, end - grain_at, []))
    return _bytes(_edited(_bits(payload, end), edits)) + payload[(end + 7) // 8:]


def show_existing_frame(slot: int) -> bytes:
    """An OBU_FRAME_HEADER OBU showing the frame of reference slot `slot`."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu

    return obu(av1_obu.OBU_FRAME_HEADER, _bytes([1] + _uint_bits(slot, 3) + [1]))


def avif_frames(data: bytes, frames: list, tail: bytes = b"") -> bytes:
    """A still of `data`'s sequence header followed by `frames`, each an
    OBU_FRAME payload or a whole OBU (bytes starting with an OBU header:
    wrapped in a tuple), then `tail` bytes, muxed as `data`'s item."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
    from torch_codec_encoders import avif_still

    obus, av1c, colr = avif_parts(data)
    seq = next(p for k, p in av1_obu.split_obus(obus) if k == av1_obu.OBU_SEQUENCE_HEADER)
    out = obu(av1_obu.OBU_SEQUENCE_HEADER, seq)
    for f in frames:
        out += f[0] if isinstance(f, tuple) else obu(av1_obu.OBU_FRAME, f)
    return avif_still(out + tail, avif._ispe(data, *_primary(data)), av1c,
                      depth=av1_obu.sequence_header(seq)["bit_depth"], colr=colr)


def frame_payload(data: bytes):
    """(the sequence header, the frame OBU's payload) of a one-frame still."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif

    seq = None
    for kind, payload in av1_obu.split_obus(avif.parse(data)[0]):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind == av1_obu.OBU_FRAME:
            return seq, payload
    raise ValueError("no frame OBU")


def _box_spans(data: bytes, start: int, end: int):
    """(type, box start, payload start, box end) of each box in data[start:end]."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import avif

    for kind, s, e in avif._boxes(data, start, end):
        head = 16 if int.from_bytes(data[s - 8:s - 4], "big") == 1 and s - 16 >= start else 8
        yield kind, s - head, s, e


def _chunk_offsets(data: bytes):
    """(position, width) of each stco / co64 chunk offset of every track."""
    out = []

    def walk(start, end):
        for kind, _, s, e in _box_spans(data, start, end):
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                walk(s, e)
            elif kind in (b"stco", b"co64"):
                n, width = int.from_bytes(data[s + 4:s + 8], "big"), 4 if kind == b"stco" else 8
                out.extend((s + 8 + i * width, width) for i in range(n))
    walk(0, len(data))
    return out


def avif_meta_stripped(data: bytes) -> bytes:
    """An image sequence (PIL's `save_all`) without its `meta` box: its
    tracks alone, the chunk offsets moved with the data, the ftyp kept."""
    (_, start, _, end), = [b for b in _box_spans(data, 0, len(data)) if b[0] == b"meta"]
    out = bytearray(data)
    for at, width in _chunk_offsets(data):
        value = int.from_bytes(data[at:at + width], "big")
        out[at:at + width] = (value - (end - start) if value >= end else value).to_bytes(width, "big")
    return bytes(out[:start] + out[end:])


def avif_item_replaced(data: bytes, obus: bytes, major: bytes | None = None) -> bytes:
    """An image sequence (PIL's `save_all`) whose primary item (item 1)
    holds `obus` instead, appended to the last box (mdat); the major brand
    made `major` where given."""
    (at, _, _), = _iloc(data).values()
    mdat = [b for b in _box_spans(data, 0, len(data)) if b[0] == b"mdat"][-1]
    assert mdat[3] == len(data) and mdat[2] - mdat[1] == 8
    out = bytearray(data + obus)
    out[at + 6:at + 14] = len(data).to_bytes(4, "big") + len(obus).to_bytes(4, "big")
    out[mdat[1]:mdat[1] + 4] = (len(out) - mdat[1]).to_bytes(4, "big")
    if major is not None:
        i = data.index(b"ftyp") + 4
        out[i:i + 4] = major
    return bytes(out)


def avif_track_samples(data: bytes) -> list:
    """The samples of the first track of an image sequence, in order (from
    stsz, stsc and stco / co64)."""
    boxes = {}

    def walk(start, end):
        for kind, _, s, e in _box_spans(data, start, end):
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl") and b"stco" not in boxes:
                walk(s, e)
            elif kind in (b"stsz", b"stsc", b"stco", b"co64"):
                boxes.setdefault(kind, (s, e))
    walk(0, len(data))

    def u32(at):
        return int.from_bytes(data[at:at + 4], "big")
    s = boxes[b"stsz"][0]
    fixed, count = u32(s + 4), u32(s + 8)
    sizes = [fixed] * count if fixed else [u32(s + 12 + 4 * i) for i in range(count)]
    s = boxes[b"stsc"][0]
    runs = [(u32(s + 8 + 12 * i), u32(s + 12 + 12 * i)) for i in range(u32(s + 4))]
    kind = b"stco" if b"stco" in boxes else b"co64"
    s, width = boxes[kind][0], 4 if kind == b"stco" else 8
    chunks = [int.from_bytes(data[s + 8 + width * i:s + 8 + width * (i + 1)], "big") for i in range(u32(s + 4))]
    out = []
    for c, offset in enumerate(chunks):
        per = [n for first, n in runs if first <= c + 1][-1]
        for _ in range(per):
            if len(out) < count:
                out.append(data[offset:offset + sizes[len(out)]])
                offset += sizes[len(out) - 1]
    return out


def avif_inter_shown_first(enc, pil) -> bytes:
    """AVIF step 8's example: a still whose item holds PIL's two-frame
    sequence's key frame made hidden (refreshing every slot), then the
    sequence's second sample, an inter frame shown first, which aom at
    PIL's settings writes with motion-field projection, OBMC and global
    motion."""
    from PIL import Image

    frames = [Image.fromarray(enc.photo(32, 48, s)) for s in (40, 41)]
    import io
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:])
    seq_file = buf.getvalue()
    seq, key = frame_payload(seq_file)
    second = avif_track_samples(seq_file)[1]
    return avif_frames(seq_file, [key_frame_as(key, seq, show_frame=0, refresh=0xFF), (second,)])


def avif_alpha_limited(data: bytes) -> bytes:
    """A PIL-written RGBA AVIF (alpha item 2) with its alpha item's sequence
    header (and its av1C's copy) saying limited range: color_range 0."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu

    _, off, ln = _iloc(data)[2]
    pos = off
    while pos < off + ln:
        kind = data[pos] >> 3 & 15
        size, start = av1_obu.leb128(data, pos + 1 + (data[pos] >> 2 & 1))
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            payload = data[start:start + size]
            seq, log, _ = _logged_reads(av1_obu.sequence_header, payload)
            assert seq["mono"] and seq["color_range"]
            at = _reads_at(log, _line(av1_obu.sequence_header, 's["color_range"] = b.f(1)'))[0][0]
            out = bytearray(data)
            for copy in (start, data.index(payload, off + ln) if payload in data[off + ln:] else None):
                if copy is not None:
                    out[copy + (at >> 3)] ^= 0x80 >> (at & 7)
            return bytes(out)
        pos = start + size
    raise ValueError("no sequence header in the alpha item")


def avif_lr_edited(data: bytes, lr_types: list, unit_shift: int | None = None) -> bytes:
    """A still with a full sequence header and loop restoration on in some
    plane, its lr_params' coded restoration types (2 bits a plane: 0 none,
    1 switchable, 2 Wiener, 3 self-guided) set to lr_types, and its luma
    unit size to 64 << unit_shift where given (64-superblock stills); the
    tile data as coded, the item muxed again."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
    from torch_codec_encoders import avif_still

    obus, av1c, colr = avif_parts(data)
    out, seq = b"", None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        elif kind == av1_obu.OBU_FRAME:
            fh = av1_obu.frame_header
            h, log, end = _logged_reads(fh, payload, seq)
            assert any(h["lr_type"]), "the unit size bits are read only with some plane restored"
            reads = _reads_at(log, _line(fh, 'h["lr_type"][:planes] = [REMAP_LR_TYPE[b.f(2)]'))
            edits = [(at, 2, _uint_bits(t, 2)) for (at, _, _, _), t in zip(reads, lr_types)]
            if unit_shift is not None:
                assert not seq["use_128"]
                shifts = _reads_at(log, _line(fh, "shift = b.f(1)")) + _reads_at(log, _line(fh, "shift += b.f(1)"))
                edits.append((shifts[0][0], len(shifts), [1, unit_shift - 1] if unit_shift else [0]))
            payload = _bytes(_edited(_bits(payload, end), edits)) + payload[(end + 7) // 8:]
        out += obu(kind, payload)
    return avif_still(out, avif._ispe(data, *_primary(data)), av1c, depth=seq["bit_depth"], colr=colr)


def _primary(data: bytes):
    """(the parsed meta, the primary item's id) of an AVIF."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import avif

    for kind, s, e in avif._boxes(data, 0, len(data)):
        if kind == b"meta":
            meta = avif._parse_meta(data, s, e)
            return meta, meta.primary
    raise ValueError("no meta")


# PIL's messages for what libavif refuses
REFORMAT_FAILED = "Conversion from YUV failed: Reformat failed"
COLOR_FAILED = "Failed to decode frame 0: Decoding of color planes failed"
INVALID_GRID = "Failed to decode image: Invalid image grid"


def _fixtures_avif_step5(enc, pil, Image) -> dict[str, bytes]:
    """AVIF step 5. Segmentation from aom's good-quality usage with variance
    AQ (oracle.encode_hbd(single=False, options={"aq-mode": 1})): 8, 10 and
    12 bits in 4:2:0, 4:4:4 and 4:0:0, with quantizer matrices and with
    delta q on top, and an RGBA still whose colour and alpha items were each
    encoded so (libavif writes no segmentation beside an alpha item or in a
    grid: the two are muxed, tests/torch_codec_encoders.avif_still). Grids:
    2 x 2 (the one avif_raises/ held as unported) and 1 x 3 from libavif's
    own encoder (oracle.encode), a 10-bit 4:4:4 RGBA 2 x 2 from OpenCV's
    (encode_hbd(grid=...)), and the 2 x 2 with its output size cropped to
    120 x 100 by an ImageGrid edit. The matrices libavif converts without
    libyuv: identity (0) in 4:4:4 at 8 and 12 bits, FCC (4), SMPTE 240 (7),
    YCgCo (8) and chroma-derived NCL (12, on Display P3 primaries by a colr
    edit, and on BT.2020's, which libavif hands to libyuv) in 4:2:0 and
    4:2:2, two of them in limited range, and YCgCo-Re (16) at 10 bits."""
    import torch_avif_oracle as oracle

    hbd = oracle.encode_hbd
    out = {}
    aq = {"aq-mode": 1}
    out["avif_seg_420.avif"] = hbd(enc.yuv_photo(96, 96, 100, 8, 3), 8, 3, quality=50, single=False, options=aq)
    out["avif10_seg_444.avif"] = hbd(enc.yuv_photo(64, 80, 101, 10, 1), 10, 1, speed=4, quality=50, single=False,
                                     options=aq)
    out["avif12_seg_400.avif"] = hbd(enc.yuv_photo(80, 64, 102, 12, 4), 12, 4, quality=40, single=False, options=aq)
    out["avif10_seg_qm_420.avif"] = hbd(enc.yuv_photo(96, 96, 103, 10, 3), 10, 3, quality=50, single=False,
                                        options={**aq, "enable-qm": 1, "qm-min": 4, "qm-max": 10})
    out["avif_seg_deltaq_128.avif"] = hbd(enc.yuv_photo(128, 128, 104, 8, 3), 8, 3, quality=70, single=False,
                                          options={**aq, "deltaq-mode": 3})
    colour = avif_parts(hbd(enc.yuv_photo(96, 96, 105, 8, 3), 8, 3, quality=50, single=False, options=aq))
    alpha = avif_parts(hbd(enc.yuv_photo(96, 96, 106, 8, 4), 8, 4, quality=50, single=False, options=aq))
    out["avif_seg_rgba.avif"] = enc.avif_still(colour[0], (96, 96), colour[1], colr=colour[2], channels=3,
                                               alpha=alpha[:2])
    grid = oracle.encode(enc.photo(64, 64, 11)[..., 0], (2, 2))
    out["avif_grid.avif"] = grid
    out["avif_grid_1x3.avif"] = oracle.encode(enc.photo(64, 64, 107)[..., 1], (1, 3))
    out["avif10_grid_rgba_444.avif"] = hbd(enc.yuv_photo(128, 128, 108, 10, 1), 10, 1,
                                           alpha=enc.yuv_photo(128, 128, 109, 10, 4)[0], grid=(2, 2))
    out["avif_grid_cropped.avif"] = avif_grid_edited(grid, 120, 100)
    out["avif_matrix0_444.avif"] = hbd(enc.yuv_photo(40, 48, 110, 8, 1), 8, 1, matrix=0)
    out["avif12_matrix0_444.avif"] = hbd(enc.yuv_photo(40, 48, 111, 12, 1), 12, 1, matrix=0)
    for matrix in (4, 7, 8, 12):
        for fmt, tag in ((3, "420"), (2, "422")):
            full = 0 if (matrix, fmt) in ((7, 2), (12, 2)) else 1
            data = hbd(enc.yuv_photo(40, 48, 112 + matrix + fmt, 8, fmt, full), 8, fmt, matrix=matrix, full=full)
            if matrix == 12:  # Display P3 (libavif derives kr / kb), BT.2020 (libyuv's constants)
                data = avif_colr(data, 12 if fmt == 3 else 9, 13, 12, full)
            out[f"avif_matrix{matrix}_{tag}{'' if full else '_limited'}.avif"] = data
    out["avif10_matrix16_444.avif"] = hbd(enc.yuv_photo(40, 48, 130, 10, 1), 10, 1, matrix=16)
    return out


def superres_still(enc, width: int, height: int, denom: int, depth: int, fmt: int, seed: int, **kw) -> bytes:
    """A superres still of width x height: encoded at the downscaled width
    by OpenCV's libavif (a full sequence header), then avif_superres."""
    import torch_avif_oracle as oracle

    down = (8 * width + denom // 2) // denom
    data = oracle.encode_hbd(enc.yuv_photo(height, down, seed, depth, fmt), depth, fmt, single=False, **kw)
    return avif_superres(data, width, denom)


def avif_tile_cut(data: bytes, cut: int, tile: int = -1) -> bytes:
    """A still (one frame OBU) with `cut` bytes taken off the end of one
    tile's data (the last by default), the tile size fields, the OBU size
    and the item's extent rewritten: its symbol decoder reads 8 more bits
    past the data for each byte."""
    sys.path.insert(0, REPO)
    from optixpathtracer_tpu_torch.io.codecs import av1_obu, avif
    from torch_codec_encoders import avif_still

    obus, av1c, colr = avif_parts(data)
    out, seq = b"", None
    for kind, payload in av1_obu.split_obus(obus):
        if kind == av1_obu.OBU_SEQUENCE_HEADER:
            seq = av1_obu.sequence_header(payload)
        if kind == av1_obu.OBU_FRAME:
            b = av1_obu.Bits(payload)
            h = av1_obu.frame_header(b, seq)
            b.byte_align()
            tiles = []
            av1_obu.tile_group(payload, b.pos, h, tiles)
            n, size_bytes = len(tiles), h["tile_size_bytes"]
            first = tiles[0][1] - (size_bytes if n > 1 else 0)
            body = payload[:first]
            for i, (_, at, size) in enumerate(tiles):
                part = payload[at:at + size - (cut if i == tile % n else 0)]
                body += ((len(part) - 1).to_bytes(size_bytes, "little") if i < n - 1 else b"") + part
            payload = body
        out += obu(kind, payload)
    return avif_still(out, avif._ispe(data, *_primary(data)), av1c, depth=seq["bit_depth"], colr=colr)


def _sequence(enc, seeds, size=(32, 48), **kw) -> bytes:
    """PIL's image sequence (`save_all`) of photos of those seeds."""
    import io

    from PIL import Image

    frames = [Image.fromarray(enc.photo(*size, s)) for s in seeds]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], **kw)
    return buf.getvalue()


def _brands_without_avif(data: bytes) -> bytes:
    """The ftyp's compatible brand `avif` replaced by `mif1` (a brand
    libavif does not read as wanting a meta box)."""
    i = data.index(b"ftyp") + 4
    size = int.from_bytes(data[i - 8:i - 4], "big")
    head = data[i:i + size - 8]
    return data[:i] + head[:8] + head[8:].replace(b"avif", b"mif1") + data[i + size - 8:]


def _fixtures_avif_step6(enc, pil, Image) -> dict[str, bytes]:
    """AVIF step 6. Superres by header edits of OpenCV's stills encoded at
    the downscaled width (avif_superres): 8-bit 4:2:0 at an odd downscaled
    width with CDEF, 10-bit 4:4:4 with film grain, 12-bit 4:0:0, 10-bit
    4:2:0 with loop restoration (its units read on the upscaled geometry).
    The first shown frame of an item (avif_frames, key_frame_as): a hidden
    key frame with film grain shown by show_existing_frame; a hidden key
    frame then a shown intra-only frame; a shown frame followed by a second
    frame and a padding OBU. Sizes libavif scales: frames of another size
    than their ispe, up at 8 bits in 4:2:0 and down at 12 bits in 4:4:4;
    the premultiplied alpha of another size (moved from avif_raises/, its
    bytes unchanged); a limited-range premultiplied alpha
    (avif_alpha_limited). Image sequences: a track-only file (PIL's
    `save_all` with its meta stripped and no `avif` brand left), and an
    `avis` file whose primary item and first track sample differ (libavif
    reads the track)."""
    import torch_avif_oracle as oracle

    out = {}
    grain = {"film-grain-test": 1}
    out["avif_superres_420.avif"] = superres_still(enc, 77, 40, 12, 8, 3, 140)
    out["avif10_superres_444_grain.avif"] = superres_still(enc, 93, 64, 9, 10, 1, 141, options=grain)
    out["avif12_superres_400.avif"] = superres_still(enc, 96, 48, 16, 12, 4, 142)
    out["avif10_superres_420_lr.avif"] = superres_still(enc, 96, 96, 13, 10, 3, 40 + 13 + 10,
                                                        options={"enable-restoration": 1}, quality=30, speed=4)
    a = oracle.encode_hbd(enc.yuv_photo(48, 64, 143, 8, 3), 8, 3, single=False, options=grain)
    b = oracle.encode_hbd(enc.yuv_photo(48, 64, 144, 8, 3), 8, 3, single=False, options={"film-grain-test": 2})
    seq, key_a = frame_payload(a)
    key_b = frame_payload(b)[1]
    out["avif_hidden_key_shown.avif"] = avif_frames(a, [key_frame_as(key_a, seq, show_frame=0, refresh=0x04),
                                                        (show_existing_frame(2),)])
    c = oracle.encode_hbd(enc.yuv_photo(40, 48, 145, 10, 3), 10, 3, single=False)
    d = oracle.encode_hbd(enc.yuv_photo(40, 48, 146, 10, 3), 10, 3, single=False)
    seq10, key_c = frame_payload(c)
    out["avif10_hidden_key_intra_only.avif"] = avif_frames(c, [key_frame_as(key_c, seq10, show_frame=0, refresh=0x01),
                                                               key_frame_as(frame_payload(d)[1], seq10, frame_type=2,
                                                                            refresh=0x02)])
    out["avif_shown_then_more.avif"] = avif_frames(a, [key_a, key_b, (obu(15, bytes(5)),)])
    up = avif_parts(oracle.encode_hbd(enc.yuv_photo(40, 48, 147, 8, 3), 8, 3))
    out["avif_scaled_up_420.avif"] = enc.avif_still(up[0], (61, 37), up[1], colr=up[2])
    down = avif_parts(oracle.encode_hbd(enc.yuv_photo(64, 80, 148, 12, 1), 12, 1))
    out["avif12_scaled_down_444.avif"] = enc.avif_still(down[0], (57, 29), down[1], depth=12, colr=down[2])
    moved = "avif_prem_alpha_other_size.avif"  # from avif_raises/ (step 5), its bytes kept
    with open(os.path.join(OUT if os.path.exists(os.path.join(OUT, moved)) else AVIF_RAISES, moved), "rb") as f:
        out[moved] = f.read()
    rgba = Image.fromarray(enc.photo(40, 48, 149, 4), "RGBA")
    out["avif_prem_alpha_limited.avif"] = avif_alpha_limited(pil(rgba, "AVIF", alpha_premultiplied=True))
    out["avif_sequence_tracks_only.avif"] = _brands_without_avif(avif_meta_stripped(_sequence(enc, (150, 151))))
    item = avif_parts(pil(enc.photo(32, 48, 152), "AVIF"))[0]
    out["avif_sequence_item_differs.avif"] = avif_item_replaced(_sequence(enc, (153, 154)), item)
    return out


def panning(rgb: np.ndarray, h: int, w: int, n: int, step=(0.6, 1.3)) -> list:
    """n frames of h x w cut from `rgb` at (i * step) rows and columns for
    frame i, sampled bilinearly: sub-pixel motion on both axes."""
    a = rgb.astype(np.float64)
    out = []
    for i in range(n):
        y0, x0 = i * step[0], i * step[1]
        iy, ix = int(y0), int(x0)
        fy, fx = y0 - iy, x0 - ix
        img = (a[iy:iy + h, ix:ix + w] * (1 - fy) * (1 - fx) + a[iy + 1:iy + 1 + h, ix:ix + w] * fy * (1 - fx)
               + a[iy:iy + h, ix + 1:ix + 1 + w] * (1 - fy) * fx + a[iy + 1:iy + 1 + h, ix + 1:ix + 1 + w] * fy * fx)
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return out


def avif_inter_item(seq_file: bytes, samples: int = 1, shown_key: bool = False) -> bytes:
    """An AVIF step-7 item from an image sequence (torch_avif_oracle.
    encode_seq): the sequence's key frame made hidden and refreshing every
    slot (key_frame_as, as avif_inter_shown_first builds it), or kept shown
    with `shown_key`, then the track's next `samples` samples as coded."""
    seq, key = frame_payload(seq_file)
    first = key if shown_key else key_frame_as(key, seq, show_frame=0, refresh=0xFF)
    return avif_frames(seq_file, [first] + [(s,) for s in avif_track_samples(seq_file)[1:1 + samples]])


def inter_sequence(enc, w: int, h: int, depth: int, fmt: int, seed: int, n: int = 2, smooth: bool = False,
                   **kw) -> bytes:
    """An image sequence of n panning frames (`panning` over a photo, or
    slow colour waves where `smooth`) through OpenCV's libavif with the
    inter tools of AVIF steps 8 and 9 off (torch_avif_oracle.
    INTER_TOOLS_OFF, updated by `options`)."""
    import torch_avif_oracle as oracle

    src = (_smooth if smooth else enc.photo)(h + 2 * n + 2, w + 2 * n + 2, seed)
    frames = [enc.yuv_planes(f, depth, fmt, 1, seed) for f in panning(src, h, w, n)]
    options = {**oracle.INTER_TOOLS_OFF, **kw.pop("options", {})}
    return oracle.encode_seq(frames, depth, fmt, options=options, **kw)


# AVIF step 7's items: name -> (width, height, depth, layout, seed, frames,
# samples after the key frame, encode_seq's keywords)
STEP7 = {
    "avif_inter_420.avif": (64, 96, 8, 3, 700, 2, 1, {}),
    "avif_inter_444.avif": (64, 96, 8, 1, 701, 2, 1, {}),
    "avif_inter_422.avif": (64, 96, 8, 2, 702, 2, 1, {}),
    "avif_inter_400.avif": (64, 96, 8, 4, 703, 2, 1, {}),
    "avif10_inter_420.avif": (64, 96, 10, 3, 704, 2, 1, {}),
    "avif10_inter_444.avif": (64, 96, 10, 1, 705, 2, 1, {}),
    "avif12_inter_420.avif": (64, 96, 12, 3, 706, 2, 1, {}),
    "avif12_inter_444.avif": (64, 96, 12, 1, 707, 2, 1, {}),
    "avif_inter_128x160.avif": (128, 160, 8, 3, 708, 2, 1, {}),
    "avif_inter_50x70.avif": (50, 70, 8, 3, 709, 2, 1, {}),
    "avif10_inter_50x70_444.avif": (50, 70, 10, 1, 710, 2, 1, {}),
    "avif_inter_1024.avif": (1024, 1024, 8, 3, 711, 2, 1, {"quality": 40}),
    "avif_inter_speed0_420.avif": (64, 96, 8, 3, 712, 2, 1, {"speed": 0}),
    "avif12_inter_speed0_444.avif": (64, 96, 12, 1, 713, 2, 1, {"speed": 0}),
    "avif_inter_speed0_small_420.avif": (64, 96, 8, 3, 800, 2, 1, {"quality": 90, "speed": 0}),
    "avif10_inter_small_422.avif": (64, 96, 10, 2, 801, 2, 1, {"quality": 95, "speed": 2}),
    "avif_inter_arf_420.avif": (64, 96, 8, 3, 714, 4, 1, {}),
    "avif10_inter_arf_444.avif": (64, 96, 10, 1, 724, 4, 1, {}),
    "avif_inter_grain_420.avif": (64, 96, 8, 3, 716, 2, 1, {"options": {"film-grain-test": 1}}),
    "avif_inter_denoise_420.avif": (64, 96, 8, 3, 717, 2, 1, {"options": {"denoise-noise-level": 20}}),
}


def _fixtures_avif_step7(enc, pil, Image) -> dict[str, bytes]:
    """AVIF step 7: items of a hidden key frame and the inter frames of an
    image sequence after it (avif_inter_item over inter_sequence, STEP7):
    2 frames at speed 6 in every layout at 8 bits and in 4:2:0 and 4:4:4 at
    10 and 12, at 128 x 160, at an odd size (50 x 70: vectors past the
    frame's edge) and 1024 x 1024 (slow waves, quality 40); speed 0 (a
    per-block filter); inter blocks under 8 x 8, whose 4:2:0 and 4:2:2
    chroma predicts from each luma block's vector (quality 90 and 95);
    4 frames, the second sample (a hidden ALTREF frame,
    then the shown frame predicting from it and from the key frame); film
    grain (aom's test vector 1, and its denoiser's); and a shown key frame
    followed by an inter frame, which dav1d decodes and does not show."""
    out = {}
    for name, (w, h, depth, fmt, seed, n, samples, kw) in STEP7.items():
        out[name] = avif_inter_item(inter_sequence(enc, w, h, depth, fmt, seed, n, smooth=w >= 1024, **kw), samples)
    out["avif_inter_after_shown.avif"] = avif_inter_item(inter_sequence(enc, 64, 96, 8, 3, 718), shown_key=True)
    return out


def avif_raises_step7(enc) -> dict[str, tuple[bytes, str, str]]:
    """The inter tools AVIF steps 8 and 9 will decode, each in an item of
    aom's writing that PIL reads (the OBMC and global motion switches on
    in turn; a 4-frame sequence's third sample, whose frame is compound;
    a 4-frame sequence without ALTREF frames, whose fourth frame loads its
    CDFs from a reference), each after the frame shown -> name -> (bytes,
    exception class name, message pattern)."""
    unported = "NotImplementedError"
    four = inter_sequence(enc, 64, 96, 8, 3, 720, 4)
    no_arf = inter_sequence(enc, 64, 96, 8, 3, 723, 4, options={"auto-alt-ref": 0})
    return {
        "avif_inter_obmc.avif": (avif_inter_item(inter_sequence(enc, 64, 96, 8, 3, 721, options={"enable-obmc": 1})),
                                 unported, r"AV1 OBMC / local warped motion.*AVIF step 8.*ROADMAP A\.1"),
        "avif_inter_global_motion.avif": (
            avif_inter_item(inter_sequence(enc, 64, 96, 8, 3, 722, options={"enable-global-motion": 1})),
            unported, r"AV1 global motion.*AVIF step 8.*ROADMAP A\.1"),
        "avif_inter_compound.avif": (avif_inter_item(four, 2), unported,
                                     r"AV1 compound prediction.*AVIF step 9.*ROADMAP A\.1"),
        "avif_inter_loaded_cdfs.avif": (avif_inter_item(no_arf, 3), unported,
                                        r"AV1 CDFs loaded from a reference.*AVIF step 9.*ROADMAP A\.1"),
    }


def avif_raises(enc, pil, Image) -> dict[str, tuple[bytes, str, str]]:
    """AVIF files the port refuses: the inter tools of AVIF steps 8 and 9
    PIL reads (PIL's own sequence, its inter frame shown first after a
    hidden key frame, with motion-field projection; avif_raises_step7)
    raise NotImplementedError naming A.1 and the tool; the files PIL
    refuses fail as PIL's do (ROADMAP C.14: a HEIF
    brand without avif, a primary item of type hvc1, a file cut 40 bytes
    short; C.16: identity on 4:2:0 and matrix 10, which libavif does not
    convert; C.17: a good-quality still with show_existing_frame or an
    inter frame_type flipped in, no frame before it; a 2 x 2 grid with a
    cell missing; C.18: frame_type flipped to intra-only in 12-bit stills,
    whose symbol decoder then reads far past its tile, and a still cut a
    byte short in its tile; C.19: the same flip in an 8-bit still, which
    then reads its tile groups out of order; the sequence whose meta is
    stripped while its brands still say avif). -> name -> (bytes,
    exception class name, message pattern)."""
    import torch_avif_oracle as oracle

    base = pil(enc.photo(16, 16, 8), "AVIF")
    i = base.index(b"ftyp")
    size = int.from_bytes(base[i - 4:i], "big")
    body = b"mif1" + bytes(4) + b"heicmif1miafMA1B"
    heic = (8 + len(body)).to_bytes(4, "big") + b"ftyp" + body + base[i - 4 + size:]
    j = base.index(b"av01")
    good = oracle.encode_hbd(enc.yuv_photo(48, 64, 12, 8, 3), 8, 3, single=False)
    cells = [avif_parts(pil(enc.photo(64, 64, 13 + k), "AVIF")) for k in range(3)]
    flip = {depth_size: avif_frame_bit_flipped(oracle.encode_hbd(enc.yuv_photo(*depth_size[1], 20 + depth_size[0],
                                                                               depth_size[0], depth_size[2]),
                                                                depth_size[0], depth_size[2], single=False), 1)
            for depth_size in ((12, (96, 96), 1), (12, (128, 160), 3), (8, (128, 160), 3))}
    cut = oracle.encode_hbd(enc.yuv_photo(64, 64, 38, 8, 3), 8, 3, single=False)
    return {
        "avif_inter_shown_first.avif": (avif_inter_shown_first(enc, pil), "NotImplementedError",
                                        "AVIF of AV1 motion-field projection.*AVIF step 8.*ROADMAP A.1"),
        "avif_heic_brand.avif": (heic, "UnidentifiedImageError", "cannot identify image file"),
        "avif_hvc1_item.avif": (base[:j] + b"hvc1" + base[j + 4:], "DecodeError",
                                "Failed to decode image: Missing or empty image item"),
        "avif_truncated.avif": (base[:-40], "DecodeError", "Failed to decode frame 0: Truncated data"),
        "avif_identity_420.avif": (avif_colr(base, 1, 13, 0, 1), "DecodeError", REFORMAT_FAILED),
        "avif_matrix10.avif": (avif_colr(pil(enc.photo(16, 16, 9), "AVIF", subsampling="4:4:4"), 9, 16, 10, 1),
                               "DecodeError", REFORMAT_FAILED),
        "avif_show_existing_frame.avif": (avif_frame_bit_flipped(good, 0), "DecodeError", COLOR_FAILED),
        "avif_inter_frame.avif": (avif_frame_bit_flipped(good, 2), "DecodeError", COLOR_FAILED),
        "avif_grid_missing_cell.avif": (enc.avif_grid([c[0] for c in cells], 2, 2, 128, 128, (64, 64), cells[0][1]),
                                        "DecodeError", INVALID_GRID),
        "avif12_overread_444.avif": (flip[(12, (96, 96), 1)], "DecodeError", COLOR_FAILED),
        "avif12_overread_420.avif": (flip[(12, (128, 160), 3)], "DecodeError", COLOR_FAILED),
        "avif_tile_groups_flipped.avif": (flip[(8, (128, 160), 3)], "DecodeError", COLOR_FAILED),
        "avif_tile_cut.avif": (avif_tile_cut(cut, 1), "DecodeError", COLOR_FAILED),
        "avif_sequence_meta_stripped.avif": (avif_meta_stripped(open(os.path.join(OUT, "avif_sequence_32.avif"),
                                                                     "rb").read()),
                                             "UnidentifiedImageError", "cannot identify image file"),
        **avif_raises_step7(enc),
    }


def _fixtures_raster(enc, pil, Image) -> dict[str, bytes]:
    """One small file for each TIFF variant and raster format ported after
    the first set: ThunderScan, CCITT, old-style LZW, LZMA, ZSTD, old-style
    JPEG, YCbCr without JPEG, the float
    predictor, 12-bit grey, CIELAB, JPEG CMYK, tiled 16-bit planes and an
    orientation; BLP, FTEX, DCX, ICNS, SUN, XBM, XPM, MSP, IM, SPIDER,
    FITS, IPTC, PIXAR, McIdas, GBR, FLI / FLC, XV thumbnails, IMT, PIL's
    Netpbm test modes and a CIELAB PSD (PhotoCD's 0.8 MB base image is
    generated in the tests instead)."""
    rng = np.random.default_rng(19)
    out = {}
    ph = enc.photo(23, 29, 3)
    ph4 = enc.photo(23, 29, 4, 4)
    grey = ph[..., 0]
    idx = rng.integers(0, 16, (23, 29))
    idx[6:9] = idx[6]
    ink = Image.fromarray(enc.photo(37, 45, 5)).convert("1")
    out["tiff_g3_2d.tif"] = pil(ink, "TIFF", compression="group3", tiffinfo={292: 1})
    out["tiff_g4_fill2.tif"] = pil(ink, "TIFF", compression="group4", tiffinfo={266: 2})
    out["tiff_ccitt_rle.tif"] = pil(ink, "TIFF", compression="tiff_ccitt")
    out["tiff_rlew.tif"] = pil(ink, "TIFF", compression="tiff_raw_16")
    out["tiff_thunderscan.tif"] = enc.tiff_file((grey[..., None] // 16).astype(np.uint8), 4, 1, ">", 32809,
                                                rows_per_strip=8)
    out["tiff_old_lzw.tif"] = enc.tiff_file(ph, 8, 2, "<", 5, old_lzw=True, rows_per_strip=8)
    f = grey[..., None].astype(np.float32) * 1.4 - 40
    f[0, :3, 0] = [np.nan, np.inf, -np.inf]
    out["tiff_float_pred3_mm.tif"] = enc.tiff_file(f, 32, 1, ">", 8, predictor=3, sample_format=3, rows_per_strip=8)
    v12 = rng.integers(0, 300, (23, 29)).astype(np.int64)
    bits12 = ((v12[..., None] >> np.arange(11, -1, -1)) & 1).reshape(23, -1).astype(np.uint8)
    out["tiff_i12.tif"] = enc.tiff_raw_strip(np.packbits(bits12, axis=1).tobytes(), 29, 23, 12, 1)
    lab = rng.integers(0, 256, (23, 29, 3), dtype=np.uint8)
    lab[8:12] = lab[8]
    out["tiff_lab_lzw.tif"] = enc.tiff_file(lab, 8, 8, "<", 5, predictor=2, rows_per_strip=8)
    out["tiff_cmyk_jpeg.tif"] = pil(Image.fromarray(ph4, "CMYK"), "TIFF", compression="jpeg", quality=80)
    s16 = ph.astype(np.uint16) * 251 + rng.integers(0, 251, ph.shape).astype(np.uint16)
    out["tiff_tiles16_planar_mm.tif"] = enc.tiff_file(s16, 16, 2, ">", 1, planar=2, tile=(16, 16))
    out["tiff_orient7_lzma.tif"] = enc.tiff_file(ph, 8, 2, "<", 34925, rows_per_strip=8, extra_tags={274: (3, [7])})
    out["tiff_zstd_predictor.tif"] = pil(ph, "TIFF", compression="zstd", tiffinfo={317: 2, 278: 8})
    out["tiff_ojpeg_split.tif"] = enc.ojpeg_tiff(pil(ph, "JPEG", quality=85), 23, 29, split=True)
    out["tiff_ojpeg_tables_mm.tif"] = enc.ojpeg_tables_tiff(pil(ph, "JPEG", quality=70, subsampling=2), 23, 29, ">")
    out["tiff_ycbcr22_deflate.tif"] = enc.ycbcr_tiff(lab, (2, 2), 8, 8)
    out["psd_lab_rle.psd"] = enc.psd_file([lab[..., c] for c in range(3)], 9, 8, 1)
    jp = pil(ph, "JPEG", quality=85)
    out["blp1_jpeg.blp"] = enc.blp1_jpeg(jp, 29, 23)
    out["blp2_dxt5.blp"] = enc.blp2_file(29, 23, rng.integers(0, 256, 6 * 8 * 16, dtype=np.uint8).tobytes(), 2, 7, 1)
    out["blp2_palette.blp"] = pil(Image.fromarray(ph).convert("P"), "BLP")
    out["ftex_dxt1.ftc"] = enc.ftex_file(29, 23, 0, rng.integers(0, 256, 6 * 8 * 8, dtype=np.uint8).tobytes())
    out["dcx_two.dcx"] = enc.dcx_file([pil(ph, "PCX", "P"), pil(enc.photo(5, 7, 6), "PCX")])
    sq = enc.photo(16, 16, 7)
    out["icns_rle24.icns"] = enc.icns_file([(b"is32", enc.icns_rle24(sq)), (b"s8mk", bytes(range(256)))])
    out["sun_rle_palette.ras"] = enc.sun_file(idx.astype(np.uint8), 8, 2, cmap=rng.integers(0, 256, (12, 3)))
    out["sun_rgbx_type3.ras"] = enc.sun_file(ph4, 32, 3)
    out["xbm_pil.xbm"] = pil(ink, "XBM")
    out["xpm_two_chars.xpm"] = enc.xpm_file(rng.integers(0, 69, (11, 13)),
                                            [b"#%06X" % rng.integers(0, 1 << 24) for _ in range(70)], 2, none=69)
    out["msp_v2_rle.msp"] = enc.msp_rle(np.asarray(ink).astype(np.uint8))
    out["im_palette.im"] = pil(Image.fromarray(ph).convert("P"), "IM")
    out["im_ycc.im"] = pil(Image.fromarray(ph).convert("YCbCr"), "IM")
    out["spider_float.spi"] = pil(Image.fromarray(grey.astype(np.float32) * 1.3 - 25), "SPIDER")
    out["fits_bitpix16.fits"] = enc.fits_file(grey.astype(np.int64) * 3 - 60, 16)
    out["fits_gzip8.fits"] = enc.fits_gzip(grey.astype(np.int64), 8)
    out["iptc_rgb_band.iim"] = enc.iptc_file(grey, 3, 1, band=2, split=2)
    out["pixar.pxr"] = enc.pixar_file(ph)
    out["mcidas_16bit.area"] = enc.mcidas_file(grey.astype(np.int64) * 2, 2, 4)
    out["gbr_v2_rgba.gbr"] = enc.gbr_file(ph4)
    out["xvthumb.xv"] = enc.xvthumb_file(rng.integers(0, 256, (23, 29)))
    out["imt_grey.imt"] = enc.imt_file(grey)
    fimg = (idx * 15).astype(np.uint8)
    fimg[:, 20:] = 0
    out["fli_lc_color64.flc"] = enc.fli_file(29, 23, [enc.fli_color(rng.integers(0, 64, (256, 3)), True),
                                                      enc.fli_lc(fimg, 3)])
    out["fli_brun.fli"] = enc.fli_file(29, 23, [enc.fli_color(rng.integers(0, 256, (256, 3))), enc.fli_brun(fimg)],
                                       magic=0xAF11)
    out["pnm_pycmyk.pnm"] = b"PyCMYK 29 23 200\n" + rng.integers(0, 201, 23 * 29 * 4, dtype=np.uint8).tobytes()
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, REPO)
    from torch_codec_encoders import pil_rgb

    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, data in _fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        group = "loft_lossless" if name in LOSSLESS.values() else "loft_lossy" if name in LOSSY.values() \
            else "loft_lossless2" if name in LOSSLESS2.values() else "loft_lossless3" if name in LOSSLESS3.values() \
            else "loft_lossy2" if name in LOSSY2.values() else "loft_lossy3" if name in LOSSY3.values() \
            else "variant"
        manifest[name] = {"group": group, "bytes": len(data), **digest(pil_rgb(data))}
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} fixtures, {sum(m['bytes'] for m in manifest.values())} bytes")
    import torch_codec_encoders as enc
    from PIL import Image

    os.makedirs(AVIF_RAISES, exist_ok=True)
    for name in os.listdir(AVIF_RAISES):
        os.remove(os.path.join(AVIF_RAISES, name))
    expected = {}
    for name, (data, exc, pattern) in avif_raises(enc, enc.pil_bytes, Image).items():
        with open(os.path.join(AVIF_RAISES, name), "wb") as f:
            f.write(data)
        expected[name] = {"raises": exc, "match": pattern, "bytes": len(data)}
    with open(AVIF_RAISES_EXPECTED, "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
