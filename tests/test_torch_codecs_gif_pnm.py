"""Port parity, codecs/gif.py (with codecs/lzw.py) and codecs/pnm.py
against PIL's `convert("RGB")` and the JAX package's `load_image`, bit for
bit.

GIF from a writer in tests/torch_codec_encoders.py: global and local
palettes of 2-256 entries (a grey ramp makes PIL read indices as grey),
interlacing, a transparency index, LZW code sizes 2-8 with clear codes and
the full 4096-entry table, frame 0 smaller than the logical screen and
offset in it (the rest index 0, or the transparency index), a second
frame that is not read; and PIL's own GIFs. Netpbm P1-P6 with comments,
maxval 1-65535 (PIL's rounding, mode I clamping), greyscale PFM; P7 is no
format PIL reads.
"""
import numpy as np
import pytest

from torch_codec_encoders import assert_fails_like_pil, assert_like_pil, gif_file, photo, pil_bytes


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
@pytest.mark.parametrize("local,interlace,transparency", [(False, False, None), (True, True, 1), (False, True, 0),
                                                          (True, False, 3)])
def test_gif(tmp_path, colours, local, interlace, transparency):
    rng = np.random.default_rng(colours)
    frame = rng.integers(0, colours, (19, 23))
    frame[5:9] = frame[5]
    palette = rng.integers(0, 256, (colours, 3))
    data = gif_file(frame, palette, (30, 26), at=(3, 2), local=local, interlace=interlace,
                    transparency=transparency, clear_every=97)
    assert_like_pil(data, tmp_path, "g.gif")


def test_gif_full_table_grey_ramp_and_second_frame():
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (120, 120))  # noise fills the 4096-entry table without clears
    assert_like_pil(gif_file(frame, rng.integers(0, 256, (256, 3)), (120, 120)))
    ramp = np.repeat(np.arange(16)[:, None], 3, 1)
    data = gif_file(rng.integers(0, 20, (9, 9)), ramp, (12, 10), at=(1, 1), code_size=5)  # past the ramp: grey
    assert_like_pil(data)
    two = data[:-1] + b",\x00\x00\x00\x00\x01\x00\x01\x00\x00\x02\x02\x4c\x01\x00;"
    assert_like_pil(two)


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
@pytest.mark.parametrize("interlace", [False, True])
def test_gif_written_by_pil(tmp_path, mode, interlace):
    assert_like_pil(pil_bytes(photo(31, 17, 3), "GIF", mode, interlace=interlace), tmp_path, "p.gif")


def _ws(rng):
    return [b" ", b"\n", b"\t", b"  ", b"\r\n", b" #c x\n", b"\n# a comment 12\n"][int(rng.integers(7))]


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("maxval", [1, 3, 100, 255, 256, 1000, 65535])
def test_pnm(tmp_path, kind, maxval):
    rng = np.random.default_rng(kind * 7 + maxval)
    h, w = 5, 7
    bands = 3 if kind in (3, 6) else 1
    head = b"P%d" % kind + _ws(rng) + b"%d" % w + _ws(rng) + b"%d" % h
    if kind not in (1, 4):
        head += _ws(rng) + b"%d" % maxval
    head += b"\n"
    if kind == 1:
        body = b" ".join(b"%d" % v for v in rng.integers(0, 2, w * h))
    elif kind == 4:
        body = rng.integers(0, 256, ((w + 7) // 8) * h, dtype=np.uint8).tobytes()
    else:
        vals = rng.integers(0, maxval + 1, w * h * bands)
        vals[:2] = [maxval, maxval // 2]
        if kind in (2, 3):
            body = b" ".join(b"%d" % v for v in vals).replace(b" ", b" # x\n", 2) + b"\n"
        else:
            body = vals.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    assert_like_pil(head + body, tmp_path, "n.pnm")


def test_pnm_scaling_pinned_and_pfm():
    """PIL's scaling, measured on PIL 12.1.0: maxval 100 reads 50 as 128 and
    99 as 252; 16-bit grey is mode I, clamped to 255."""
    for value, want in ((50, 128), (99, 252)):
        np.testing.assert_array_equal(assert_like_pil(b"P5 1 1 100\n" + bytes([value]))[0, 0], [want] * 3)
    grey16 = b"P5 3 1 65535\n" + np.array([0, 255, 256], ">u2").tobytes()
    np.testing.assert_array_equal(assert_like_pil(grey16)[0, :, 0], [0, 255, 255])
    f = np.array([[np.nan, 254.9, -3.0], [300.0, 17.5, 0.4]], np.float32)
    for scale, dt in ((b"-1.0", "<f4"), (b"1.0", ">f4")):
        assert_like_pil(b"Pf\n3 2\n" + scale + b"\n" + f.astype(dt).tobytes())
    assert_fails_like_pil(b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n\x00")


@pytest.mark.parametrize("mode", ["1", "L", "RGB", "I"])
def test_pnm_written_by_pil(tmp_path, mode):
    img = photo(9, 11, 5)
    assert_like_pil(pil_bytes(img, "PPM", mode), tmp_path, "w.pnm")
