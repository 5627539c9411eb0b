"""Port parity, codecs/webp.py, vp8l.py, vp8.py and webp_yuv.py against
PIL's `convert("RGB")` (libwebp's WebPAnimDecoder) and the JAX package's
`load_image`, bit for bit.

Lossless: images that drive each VP8L tool (colour indexing at 1, 2, 4 and
8 bits a pixel, the predictor and cross-colour transforms, LZ77 copies and
the colour cache, meta prefix codes) at every encoder method. Lossy: VP8
key frames at qualities 0-100 and every method (segments, both loop
filters' strengths, 4x4 and 16x16 modes, skipped macroblocks), odd sizes
for the fancy upsampler's edges, with and without an ALPH chunk. Fully
transparent pixels keep their colour (PIL's RGB is not premultiplied).
Animations: frame 0, also smaller than the canvas and offset in it. The
header options libwebp's encoder does not vary here (the simple loop
filter, sharpness, two to eight token partitions, segment maps with
absolute or delta values, filter deltas, quantiser deltas, probability
updates, no skip flag, the extra-bit categories) come from a VP8 writer in
tests/torch_codec_encoders.py: key frames of random modes and levels.
"""
import numpy as np
import pytest

from torch_codec_encoders import assert_like_pil, photo, pil_bytes, pil_rgb, vp8_frame, webp_animation, webp_vp8
from optixpathtracer_tpu_torch.io import image as timg


def _rgba(h, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if kind == "palette":
        pal = rng.integers(0, 256, (int(rng.integers(2, 200)), 4), dtype=np.uint8)
        return pal[rng.integers(0, len(pal), (h, w))]
    if kind == "smooth":
        y, x = np.mgrid[0:h, 0:w]
        return np.stack([x * 5 % 256, y * 7 % 256, (x + y) * 3 % 256, np.full_like(x, 255)], -1).astype(np.uint8)
    if kind == "tiles":
        return np.tile(rng.integers(0, 256, (4, 5, 4), dtype=np.uint8), (h // 4 + 1, w // 5 + 1, 1))[:h, :w]
    img = photo(h, w, seed, 4)
    img[..., 3] = 255
    return img


@pytest.mark.parametrize("kind", ["noise", "palette", "smooth", "tiles", "photo"])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossless(tmp_path, kind, method):
    from PIL import Image

    img = _rgba(23, 37, method, kind)
    data = pil_bytes(Image.fromarray(img, "RGBA"), "WEBP", lossless=True, method=method, quality=100, exact=True)
    np.testing.assert_array_equal(assert_like_pil(data, tmp_path, "l.webp"), img[..., :3])


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 256])
def test_lossless_colour_indexing_packing(colours):
    from PIL import Image

    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4), dtype=np.uint8)
    img = pal[rng.integers(0, colours, (13, 29))]
    assert_like_pil(pil_bytes(Image.fromarray(img, "RGBA"), "WEBP", lossless=True, exact=True))


@pytest.mark.parametrize("quality", [0, 30, 75, 100])
@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("size", [(37, 53), (16, 16), (1, 9)])
def test_lossy(tmp_path, quality, method, size):
    data = pil_bytes(photo(*size, quality + method), "WEBP", quality=quality, method=method)
    assert_like_pil(data, tmp_path, "y.webp")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("lossless", [False, True])
def test_alpha_keeps_the_colour_of_transparent_pixels(exact, lossless):
    from PIL import Image

    img = photo(20, 24, 9, 4)
    img[:8, ..., 3] = 0
    img[8:, :6, 3] = 100
    data = pil_bytes(Image.fromarray(img, "RGBA"), "WEBP", lossless=lossless, exact=exact, quality=90)
    got = assert_like_pil(data)
    if exact and lossless:
        np.testing.assert_array_equal(got[:8], img[:8, ..., :3])  # zero alpha, colour intact


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_frame_zero_offset_in_its_canvas(tmp_path, lossless):
    frames = [pil_bytes(photo(10, 14, s), "WEBP", lossless=lossless, quality=80) for s in range(2)]
    data = webp_animation((30, 21), [(frames[0], 6, 4, 14, 10), (frames[1], 0, 0, 14, 10)])
    got = assert_like_pil(data, tmp_path, "a.webp")
    assert got.shape == (21, 30, 3) and not got[:4].any()  # the canvas outside frame 0 is black
    from PIL import Image

    imgs = [Image.fromarray(photo(12, 16, s)) for s in range(3)]
    data = pil_bytes(imgs[0], "WEBP", save_all=True, append_images=imgs[1:], lossless=lossless, duration=50)
    assert_like_pil(data)


def test_vp8x_still_with_icc_and_exif():
    from PIL import Image

    img = Image.fromarray(photo(11, 19, 4))
    data = pil_bytes(img, "WEBP", quality=60, icc_profile=b"\0" * 64, exif=b"Exif\0\0" + bytes(20))
    assert data[12:16] == b"VP8X"
    assert_like_pil(data)
    np.testing.assert_array_equal(timg.rgb8_from_bytes(data), pil_rgb(data))


VP8_OPTIONS = {
    "simple filter": dict(simple=1, level=30),
    "normal filter, sharpness": dict(level=45, sharpness=6),
    "no filter": dict(level=0),
    "two partitions": dict(log2_parts=1),
    "eight partitions": dict(log2_parts=3, level=12, simple=1),
    "segment map, deltas": dict(segments=(1, 0, [0, 12, -9, 30], [0, 6, -4, 15], [90, 160, 220])),
    "segments absolute, no map": dict(segments=(0, 1, [10, 45, 80, 127], [5, 20, 40, 63], [255, 255, 255])),
    "filter deltas": dict(lf_delta=([7, 0, 0, 0], [-5, 0, 0, 0]), sharpness=2),
    "quantiser deltas": dict(quant=(60, 4, -7, 9, -15, 15)),
    "probability updates": dict(prob_updates=0.08),
    "no skip flag": dict(use_skip=False),
    "extra-bit categories": dict(big=0.08, big_max=60, quant=(6, 0, 0, 0, 0, 0)),
}


@pytest.mark.parametrize("option", list(VP8_OPTIONS))
@pytest.mark.parametrize("size", [(45, 37), (16, 16)])
def test_vp8_header_options(option, size):
    rng = np.random.default_rng(len(option) + size[0])
    for _ in range(2):
        assert_like_pil(webp_vp8(vp8_frame(*size, rng, **VP8_OPTIONS[option])))
