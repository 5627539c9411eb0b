"""The AVIF reference of the tests: PIL's bundled libavif (dav1d inside)
through ctypes, where PIL ships it, and OpenCV's bundled libavif (aom
inside, built for high bit depth) as the writer of 10- and 12-bit stills.

- `planes(data)`: `avifDecoderReadMemory`'s Y / U / V planes (each of
  its own size: 4:2:0, 4:2:2, 4:4:4; Y alone for 4:0:0; uint8 at depth 8,
  uint16 above) and (width, height, depth, yuvFormat, yuvRange) - dav1d's
  decode before any colour conversion; `alpha(data)` the alpha plane (None
  without one) and whether libavif marks it premultiplied.
- `yuv_to_rgb(template, y, u, v, matrix, full, alpha=None, premultiplied=0,
  primaries=None)`: `avifImageYUVToRGB` with PIL's settings (RGB, or RGBA
  where an alpha plane is given, as PIL asks for an image with alpha;
  depth 8, automatic chroma upsampling) on planes of our own, under the
  given nclx colour primaries (which matrix 12 derives from), written into an image decoded
  from `template` (an AVIF of the same size and layout, so that libavif
  owns the buffers) or made by `avifImageCreate` where `template` is
  (width, height, depth, yuvFormat) -> the RGB channels (and alpha, with
  `rgba=True`).
- `unpremultiply(rgba)`: `avifRGBImageUnpremultiplyAlpha` on 8-bit RGBA.
- `encode(y, grid)`: libavif's own encoder, for the `grid` stills PIL's
  save does not write.
- `encode_seq(frames, depth, yuv_format, speed, quality, options)`: an
  image sequence of those frames through the same encoder (aom's
  good-quality usage, inter frames after the first); `INTER_TOOLS_OFF`
  the codec-specific options that keep aom's inter frames to single
  references and translational motion.
- `encode_hbd(planes, depth, yuv_format, ...)`: OpenCV's libavif 1.4
  encoder (aom 3.14 inside) on planes of our own at any depth and layout,
  with alpha straight or premultiplied, either range, aom's speed and
  quality, tiles and codec-specific options (`enable-cdef`, `aq-mode`,
  ...): the 10- and 12-bit stills PIL's aom does not write; with
  `single=False` aom's good-quality usage (AV1 segmentation under
  `aq-mode` 1), with `grid=(rows, cols)` a grid image (the switches'
  effects: its docstring). `hbd_available()` is False where OpenCV ships
  no libavif.

The offsets are those of libavif's `avifImage`, the same in 1.3 and 1.4
(soname 16; width, height, depth, yuvFormat (1 4:4:4, 2 4:2:2, 3 4:2:0,
4 4:0:0), yuvRange, chroma position; yuvPlanes at 24, yuvRowBytes at 48;
alphaPlane at 64, alphaRowBytes at 72, alphaPremultiplied at 80;
colorPrimaries / transferCharacteristics / matrixCoefficients as uint16 at
104 / 106 / 108), `avifRGBImage` (depth at 8, format at 12 (0 RGB, 1
RGBA), alphaPremultiplied at 32, pixels at 48, rowBytes at 56) and 1.4's
`avifEncoder` (speed at 8, quality and qualityAlpha at 32 and 36,
tileRowsLog2 and tileColsLog2 at 56 and 60; a new encoder reads maxThreads
1, speed -1, timescale 1, quality -1, maxQuantizer 63 there, which
`encode_hbd` checks). `available()` is False where PIL ships no libavif.
"""
from __future__ import annotations

import ctypes
import glob
import os
import struct

import numpy as np

_LIB = None


def library_path() -> str | None:
    try:
        import PIL
    except ImportError:
        return None
    libs = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs",
                                         "libavif*.so*")))
    return libs[0] if libs else None


def available() -> bool:
    return library_path() is not None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(library_path())
        lib.avifDecoderCreate.restype = ctypes.c_void_p
        lib.avifImageCreateEmpty.restype = ctypes.c_void_p
        lib.avifDecoderReadMemory.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.avifDecoderDestroy.argtypes = [ctypes.c_void_p]
        lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
        lib.avifRGBImageSetDefaults.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.avifRGBImageAllocatePixels.argtypes = [ctypes.c_void_p]
        lib.avifRGBImageFreePixels.argtypes = [ctypes.c_void_p]
        lib.avifImageYUVToRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.avifRGBImageUnpremultiplyAlpha.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _read(data: bytes):
    lib = _lib()
    dec, im = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    rc = lib.avifDecoderReadMemory(dec, im, data, len(data))
    lib.avifDecoderDestroy(dec)
    if rc != 0:
        lib.avifImageDestroy(im)
        raise RuntimeError(f"avifDecoderReadMemory failed: {rc}")
    return im


# yuvFormat -> (subsampling x, y), None for 4:0:0
SUBSAMPLING = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: None}


def _view(ptr: int, stride: int, h: int, w: int, depth: int = 8) -> np.ndarray:
    """A plane of `stride` bytes a row: uint8 samples at depth 8, uint16 above."""
    dtype = np.uint8 if depth <= 8 else np.uint16
    buf = (ctypes.c_uint8 * (stride * h)).from_address(ptr)
    return np.frombuffer(buf, dtype).reshape(h, stride // dtype().itemsize)[:, :w]


def _plane_views(im):
    w, h, depth, fmt, rng, _ = (ctypes.c_uint32 * 6).from_address(im)
    ptrs = (ctypes.c_void_p * 3).from_address(im + 24)
    strides = (ctypes.c_uint32 * 3).from_address(im + 48)
    dims = [(h, w)]
    if SUBSAMPLING[fmt] is not None:
        sx, sy = SUBSAMPLING[fmt]
        dims += [((h + sy) >> sy, (w + sx) >> sx)] * 2
    views = [_view(ptrs[p], strides[p], *dims[p], depth) for p in range(len(dims))]
    return (w, h, depth, fmt, rng), views


def _alpha_view(im):
    w, h, depth = (ctypes.c_uint32 * 3).from_address(im)
    ptr = ctypes.c_void_p.from_address(im + 64).value
    if not ptr:
        return None
    return _view(ptr, ctypes.c_uint32.from_address(im + 72).value, h, w, depth)


def planes(data: bytes):
    """-> ((width, height, depth, yuvFormat, yuvRange), [Y, U, V])."""
    im = _read(data)
    try:
        info, views = _plane_views(im)
        return info, [v.copy() for v in views]
    finally:
        _lib().avifImageDestroy(im)


def alpha(data: bytes):
    """-> (the alpha plane or None, alphaPremultiplied)."""
    im = _read(data)
    try:
        view = _alpha_view(im)
        return (None if view is None else view.copy()), ctypes.c_uint32.from_address(im + 80).value
    finally:
        _lib().avifImageDestroy(im)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """libavif's un-premultiply of an (H, W, 4) uint8 RGBA image."""
    h, w, _ = rgba.shape
    px = np.ascontiguousarray(rgba, np.uint8).copy()
    rgb = (ctypes.c_uint8 * 256)()
    struct.pack_into("<IIII", rgb, 0, w, h, 8, 1)  # width, height, depth, AVIF_RGB_FORMAT_RGBA
    struct.pack_into("<I", rgb, 32, 1)  # alphaPremultiplied
    struct.pack_into("<Q", rgb, 48, px.ctypes.data)
    struct.pack_into("<I", rgb, 56, w * 4)
    if _lib().avifRGBImageUnpremultiplyAlpha(ctypes.addressof(rgb)) != 0:
        raise RuntimeError("avifRGBImageUnpremultiplyAlpha failed")
    return px


def _create(lib, w: int, h: int, depth: int, fmt: int, with_alpha: bool):
    """A new avifImage of that size, depth and layout with its planes."""
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    im = lib.avifImageCreate(w, h, depth, fmt)
    if lib.avifImageAllocatePlanes(im, 3 if with_alpha else 1) != 0:  # AVIF_PLANES_YUV (| AVIF_PLANES_A)
        lib.avifImageDestroy(im)
        raise RuntimeError("avifImageAllocatePlanes failed")
    return im


def yuv_to_rgb(template, y: np.ndarray, u, v, matrix: int, full: int, alpha=None,
               premultiplied: int = 0, rgba: bool = False, primaries: int | None = None) -> np.ndarray:
    lib = _lib()
    im = _read(template) if isinstance(template, bytes) else _create(lib, *template, alpha is not None)
    try:
        (w, h, _, _, _), views = _plane_views(im)
        for view, plane in zip(views, (y, u, v)):
            view[...] = plane
        if alpha is not None:
            _alpha_view(im)[...] = alpha
            struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 80), 0, premultiplied)
        struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 16), 0, int(bool(full)))
        struct.pack_into("<H", (ctypes.c_uint8 * 2).from_address(im + 108), 0, matrix)
        if primaries is not None:
            struct.pack_into("<H", (ctypes.c_uint8 * 2).from_address(im + 104), 0, primaries)
        rgb = (ctypes.c_uint8 * 256)()
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), im)
        channels = 3 if alpha is None else 4
        struct.pack_into("<II", rgb, 8, 8, channels - 3)  # depth 8, as PIL asks; AVIF_RGB_FORMAT_RGB / RGBA
        if lib.avifRGBImageAllocatePixels(ctypes.addressof(rgb)) != 0:
            raise RuntimeError("avifRGBImageAllocatePixels failed")
        try:
            if lib.avifImageYUVToRGB(im, ctypes.addressof(rgb)) != 0:
                raise RuntimeError("avifImageYUVToRGB failed")
            ptr, = struct.unpack_from("<Q", rgb, 48)
            row_bytes, = struct.unpack_from("<I", rgb, 56)
            px = np.frombuffer((ctypes.c_uint8 * (row_bytes * h)).from_address(ptr), np.uint8)
            out = px.reshape(h, row_bytes)[:, :w * channels].reshape(h, w, channels)
            return (out if rgba else out[..., :3]).copy()
        finally:
            lib.avifRGBImageFreePixels(ctypes.addressof(rgb))
    finally:
        lib.avifImageDestroy(im)



def encode(y: np.ndarray, grid: tuple[int, int] = (1, 1)) -> bytes:
    """An 8-bit 4:2:0 still AVIF written by the bundled libavif's own encoder
    (aom inside, libavif's default settings) from a luma plane `y`, chroma at
    mid grey, as a `grid` of rows x cols cells of y's size (each cell y
    rolled by its index; cells of 64 x 64 and more, as libavif wants),
    through `avifEncoderAddImageGrid`: what PIL's save cannot write. (The
    bundled aom writes no 10 / 12-bit AV1: `encode_hbd` does.)"""
    lib = _lib()
    lib.avifEncoderCreate.restype = ctypes.c_void_p
    lib.avifEncoderDestroy.argtypes = [ctypes.c_void_p]
    lib.avifEncoderAddImage.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.avifEncoderAddImageGrid.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                                            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    lib.avifEncoderFinish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.avifRWDataFree.argtypes = [ctypes.c_void_p]
    h, w = y.shape
    rows, cols = grid
    cells = []
    for k in range(rows * cols):
        im = _create(lib, w, h, 8, 3, False)  # AVIF_PIXEL_FORMAT_YUV420
        cells.append(im)
        _, views = _plane_views(im)
        for p, view in enumerate(views):
            view[...] = np.roll(y, k, 1) if p == 0 else 128
    enc = lib.avifEncoderCreate()
    out = (ctypes.c_uint8 * 16)()  # avifRWData: data, size
    try:
        if len(cells) == 1:
            rc = lib.avifEncoderAddImage(enc, cells[0], 1, 2)  # AVIF_ADD_IMAGE_FLAG_SINGLE
        else:
            rc = lib.avifEncoderAddImageGrid(enc, cols, rows, (ctypes.c_void_p * len(cells))(*cells), 2)
        if rc != 0 or lib.avifEncoderFinish(enc, ctypes.addressof(out)) != 0:
            raise RuntimeError(f"avifEncoder failed: {rc}")
        ptr, size = struct.unpack_from("<QQ", out)
        data = bytes((ctypes.c_uint8 * size).from_address(ptr))
        lib.avifRWDataFree(ctypes.addressof(out))
        return data
    finally:
        lib.avifEncoderDestroy(enc)
        for im in cells:
            lib.avifImageDestroy(im)


_HBD = None


def hbd_library_path() -> str | None:
    """OpenCV's bundled libavif, or None."""
    try:
        import cv2
    except ImportError:
        return None
    libs = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs",
                                         "libavif*.so*")))
    return libs[0] if libs else None


def hbd_available() -> bool:
    return hbd_library_path() is not None


def _hbd_lib():
    global _HBD
    if _HBD is None:
        lib = ctypes.CDLL(hbd_library_path())
        lib.avifImageCreate.restype = ctypes.c_void_p
        lib.avifImageCreate.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
        lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
        lib.avifEncoderCreate.restype = ctypes.c_void_p
        lib.avifEncoderDestroy.argtypes = [ctypes.c_void_p]
        lib.avifEncoderAddImage.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
        lib.avifEncoderAddImageGrid.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                                                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        lib.avifEncoderFinish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.avifEncoderSetCodecSpecificOption.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.avifRWDataFree.argtypes = [ctypes.c_void_p]
        _HBD = lib
    return _HBD


def encode_hbd(planes, depth: int, yuv_format: int, full: int = 1, alpha=None, premultiplied: bool = False,
               speed: int = 6, quality: int = 60, options: dict | None = None, matrix: int = 6,
               tiles_log2: tuple[int, int] = (0, 0), single: bool = True, grid: tuple[int, int] = (1, 1)) -> bytes:
    """A still AVIF from our own planes through OpenCV's libavif 1.4 (aom
    3.14): `planes` [Y] or [Y, U, V] of the layout's sizes (uint16 at depth
    10 / 12), `yuv_format` 1-4 (4:4:4, 4:2:2, 4:2:0, 4:0:0), `full` range,
    an `alpha` plane of the depth (stored premultiplied where asked: a
    `prem` reference), aom's `speed` and `quality` (colour and alpha),
    (rows, cols) tiles as log2, codec-specific `options` and the nclx
    matrix (primaries BT.709, transfer sRGB). Quantizer matrices and delta
    q, which libavif 1.4 turns on for aom, stay off unless `options` asks
    for them (`enable-qm`, `deltaq-mode`).

    `single` keeps AVIF_ADD_IMAGE_FLAG_SINGLE, with which libavif runs aom
    in its all-intra usage; `single=False` adds the image without it, and
    aom runs in its good-quality usage, which writes a full sequence header
    (not the reduced still-picture one) and, with `options={"aq-mode": 1}`
    (variance AQ), AV1 segmentation: SEG_LVL_ALT_Q on a few segments (at
    speeds up to 6; none at 8). `grid` = (rows, cols) cuts the planes (and
    alpha) into that many equal cells, each at least 64 x 64 and even where
    chroma is subsampled, and writes them through
    `avifEncoderAddImageGrid`: a `grid` item of av01 cells (an alpha grid
    beside it), whose output size is the planes'."""
    lib = _hbd_lib()
    h, w = planes[0].shape
    rows, cols = grid
    assert h % rows == 0 and w % cols == 0, "the planes split into equal cells"
    ch, cw = h // rows, w // cols
    sx, sy = SUBSAMPLING[yuv_format] or (0, 0)
    cells = []
    enc = lib.avifEncoderCreate()
    out = (ctypes.c_uint8 * 16)()  # avifRWData: data, size
    try:
        for r in range(rows):
            for c in range(cols):
                im = _create(lib, cw, ch, depth, yuv_format, alpha is not None)
                cells.append(im)
                struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 16), 0, int(bool(full)))
                struct.pack_into("<3H", (ctypes.c_uint8 * 6).from_address(im + 104), 0, 1, 13, matrix)
                _, views = _plane_views(im)
                for p, (view, plane) in enumerate(zip(views, planes)):
                    ssx, ssy = (sx, sy) if p else (0, 0)
                    view[...] = plane[(r * ch + ssy) >> ssy:((r + 1) * ch + ssy) >> ssy,
                                      (c * cw + ssx) >> ssx:((c + 1) * cw + ssx) >> ssx]
                if alpha is not None:
                    _alpha_view(im)[...] = alpha[r * ch:(r + 1) * ch, c * cw:(c + 1) * cw]
                    struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 80), 0, int(premultiplied))
        fields = (ctypes.c_uint8 * 64).from_address(enc)
        defaults = struct.unpack_from("<iiiiQiIiiii", fields)
        assert defaults[1:4] == (1, -1, 0) and defaults[4] == 1 and defaults[7] == -1 and defaults[10] == 63, defaults
        struct.pack_into("<i", fields, 8, speed)
        struct.pack_into("<ii", fields, 32, quality, quality)
        struct.pack_into("<ii", fields, 56, *tiles_log2)
        for key, value in {"enable-qm": 0, "deltaq-mode": 0, **(options or {})}.items():
            if lib.avifEncoderSetCodecSpecificOption(enc, key.encode(), str(value).encode()) != 0:
                raise RuntimeError(f"avifEncoderSetCodecSpecificOption {key} failed")
        flags = 2 if single else 0  # AVIF_ADD_IMAGE_FLAG_SINGLE, or none
        if len(cells) == 1:
            rc = lib.avifEncoderAddImage(enc, cells[0], 1, flags)
        else:
            rc = lib.avifEncoderAddImageGrid(enc, cols, rows, (ctypes.c_void_p * len(cells))(*cells), flags)
        if rc != 0 or lib.avifEncoderFinish(enc, ctypes.addressof(out)) != 0:
            raise RuntimeError(f"avifEncoder failed: {rc}")
        ptr, size = struct.unpack_from("<QQ", out)
        data = bytes((ctypes.c_uint8 * size).from_address(ptr))
        lib.avifRWDataFree(ctypes.addressof(out))
        return data
    finally:
        lib.avifEncoderDestroy(enc)
        for im in cells:
            lib.avifImageDestroy(im)


def scale(planes, depth: int, yuv_format: int, width: int, height: int, alpha=None):
    """`avifImageScale` (libyuv's ScalePlane / ScalePlane_12 in box filter
    mode, as libavif scales a frame to its item's size) on our own planes
    [Y] or [Y, U, V] (uint16 above depth 8) and an optional alpha plane ->
    (the scaled planes, the scaled alpha or None)."""
    lib = _lib()
    lib.avifImageScale.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    h, w = planes[0].shape
    im = _create(lib, w, h, depth, yuv_format, alpha is not None)
    try:
        _, views = _plane_views(im)
        for view, plane in zip(views, planes):
            view[...] = plane
        if alpha is not None:
            _alpha_view(im)[...] = alpha
        diag = (ctypes.c_char * 256)()
        if lib.avifImageScale(im, width, height, diag) != 0:
            raise RuntimeError(f"avifImageScale failed: {diag.value.decode()}")
        _, views = _plane_views(im)
        scaled = _alpha_view(im)
        return [v.copy() for v in views], None if scaled is None else scaled.copy()
    finally:
        lib.avifImageDestroy(im)


# aom's inter tools that AVIF step 7 leaves for later steps, switched off:
# OBMC, warped and global motion, temporal MV candidates, the compound
# tools and the dual filter
INTER_TOOLS_OFF = {"enable-obmc": 0, "enable-warped-motion": 0, "enable-global-motion": 0, "enable-ref-frame-mvs": 0,
                   "enable-onesided-comp": 0, "enable-masked-comp": 0, "enable-interintra-comp": 0,
                   "enable-dist-wtd-comp": 0, "enable-dual-filter": 0}


def encode_seq(frames, depth: int, yuv_format: int, speed: int = 6, quality: int = 60,
               options: dict | None = None) -> bytes:
    """An image sequence through OpenCV's libavif 1.4 (aom 3.14): each of
    `frames` ([Y] or [Y, U, V] planes of the layout's sizes, uint16 above
    depth 8) added with no flag (aom's good-quality usage, one temporal unit
    a frame, inter frames after the first), at aom's `speed` and `quality`,
    full range, matrix BT.601, and codec-specific `options` (quantizer
    matrices and delta q off unless asked for, as in `encode_hbd`). The
    track's samples: tests/torch_fixtures/make_textures.avif_track_samples."""
    lib = _hbd_lib()
    h, w = frames[0][0].shape
    images = []
    enc = lib.avifEncoderCreate()
    out = (ctypes.c_uint8 * 16)()  # avifRWData: data, size
    try:
        fields = (ctypes.c_uint8 * 64).from_address(enc)
        struct.pack_into("<i", fields, 8, speed)
        struct.pack_into("<ii", fields, 32, quality, quality)
        for key, value in {"enable-qm": 0, "deltaq-mode": 0, **(options or {})}.items():
            if lib.avifEncoderSetCodecSpecificOption(enc, key.encode(), str(value).encode()) != 0:
                raise RuntimeError(f"avifEncoderSetCodecSpecificOption {key} failed")
        for planes in frames:
            im = _create(lib, w, h, depth, yuv_format, False)
            images.append(im)
            struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 16), 0, 1)
            struct.pack_into("<3H", (ctypes.c_uint8 * 6).from_address(im + 104), 0, 1, 13, 6)
            _, views = _plane_views(im)
            for view, plane in zip(views, planes):
                view[...] = plane
            if lib.avifEncoderAddImage(enc, im, 1, 0) != 0:
                raise RuntimeError("avifEncoderAddImage failed")
        if lib.avifEncoderFinish(enc, ctypes.addressof(out)) != 0:
            raise RuntimeError("avifEncoderFinish failed")
        ptr, size = struct.unpack_from("<QQ", out)
        data = bytes((ctypes.c_uint8 * size).from_address(ptr))
        lib.avifRWDataFree(ctypes.addressof(out))
        return data
    finally:
        lib.avifEncoderDestroy(enc)
        for im in images:
            lib.avifImageDestroy(im)
