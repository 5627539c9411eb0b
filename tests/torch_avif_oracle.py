"""The AVIF reference of the tests: PIL's bundled libavif (dav1d inside)
through ctypes, where PIL ships it.

- `planes(data)`: `avifDecoderReadMemory`'s Y / U / V planes (each of
  its own size: 4:2:0, 4:2:2, 4:4:4; Y alone for 4:0:0) and
  (width, height, depth, yuvFormat, yuvRange) - dav1d's decode before any
  colour conversion; `alpha(data)` the alpha plane (None without one) and
  whether libavif marks it premultiplied.
- `yuv_to_rgb(template, y, u, v, matrix, full, alpha=None, premultiplied=0)`:
  `avifImageYUVToRGB` with PIL's settings (RGB, or RGBA where an alpha
  plane is given, as PIL asks for an image with alpha; depth 8, automatic
  chroma upsampling) on planes of our own, written into an image decoded
  from `template` (an AVIF of the same size and layout, so that libavif
  owns the buffers) -> the RGB channels.
- `unpremultiply(rgba)`: `avifRGBImageUnpremultiplyAlpha` on 8-bit RGBA.
- `encode(y, grid)`: libavif's own encoder, for the `grid` stills PIL's
  save does not write.

The offsets are those of libavif 1.3's `avifImage` (width, height, depth,
yuvFormat (1 4:4:4, 2 4:2:2, 3 4:2:0, 4 4:0:0), yuvRange, chroma position;
yuvPlanes at 24, yuvRowBytes at 48; alphaPlane at 64, alphaRowBytes at 72,
alphaPremultiplied at 80; colorPrimaries / transferCharacteristics /
matrixCoefficients as uint16 at 104 / 106 / 108) and `avifRGBImage`
(depth at 8, format at 12 (0 RGB, 1 RGBA), alphaPremultiplied at 32,
pixels at 48, rowBytes at 56). `available()` is False where PIL ships no
libavif.
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


def _view(ptr: int, stride: int, h: int, w: int) -> np.ndarray:
    buf = (ctypes.c_uint8 * (stride * h)).from_address(ptr)
    return np.frombuffer(buf, np.uint8).reshape(h, stride)[:, :w]


def _plane_views(im):
    w, h, depth, fmt, rng, _ = (ctypes.c_uint32 * 6).from_address(im)
    ptrs = (ctypes.c_void_p * 3).from_address(im + 24)
    strides = (ctypes.c_uint32 * 3).from_address(im + 48)
    dims = [(h, w)]
    if SUBSAMPLING[fmt] is not None:
        sx, sy = SUBSAMPLING[fmt]
        dims += [((h + sy) >> sy, (w + sx) >> sx)] * 2
    views = [_view(ptrs[p], strides[p], *dims[p]) for p in range(len(dims))]
    return (w, h, depth, fmt, rng), views


def _alpha_view(im):
    w, h = (ctypes.c_uint32 * 2).from_address(im)
    ptr = ctypes.c_void_p.from_address(im + 64).value
    if not ptr:
        return None
    return _view(ptr, ctypes.c_uint32.from_address(im + 72).value, h, w)


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


def yuv_to_rgb(template: bytes, y: np.ndarray, u, v, matrix: int, full: int, alpha=None,
               premultiplied: int = 0) -> np.ndarray:
    lib = _lib()
    im = _read(template)
    try:
        (w, h, _, _, _), views = _plane_views(im)
        for view, plane in zip(views, (y, u, v)):
            view[...] = plane
        if alpha is not None:
            _alpha_view(im)[...] = alpha
            struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 80), 0, premultiplied)
        struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 16), 0, int(bool(full)))
        struct.pack_into("<H", (ctypes.c_uint8 * 2).from_address(im + 108), 0, matrix)
        rgb = (ctypes.c_uint8 * 256)()
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), im)
        channels = 3 if alpha is None else 4
        struct.pack_into("<I", rgb, 12, channels - 3)  # AVIF_RGB_FORMAT_RGB / RGBA
        if lib.avifRGBImageAllocatePixels(ctypes.addressof(rgb)) != 0:
            raise RuntimeError("avifRGBImageAllocatePixels failed")
        try:
            if lib.avifImageYUVToRGB(im, ctypes.addressof(rgb)) != 0:
                raise RuntimeError("avifImageYUVToRGB failed")
            ptr, = struct.unpack_from("<Q", rgb, 48)
            row_bytes, = struct.unpack_from("<I", rgb, 56)
            px = np.frombuffer((ctypes.c_uint8 * (row_bytes * h)).from_address(ptr), np.uint8)
            return px.reshape(h, row_bytes)[:, :w * channels].reshape(h, w, channels)[..., :3].copy()
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
    bundled aom writes no 10 / 12-bit AV1.)"""
    lib = _lib()
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
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
        im = lib.avifImageCreate(w, h, 8, 3)  # AVIF_PIXEL_FORMAT_YUV420
        cells.append(im)
        if lib.avifImageAllocatePlanes(im, 1) != 0:  # AVIF_PLANES_YUV
            raise RuntimeError("avifImageAllocatePlanes failed")
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
