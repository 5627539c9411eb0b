"""The AVIF reference of the tests: PIL's bundled libavif (dav1d inside)
through ctypes, where PIL ships it.

- `planes(data)`: `avifDecoderReadMemory`'s Y / U / V planes and
  (width, height, depth, yuvFormat, yuvRange) - dav1d's decode before any
  colour conversion.
- `yuv_to_rgb(template, y, u, v, matrix, full)`: `avifImageYUVToRGB` with
  PIL's settings (RGB, depth 8, automatic chroma upsampling) on planes of
  our own, written into an image decoded from `template` (an AVIF of the
  same size, so that libavif owns the buffers).

The offsets are those of libavif 1.3's `avifImage` (width, height, depth,
yuvFormat, yuvRange, chroma position; yuvPlanes at 24, yuvRowBytes at 48;
colorPrimaries / transferCharacteristics / matrixCoefficients as uint16 at
104 / 106 / 108) and `avifRGBImage` (format at 12, pixels at 48, rowBytes
at 56). `available()` is False where PIL ships no libavif.
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


def _plane_views(im):
    w, h, depth, fmt, rng, _ = (ctypes.c_uint32 * 6).from_address(im)
    ptrs = (ctypes.c_void_p * 3).from_address(im + 24)
    strides = (ctypes.c_uint32 * 3).from_address(im + 48)
    dims = [(h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 1) // 2, (w + 1) // 2)]
    views = []
    for p in range(3):
        ph, pw = dims[p]
        buf = (ctypes.c_uint8 * (strides[p] * ph)).from_address(ptrs[p])
        views.append(np.frombuffer(buf, np.uint8).reshape(ph, strides[p])[:, :pw])
    return (w, h, depth, fmt, rng), views


def planes(data: bytes):
    """-> ((width, height, depth, yuvFormat, yuvRange), [Y, U, V])."""
    im = _read(data)
    try:
        info, views = _plane_views(im)
        return info, [v.copy() for v in views]
    finally:
        _lib().avifImageDestroy(im)


def yuv_to_rgb(template: bytes, y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int, full: int) -> np.ndarray:
    lib = _lib()
    im = _read(template)
    try:
        (w, h, _, _, _), views = _plane_views(im)
        for view, plane in zip(views, (y, u, v)):
            view[...] = plane
        struct.pack_into("<I", (ctypes.c_uint8 * 4).from_address(im + 16), 0, int(bool(full)))
        struct.pack_into("<H", (ctypes.c_uint8 * 2).from_address(im + 108), 0, matrix)
        rgb = (ctypes.c_uint8 * 256)()
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), im)
        struct.pack_into("<I", rgb, 12, 0)  # AVIF_RGB_FORMAT_RGB
        if lib.avifRGBImageAllocatePixels(ctypes.addressof(rgb)) != 0:
            raise RuntimeError("avifRGBImageAllocatePixels failed")
        try:
            if lib.avifImageYUVToRGB(im, ctypes.addressof(rgb)) != 0:
                raise RuntimeError("avifImageYUVToRGB failed")
            ptr, = struct.unpack_from("<Q", rgb, 48)
            row_bytes, = struct.unpack_from("<I", rgb, 56)
            px = np.frombuffer((ctypes.c_uint8 * (row_bytes * h)).from_address(ptr), np.uint8)
            return px.reshape(h, row_bytes)[:, :w * 3].reshape(h, w, 3).copy()
        finally:
            lib.avifRGBImageFreePixels(ctypes.addressof(rgb))
    finally:
        lib.avifImageDestroy(im)
