"""ctypes bindings for the native OBJ tokenizer (port of
optixpathtracer_tpu/io/native.py), built from the port's copy of the
reference's C++ source, `csrc/host/objparser.cpp` (utils/host_build.py).

`parse_obj_native` returns None under OPTIX_TPU_NO_NATIVE=1 and io/obj.py
then parses in Python (the reference's tokenizer ignores the switch; the
port reads it for every native library). A failed build raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils import host_build

_bound = set()


def get_lib():
    """The loaded library (built at first use), or None under the switch."""
    if not host_build.native_enabled():
        return None
    lib = host_build.load("objparser")
    if "objparser" not in _bound:
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        lib.obj_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        for fn in ("obj_copy_positions", "obj_copy_normals", "obj_copy_texcoords"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.obj_copy_tris.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.obj_group_name.restype = ctypes.c_char_p
        lib.obj_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _bound.add("objparser")
    return lib


def parse_obj_native(path: str):
    """Parse an OBJ with the C++ tokenizer.

    Returns (positions (V,3) f32, normals (N,3), texcoords (T,2),
    tris (F,10) i32 [v*3, vt*3, vn*3, group], group_names list[(shape, mtl)])
    or None under the switch.
    """
    lib = get_lib()
    if lib is None:
        return None
    h = lib.obj_parse(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        counts = (ctypes.c_int64 * 5)()
        lib.obj_counts(h, counts)
        nv, nn, nt, nf, ng = (int(c) for c in counts)
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nn, 3), np.float32)
        uv = np.empty((nt, 2), np.float32)
        tris = np.empty((nf, 10), np.int32)
        f32 = ctypes.POINTER(ctypes.c_float)
        if nv:
            lib.obj_copy_positions(h, pos.ctypes.data_as(f32))
        if nn:
            lib.obj_copy_normals(h, nrm.ctypes.data_as(f32))
        if nt:
            lib.obj_copy_texcoords(h, uv.ctypes.data_as(f32))
        if nf:
            lib.obj_copy_tris(h, tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        names = []
        for i in range(ng):
            shape, _, mtl = lib.obj_group_name(h, i).decode(errors="replace").partition("\x1f")
            names.append((shape, mtl))
        return pos, nrm, uv, tris, names
    finally:
        lib.obj_free(h)
