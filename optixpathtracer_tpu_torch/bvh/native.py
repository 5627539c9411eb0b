"""ctypes bindings for the native acceleration-structure builders (port of
optixpathtracer_tpu/bvh/native.py), built from the port's copy of the
reference's C++ source, `csrc/host/accel.cpp` (utils/host_build.py).

`build_binary`, `wide_collapse` and `cluster_tables` are bit-exact against
their numpy counterparts (bvh/lbvh.py, bvh/wide.py, bvh/clusters.py);
`treelet_order` keeps the numpy recursion and split points, but orders
triangles within a partition its own way (numpy's argpartition leaves that
order unspecified), so it is bit-equal only to the reference's native order,
and cluster tightness is its contract against numpy.

Each entry point returns None under OPTIX_TPU_NO_NATIVE=1, or where the C++
rejects its input (as the reference's does), and the caller then takes its
numpy path. A failed build raises (utils/host_build.py).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils import host_build

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_bound = set()


def get_lib():
    """The loaded library (built at first use), or None under the switch."""
    if not host_build.native_enabled():
        return None
    lib = host_build.load("accel")
    if "accel" not in _bound:
        lib.accel_build_binary.restype = ctypes.c_int32
        lib.accel_build_binary.argtypes = [
            _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int32,
            _i64p, _i32p, _i32p, _f32p, _f32p, _f32p, _f32p, _i32p,
        ]
        lib.accel_wide_collapse.restype = ctypes.c_int32
        lib.accel_wide_collapse.argtypes = [
            _i32p, _i32p, _f32p, _f32p, _f32p, _f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _f32p, _i32p, _i64p,
        ]
        lib.accel_treelet_order.restype = ctypes.c_int32
        lib.accel_treelet_order.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64, _i64p]
        lib.accel_cluster_tables.restype = ctypes.c_int32
        lib.accel_cluster_tables.argtypes = [
            _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _f32p, _f32p, _f32p, _f32p,
        ]
        _bound.add("accel")
    return lib


def _p(a: np.ndarray, ptr):
    return a.ctypes.data_as(ptr)


def build_binary(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int):
    """Morton sort, Karras tree, levels and refit in C++: a dict of order,
    left, right, lmin, lmax, rmin, rmax, level, depth, padded_count, or
    None under the switch."""
    lib = get_lib()
    if lib is None:
        return None
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    k = int(leaf_size)
    pad_to = max(k, ((t + k - 1) // k) * k)
    m = max(1, pad_to // k - 1)
    order = np.empty(pad_to, np.int64)
    left = np.empty(m, np.int32)
    right = np.empty(m, np.int32)
    boxes = [np.empty((m, 3), np.float32) for _ in range(4)]
    level = np.empty(m, np.int32)
    depth = lib.accel_build_binary(
        _p(v0, _f32p), _p(v1, _f32p), _p(v2, _f32p), t, k,
        _p(order, _i64p), _p(left, _i32p), _p(right, _i32p),
        *(_p(b, _f32p) for b in boxes), _p(level, _i32p))
    if depth < 0:
        return None  # input the C++ rejects: the numpy path, as in the reference
    lmin, lmax, rmin, rmax = boxes
    return dict(order=order, left=left, right=right, lmin=lmin, lmax=lmax, rmin=rmin,
                rmax=rmax, level=level, depth=int(depth), padded_count=pad_to)


def wide_collapse(left, right, lmin, lmax, rmin, rmax, num_leaves: int, width: int):
    """The wide-BVH collapse in C++: (bbox (Wn, W, 6), refs (Wn, W), depth),
    or None under the switch."""
    lib = get_lib()
    if lib is None:
        return None
    left, right = (np.ascontiguousarray(a, np.int32) for a in (left, right))
    lmin, lmax, rmin, rmax = (np.ascontiguousarray(a, np.float32) for a in (lmin, lmax, rmin, rmax))
    m = left.shape[0]
    w = int(width)
    bbox = np.empty((m, w, 6), np.float32)
    refs = np.empty((m, w), np.int32)
    wn = ctypes.c_int64(0)
    depth = lib.accel_wide_collapse(
        _p(left, _i32p), _p(right, _i32p), _p(lmin, _f32p), _p(lmax, _f32p),
        _p(rmin, _f32p), _p(rmax, _f32p), m, int(num_leaves), w,
        _p(bbox, _f32p), _p(refs, _i32p), ctypes.byref(wn))
    if depth < 0:
        return None  # input the C++ rejects: the numpy path, as in the reference
    n = int(wn.value)
    return bbox[:n], refs[:n], int(depth)


def treelet_order(centroids: np.ndarray, cluster_size: int, group: int):
    """The treelet repacking order in C++, or None under the switch."""
    lib = get_lib()
    if lib is None:
        return None
    ctr = np.ascontiguousarray(centroids, np.float64)
    n = ctr.shape[0]
    out = np.empty(n, np.int64)
    rc = lib.accel_treelet_order(_p(ctr, _f64p), n, int(cluster_size), int(group),
                                 _p(out, _i64p))
    return out if rc == 0 else None


def cluster_tables(sorted_v0, sorted_v1, sorted_v2, num_real: int, cluster_size: int):
    """The cluster table stage in C++: the `_cluster_tables_np` dict (rows,
    spheres, super_spheres, scene_aabb, local_aabb), or None under the
    switch."""
    lib = get_lib()
    if lib is None:
        return None
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (sorted_v0, sorted_v1, sorted_v2))
    c = int(cluster_size)
    t_real = int(num_real)
    m = max(1, -(-t_real // c))
    s = -(-m // 8)  # SUPER
    rows = np.empty((s, 16, 8 * c), np.float32)
    spheres = np.empty((s * 8, 8), np.float32)
    super_spheres = np.empty((s, 8), np.float32)
    scene_aabb = np.empty(8, np.float32)
    rc = lib.accel_cluster_tables(
        _p(v0, _f32p), _p(v1, _f32p), _p(v2, _f32p), v0.shape[0], t_real, c,
        _p(rows, _f32p), _p(spheres, _f32p), _p(super_spheres, _f32p), _p(scene_aabb, _f32p))
    if rc != 0:
        return None  # input the C++ rejects: the numpy path, as in the reference
    lo6 = np.concatenate([scene_aabb[0:3], scene_aabb[3:6]])
    return dict(rows=rows, spheres=spheres, super_spheres=super_spheres,
                scene_aabb=scene_aabb, local_aabb=lo6)
