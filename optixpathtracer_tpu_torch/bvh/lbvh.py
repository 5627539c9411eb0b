"""LBVH builder: Morton sort -> Karras binary tree -> level-ordered refit
(port of optixpathtracer_tpu/bvh/lbvh.py).

Triangles are sorted by the Morton code of their centroid and grouped into
fixed leaves of K consecutive triangles, so a leaf is a contiguous slice of
the sorted soup. The internal nodes come from Karras 2012, vectorised over
all nodes with masked binary searches; the refit pulls child boxes up one
tree level per pass. Child boxes live at the parent, so one step of the
lockstep walk (ops/traverse.py) is one node fetch that tests both children.

The build is host code: the native C++ builder (bvh/native.py, bit-exact
against the numpy stages below), or numpy under OPTIX_TPU_NO_NATIVE=1. Only
the finished tree goes to the device; `BuildResult.host` keeps the numpy
copies for the host-side wide collapse (bvh/wide.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.math import Vec3
from .morton import np_clz32, np_morton_codes

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BVH:
    """Flattened 2-wide BVH over fixed-size triangle leaves.

    M = num_leaves - 1 internal nodes (min 1). Children encode leaves as
    negative: child = -(leaf_id + 1); non-negative child = internal node id.
    Leaf `i` owns triangles [i*K, (i+1)*K) of the sorted triangle arrays.
    """

    child_left: Tensor  # (M,) int32
    child_right: Tensor  # (M,) int32
    left_min: Vec3  # (M,)
    left_max: Vec3
    right_min: Vec3
    right_max: Vec3
    leaf_size: int

    @property
    def num_internal(self) -> int:
        return self.child_left.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.num_internal + 1


TRAVERSAL_STACK_DEPTH = 64  # per-ray stack slots in ops/traverse.py


def _np_delta(codes: np.ndarray, i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    """Common-prefix length between sorted keys i and j; -1 when j is out of
    range. Equal Morton codes fall back to index bits (standard Karras
    tie-break), which also guarantees bounded tree depth."""
    valid = (j >= 0) & (j < n)
    jc = np.clip(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    tie = 32 + np_clz32((i ^ jc).astype(np.uint32))
    base = np.where(x == 0, tie, np_clz32(x))
    return np.where(valid, base, -1).astype(np.int64)


def _np_karras_tree(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Internal-node children for sorted 30-bit codes, vectorised over all
    nodes. Returns (left, right) int32 with leaves encoded as -(leaf_id+1)."""
    n = len(codes)
    if n == 1:
        return np.full(1, -1, np.int32), np.full(1, -1, np.int32)

    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(
        _np_delta(codes, i, i + 1, n) - _np_delta(codes, i, i - 1, n)
    ).astype(np.int64)
    d[d == 0] = 1
    delta_min = _np_delta(codes, i, i - d, n)

    # exponential upper bound for the range length
    l_max = np.full_like(i, 2)
    done = np.zeros(n - 1, bool)
    for _ in range(64):
        if done.all():
            break
        ok = _np_delta(codes, i, i + l_max * d, n) > delta_min
        l_max = np.where(ok & ~done, l_max * 2, l_max)
        done |= ~ok

    # binary search the exact other end j = i + l*d
    l = np.zeros_like(i)  # noqa: E741 (Karras's name)
    for k in range(1, 64):
        t = l_max >> k
        if not (t >= 1).any():
            break
        ok = (t >= 1) & (_np_delta(codes, i, i + (l + t) * d, n) > delta_min)
        l = np.where(ok, l + t, l)  # noqa: E741
    j = i + l * d
    delta_node = _np_delta(codes, i, j, n)

    # binary search the split point
    s = np.zeros_like(i)
    prev = l.copy()
    for k in range(64):
        t = (prev + 1) >> 1
        active = (prev > 1) | (k == 0)
        ok = active & (_np_delta(codes, i, i + (s + t) * d, n) > delta_node)
        s = np.where(ok, s + t, s)
        if not (prev > 1).any():
            break
        prev = t

    gamma = i + s * d + np.minimum(d, 0)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left = np.where(lo == gamma, -(gamma + 1), gamma)
    right = np.where(hi == gamma + 1, -(gamma + 2), gamma + 1)
    return left.astype(np.int32), right.astype(np.int32)


def _np_levels(left: np.ndarray, right: np.ndarray) -> tuple[np.ndarray, int]:
    """Per-internal-node depth from the root and the tree depth in levels
    (the leaf level included), by a breadth-first frontier walk."""
    m = len(left)
    level = np.full(m, -1, np.int32)
    level[0] = 0
    frontier = np.array([0], np.int64)
    depth = 0
    while len(frontier):
        kids = np.concatenate([left[frontier], right[frontier]])
        kids = kids[kids >= 0]
        if len(kids) == 0:
            break
        depth += 1
        level[kids] = depth
        frontier = kids
    return level, depth + 1  # +1: the leaf level below the last internal


def _np_refit(
    left: np.ndarray,
    right: np.ndarray,
    leaf_min: np.ndarray,
    leaf_max: np.ndarray,
    level: np.ndarray,
) -> tuple[np.ndarray, ...]:
    """Exact bottom-up AABB refit, one vectorised pass per tree level.
    Returns the per-parent child boxes (lmin, lmax, rmin, rmax), each (M, 3)."""
    m = len(left)
    node_min = np.full((m, 3), np.inf, np.float32)
    node_max = np.full((m, 3), -np.inf, np.float32)
    single_leaf = len(leaf_min) == 1

    def child_box(ch):
        isleaf = ch < 0
        leaf_id = np.clip(-(ch + 1), 0, len(leaf_min) - 1)
        node_id = np.clip(ch, 0, m - 1)
        cmin = np.where(isleaf[:, None], leaf_min[leaf_id], node_min[node_id])
        cmax = np.where(isleaf[:, None], leaf_max[leaf_id], node_max[node_id])
        return cmin, cmax

    for lev in range(int(level.max()), -1, -1):
        sel = np.nonzero(level == lev)[0]
        lmin_s, lmax_s = child_box(left[sel])
        rmin_s, rmax_s = child_box(right[sel])
        node_min[sel] = np.minimum(lmin_s, rmin_s)
        node_max[sel] = np.maximum(lmax_s, rmax_s)

    lmin, lmax = child_box(left)
    rmin, rmax = child_box(right)
    if single_leaf:
        # degenerate tree: kill the duplicate right child with an empty box
        rmin = np.full((m, 3), np.inf, np.float32)
        rmax = np.full((m, 3), -np.inf, np.float32)
    return lmin, lmax, rmin, rmax


class BuildResult(NamedTuple):
    bvh: BVH | None  # the tree on `device` (None when built without one)
    order: np.ndarray  # sorted position -> original triangle
    padded_count: int  # triangles after padding to whole leaves
    depth: int = 0  # binary tree depth in levels (incl. leaf level)
    host: dict | None = None  # numpy copies of the tree arrays, for the
    #   host-side wide collapse (never read back from the device)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 4,
              device=None) -> BuildResult:
    """Build from host (T, 3) triangle vertex arrays: the native C++ builder,
    or numpy under OPTIX_TPU_NO_NATIVE=1. The tree's arrays go to `device`
    as tensors (no upload when `device` is None: `bvh` is then None)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    pad_to = max(leaf_size, ((t + leaf_size - 1) // leaf_size) * leaf_size)

    from . import native as _native

    nat = _native.build_binary(v0, v1, v2, leaf_size)
    if nat is not None:
        order = nat["order"]
        left, right = nat["left"], nat["right"]
        lmin, lmax, rmin, rmax = nat["lmin"], nat["lmax"], nat["rmin"], nat["rmax"]
        depth = nat["depth"]
    else:
        c = (v0.astype(np.float64) + v1 + v2) / 3.0
        codes = np_morton_codes(c)
        order = np.argsort(codes, kind="stable")
        # pad by repeating the last sorted triangle: duplicate hits are
        # harmless and keep the tail leaf's box tight
        if pad_to > t:
            order = np.concatenate([order, np.repeat(order[-1:], pad_to - t)])

        sorted_codes = codes[order]
        num_leaves = pad_to // leaf_size

        tri_min = np.minimum(np.minimum(v0, v1), v2)
        tri_max = np.maximum(np.maximum(v0, v1), v2)
        lf_min = tri_min[order].reshape(num_leaves, leaf_size, 3).min(axis=1)
        lf_max = tri_max[order].reshape(num_leaves, leaf_size, 3).max(axis=1)

        leaf_codes = sorted_codes[::leaf_size].copy()
        left, right = _np_karras_tree(leaf_codes)
        level, depth = _np_levels(left, right)
        lmin, lmax, rmin, rmax = _np_refit(
            left, right, lf_min.astype(np.float32), lf_max.astype(np.float32), level)
    if depth + 1 > TRAVERSAL_STACK_DEPTH:
        raise ValueError(
            f"BVH depth {depth + 1} exceeds the lockstep traversal stack "
            f"({TRAVERSAL_STACK_DEPTH}); raise leaf_size or STACK_DEPTH "
            "(degenerate Morton distribution?)")

    bvh = None
    if device is not None:
        def vec(a: np.ndarray) -> Vec3:
            return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, k]), device=device)
                          for k in range(3)))

        bvh = BVH(
            child_left=torch.as_tensor(left, device=device),
            child_right=torch.as_tensor(right, device=device),
            left_min=vec(lmin), left_max=vec(lmax), right_min=vec(rmin), right_max=vec(rmax),
            leaf_size=leaf_size,
        )
    host = dict(left=left, right=right, lmin=lmin, lmax=lmax, rmin=rmin, rmax=rmax)
    return BuildResult(bvh=bvh, order=order, padded_count=pad_to, depth=depth, host=host)
