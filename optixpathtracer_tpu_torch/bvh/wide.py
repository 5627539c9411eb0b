"""Wide (multi-branching) BVH for the BFS and dense traversals (port of
optixpathtracer_tpu/bvh/wide.py).

Built on the host by collapsing the binary LBVH (bvh/lbvh.py): each wide
node's children come from greedily expanding the binary subtree with the
most leaves until W slots are filled. The native C++ collapse
(bvh/native.py) is bit-exact against `collapse`, which runs under
OPTIX_TPU_NO_NATIVE=1.

Device layout: ONE row per wide node,
  [child0 bbox (6) | child1 bbox (6) | ... | childW bbox | child refs (W)];
child ref >= 0: wide node id; ref < 0: leaf id encoded -(leaf+1); EMPTY: none.
The compressed layout packs the boxes as bf16 pairs, rounded outwards.
Leaf triangle data is one row per leaf: K triangles x 9 floats.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

EMPTY = np.int32(0x7FFFFFFF)


@dataclasses.dataclass(frozen=True)
class WideBVH:
    table: Tensor  # (Wn, 7*W) f32 [bbox | refs as f32 bits]; or compressed
    #                (Wn, 4*W) f32 [3W packed bf16 bbox pairs | W refs]
    leaf_rows: Tensor  # (L, K*9) float32 packed triangle vertices
    leaf_tri0: Tensor  # (L,) int32: global sorted-tri index of each leaf's tri 0
    width: int
    leaf_size: int
    depth: int  # levels, the leaf level included
    compressed: bool = False

    @property
    def num_nodes(self) -> int:
        return self.table.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.leaf_rows.shape[0]


def collapse(
    child_left: np.ndarray,
    child_right: np.ndarray,
    left_min: np.ndarray,
    left_max: np.ndarray,
    right_min: np.ndarray,
    right_max: np.ndarray,
    num_leaves: int,
    width: int = 8,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Binary tree (children + child boxes at the parent) -> wide node
    arrays: (bbox (Wn, W, 6), refs (Wn, W) int32, depth)."""
    n_int = len(child_left)
    leaf_box_min: dict[int, np.ndarray] = {}
    leaf_box_max: dict[int, np.ndarray] = {}
    for i in range(n_int):
        for c, bmin, bmax in ((child_left[i], left_min[i], left_max[i]),
                              (child_right[i], right_min[i], right_max[i])):
            if c < 0:
                leaf_box_min[int(c)] = bmin
                leaf_box_max[int(c)] = bmax

    def box_of(ref: int) -> tuple[np.ndarray, np.ndarray]:
        if ref >= 0:
            return (np.minimum(left_min[ref], right_min[ref]),
                    np.maximum(left_max[ref], right_max[ref]))
        return leaf_box_min[ref], leaf_box_max[ref]

    # subtree leaf counts, bottom-up over a DFS order (Karras ids are unordered)
    counts = np.zeros(n_int, np.int64)
    order = []
    stack = [0]
    seen = np.zeros(n_int, bool)
    while stack:
        s = stack.pop()
        order.append(s)
        for c in (int(child_left[s]), int(child_right[s])):
            if c >= 0 and not seen[c]:
                seen[c] = True
                stack.append(c)
    for s in reversed(order):
        total = 0
        for c in (int(child_left[s]), int(child_right[s])):
            total += counts[c] if c >= 0 else 1
        counts[s] = total

    def count_of(ref: int) -> int:
        return int(counts[ref]) if ref >= 0 else 1

    # BFS over wide nodes; each expands its binary root into <= W binary
    # subtree roots, splitting the slot with the most leaves first
    queue = [0]
    wide_ids = {0: 0}
    next_wide = 1
    depth_of = {0: 1}
    max_depth = 1
    result_boxes: list[np.ndarray] = []
    result_refs: list[np.ndarray] = []

    qi = 0
    while qi < len(queue):
        broot = queue[qi]
        my_depth = depth_of[broot]
        qi += 1
        slots: list[int] = [broot]
        while len(slots) < width:
            internal = [(i, s) for i, s in enumerate(slots) if s >= 0]
            if not internal:
                break
            i_best = max(internal, key=lambda t: count_of(t[1]))[0]
            s = slots.pop(i_best)
            slots.append(int(child_left[s]))
            slots.append(int(child_right[s]))

        boxes = np.zeros((width, 6), np.float32)
        refs = np.full((width,), EMPTY, np.int32)
        boxes[:, 0:3] = np.inf
        boxes[:, 3:6] = -np.inf
        for k, s in enumerate(slots[:width]):
            if s >= 0:
                if s not in wide_ids:
                    wide_ids[s] = next_wide
                    next_wide += 1
                    queue.append(s)
                    depth_of[s] = my_depth + 1
                    max_depth = max(max_depth, my_depth + 1)
                refs[k] = wide_ids[s]
            else:
                refs[k] = s  # leaf encoding passes through
            bmin, bmax = box_of(s)
            boxes[k, 0:3] = bmin
            boxes[k, 3:6] = bmax
        result_boxes.append(boxes)
        result_refs.append(refs)

    # +1 level: leaves hang off the last internal level
    return np.stack(result_boxes), np.stack(result_refs), max_depth + 1


def _bf16_down(x: np.ndarray) -> np.ndarray:
    """Largest bf16 <= x (conservative box-min rounding), as float32. Bit
    operations on the float32 pattern: no bfloat16 cast rounds this way."""
    bits = x.astype(np.float32).view(np.uint32)
    trunc = bits & np.uint32(0xFFFF0000)
    t = trunc.view(np.float32)
    # one bf16 ulp down where truncation rounded up (negative values)
    step = np.where(trunc == 0x80000000, np.uint32(0x80010000),
                    np.where(t >= 0, trunc - 0x10000, trunc + 0x10000)).astype(np.uint32)
    down = step.view(np.float32)
    out = np.where(t <= x, t, down)
    return np.where(np.isfinite(x), out, x).astype(np.float32)


def _bf16_up(x: np.ndarray) -> np.ndarray:
    """Smallest bf16 >= x (conservative box-max rounding), as float32."""
    return -_bf16_down(-np.asarray(x, np.float32))


def pack_compressed(bbox: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """(Wn, W, 6) f32 boxes + (Wn, W) i32 refs -> (Wn, 4W) f32 rows: per
    child 6 bf16 values (min rounded down, max up) two to an f32 slot as
    (hi<<16 | lo): [minx|miny], [minz|maxx], [maxy|maxz]; the refs' bits in
    the last W columns."""
    wn, w, _ = bbox.shape
    mins = _bf16_down(bbox[:, :, 0:3])
    maxs = _bf16_up(bbox[:, :, 3:6])
    six = np.concatenate([mins, maxs], axis=2)  # (Wn, W, 6) bf16-valued f32
    bits = six.view(np.uint32) >> 16  # bf16 payloads (top 16 bits)
    packed = (bits[:, :, 0::2] << 16) | bits[:, :, 1::2]  # (Wn, W, 3)
    out = np.zeros((wn, 4 * w), np.float32)
    out[:, : 3 * w] = packed.reshape(wn, 3 * w).view(np.float32)
    out[:, 3 * w :] = refs.astype(np.int32).view(np.float32)
    return out


def build_wide(child_left, child_right, left_min, left_max, right_min, right_max,
               sorted_v0: np.ndarray, sorted_v1: np.ndarray, sorted_v2: np.ndarray,
               leaf_size: int, device, width: int = 8, compressed: bool = False) -> WideBVH:
    """The WideBVH on `device` from the binary LBVH's host arrays and the
    triangles in its sorted order (padded)."""
    cl, cr, lm, lM, rm, rM = (np.asarray(a) for a in (child_left, child_right, left_min,
                                                      left_max, right_min, right_max))
    num_leaves = len(sorted_v0) // leaf_size

    if num_leaves == 1:
        bbox = np.zeros((1, width, 6), np.float32)
        refs = np.full((1, width), EMPTY, np.int32)
        bbox[:, :, 0:3] = np.inf
        bbox[:, :, 3:6] = -np.inf
        refs[0, 0] = -1  # leaf 0
        bbox[0, 0, 0:3] = lm[0]
        bbox[0, 0, 3:6] = lM[0]
        depth = 2  # iteration 0 expands the root, iteration 1 tests the leaf
    else:
        from . import native as _native

        nat = _native.wide_collapse(cl, cr, lm, lM, rm, rM, num_leaves, width)
        if nat is not None:
            bbox, refs, depth = nat
        else:
            bbox, refs, depth = collapse(cl, cr, lm, lM, rm, rM, num_leaves, width)

    wn = bbox.shape[0]
    if compressed:
        table = pack_compressed(bbox, refs)
    else:
        table = np.zeros((wn, 7 * width), np.float32)
        table[:, : 6 * width] = bbox.reshape(wn, width * 6)
        table[:, 6 * width :] = refs.view(np.float32)

    k = leaf_size
    tri = np.concatenate([sorted_v0, sorted_v1, sorted_v2], axis=1)  # (T, 9)
    leaf_rows = tri.reshape(num_leaves, k * 9).astype(np.float32)
    leaf_tri0 = (np.arange(num_leaves, dtype=np.int32) * k).astype(np.int32)
    return WideBVH(
        table=torch.as_tensor(table, device=device),
        leaf_rows=torch.as_tensor(leaf_rows, device=device),
        leaf_tri0=torch.as_tensor(leaf_tri0, device=device),
        width=width, leaf_size=leaf_size, depth=int(depth), compressed=compressed,
    )
