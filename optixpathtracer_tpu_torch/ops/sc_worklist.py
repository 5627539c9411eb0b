"""Worklist builders for pair-granular sweep scheduling: order-preserving
stream compaction and the cluster-major (row, column) pair worklist (port
of optixpathtracer_tpu/ops/sc_worklist.py).

The reference runs them on the TPU's SparseCore. Its `sparsecore_available`
is the capability gate for that block, and `compact_indices_sc_plan` /
`pair_worklist_sc_plan` are the value-level SparseCore programs behind the
dispatchers `sc_compact_indices` / `sc_pair_worklist`. The H100 has no
SparseCore, so the gate and the plans have no counterpart here. What both
packages compute is the reference's XLA contract (`compact_indices_xla`,
`pair_worklist_xla`):

- `compact_indices` (kernel K5a): the indices of the set flags in order,
  -1 padding up to `capacity`, and the number of set flags (even when it
  exceeds `capacity`).
- `pair_worklist` (kernel K5b): every (row, column) whose bit is set in a
  (R,) word of member bits, ordered by column then row, truncated or -1
  padded to `capacity`, and the number of set bits.

Each wrapper takes its plain PyTorch version (`compact_indices_torch`,
`pair_worklist_torch`) for CPU tensors and launches its CUDA kernel
(csrc/worklist.cu) for CUDA tensors, or raises; there is no fallback from
one to the other. `launch_counts` counts kernel launches.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..core.rng import M32
from .cuda_build import check_tensor, launch_env, load, raise_on

Tensor = torch.Tensor
WORD_BITS = 32  # columns per member-bits word

# kernel name -> launches since the last clear()
launch_counts: collections.Counter = collections.Counter()


def compact_indices_torch(flags: Tensor, capacity: int) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of kernel K5a: (idx (capacity,) int32, count
    0-dim int32)."""
    idx = torch.nonzero(flags).flatten().to(torch.int32)
    out = torch.full((capacity,), -1, dtype=torch.int32, device=flags.device)
    k = min(idx.numel(), capacity)
    out[:k] = idx[:k]
    return out, torch.tensor(idx.numel(), dtype=torch.int32, device=flags.device)


def pair_worklist_torch(bits: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of kernel K5b. bits: (R,) int32 bit patterns of
    uint32 words. Returns (row (capacity,) int32, col (capacity,) int32,
    count 0-dim int32)."""
    words = bits.to(torch.int64) & M32
    cols = torch.arange(WORD_BITS, device=bits.device)
    valid = ((words[None, :] >> cols[:, None]) & 1) != 0  # (32, R): column-major
    col, row = torch.nonzero(valid, as_tuple=True)  # lexicographic: column, then row
    out_r = torch.full((capacity,), -1, dtype=torch.int32, device=bits.device)
    out_c = torch.full_like(out_r, -1)
    k = min(row.numel(), capacity)
    out_r[:k] = row[:k].to(torch.int32)
    out_c[:k] = col[:k].to(torch.int32)
    return out_r, out_c, torch.tensor(row.numel(), dtype=torch.int32, device=bits.device)


@functools.cache
def _lib():
    lib = load("worklist")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.worklist_blocks.argtypes = [ll]
    lib.worklist_blocks.restype = ctypes.c_int
    lib.compact_launch.argtypes = [i, p, ll, i, p, p, p, p]
    lib.pair_launch.argtypes = [i, p, i, i, p, p, p, p, p]
    for fn in (lib.compact_launch, lib.pair_launch):
        fn.restype = ctypes.c_int
    return lib


def _check_capacity(capacity: int, total: int) -> None:
    if not 0 <= capacity < 2**31 or total >= 2**31:
        raise ValueError(f"capacity {capacity} and count bound {total} must fit in int32")


def compact_indices(flags: Tensor, capacity: int) -> tuple[Tensor, Tensor]:
    """Kernel K5a: (idx (capacity,) int32, count 0-dim int32) of the set
    entries of a (n,) bool tensor, in order, -1 padded."""
    if flags.device.type == "cpu":
        return compact_indices_torch(flags, capacity)
    dev_idx, stream = launch_env(flags)
    n = flags.shape[0]
    check_tensor(flags, "flags", torch.bool, flags.device, (n,))
    _check_capacity(capacity, n)
    lib = _lib()
    nb = lib.worklist_blocks(n)
    idx = torch.empty((capacity,), dtype=torch.int32, device=flags.device)
    cnt = torch.empty((), dtype=torch.int32, device=flags.device)
    scratch = torch.empty((2 * nb,), dtype=torch.int32, device=flags.device)
    raise_on(lib.compact_launch(dev_idx, flags.data_ptr(), n, capacity, idx.data_ptr(),
                                cnt.data_ptr(), scratch.data_ptr(), stream), "compact")
    launch_counts["compact"] += 1
    return idx, cnt


def pair_worklist(bits: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Kernel K5b: (row, col (capacity,) int32, count 0-dim int32) of the set
    bits of (R,) int32 words, column-major, -1 padded."""
    if bits.device.type == "cpu":
        return pair_worklist_torch(bits, capacity)
    dev_idx, stream = launch_env(bits)
    r = bits.shape[0]
    check_tensor(bits, "bits", torch.int32, bits.device, (r,))
    _check_capacity(capacity, r * WORD_BITS)
    lib = _lib()
    nb = lib.worklist_blocks(r)
    row = torch.empty((capacity,), dtype=torch.int32, device=bits.device)
    col = torch.empty_like(row)
    cnt = torch.empty((), dtype=torch.int32, device=bits.device)
    scratch = torch.empty((2 * WORD_BITS * nb,), dtype=torch.int32, device=bits.device)
    raise_on(lib.pair_launch(dev_idx, bits.data_ptr(), r, capacity, row.data_ptr(), col.data_ptr(),
                             cnt.data_ptr(), scratch.data_ptr(), stream), "pair_worklist")
    launch_counts["pair_worklist"] += 1
    return row, col, cnt
