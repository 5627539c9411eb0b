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
one to the other. Each kernel is one cooperative launch per call
(`launch_plan` sizes it); `launch_counts` counts kernel launches.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

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


THREADS = 1024  # threads per block of both kernels (csrc/worklist.cu kThreads)
FLAGS_PER_VEC = 16  # K5a: bool flags per 16-byte load
WORDS_PER_VEC = 4  # K5b: int32 words per 16-byte load
_KERNEL = {"compact": 0, "pair_worklist": 1}  # worklist_blocks_per_sm's `which`


class LaunchPlan(NamedTuple):
    """One cooperative launch of a worklist kernel and its int32 buffer.

    The input is cut into `steps` vector steps of span = THREADS x items per
    16-byte vector (the last one ragged); block b takes steps [b * steps //
    grid, (b + 1) * steps // grid), and in step s its thread t reads the
    vector at s * span + t * items per vector. The buffer holds `outputs`
    arrays of `capacity` ints (idx, or row and col), the count at
    `count_at`, and the per-block counts table (1 or 32 ints a block) at
    `counts_at`."""

    grid: int  # blocks: at most one wave of co-resident blocks
    steps: int  # vector steps of the whole input
    vec: int  # 16-byte vectors per thread, at most
    items_per_thread: int  # at most
    count_at: int
    counts_at: int
    buffer_ints: int


def launch_plan(n: int, capacity: int, items_per_vec: int, outputs: int, counts_per_block: int,
                max_blocks: int) -> LaunchPlan:
    """The grid, vector steps and buffer layout for n items on a card that
    holds max_blocks co-resident blocks of THREADS threads: one block per
    vector step up to one wave, then the steps spread evenly over the wave."""
    if max_blocks < 1:
        raise ValueError(f"no block of {THREADS} threads fits an SM ({max_blocks})")
    steps = max(1, -(-n // (THREADS * items_per_vec)))
    grid = min(max_blocks, steps)
    vec = -(-steps // grid)
    count_at = outputs * capacity
    return LaunchPlan(grid, steps, vec, vec * items_per_vec, count_at, count_at + 1,
                      count_at + 1 + counts_per_block * grid)


@functools.cache
def _lib():
    lib = load("worklist")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.worklist_threads.restype = ctypes.c_int
    if lib.worklist_threads() != THREADS:
        raise RuntimeError("csrc/worklist.cu and ops/sc_worklist.py disagree on THREADS")
    lib.worklist_blocks_per_sm.argtypes = [i, i]
    lib.compact_launch.argtypes = [i, p, ll, i, ll, i, p, p]
    lib.pair_launch.argtypes = [i, p, ll, i, ll, i, p, p]
    lib.floor_launch.argtypes = [i, i, i, p]
    for fn in (lib.worklist_blocks_per_sm, lib.compact_launch, lib.pair_launch, lib.floor_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def max_blocks(dev_idx: int, kernel: str) -> int:
    """Co-resident blocks of a worklist kernel on the card: the occupancy
    query's blocks per SM x the card's SMs (one wave). The query also opts
    K5b in to its shared memory on that device, so every launch asks it
    first; cached, it runs once per device."""
    per_sm = _lib().worklist_blocks_per_sm(dev_idx, _KERNEL[kernel])
    if per_sm < 0:
        raise_on(-per_sm, f"{kernel} occupancy query")
    return per_sm * torch.cuda.get_device_properties(dev_idx).multi_processor_count


def _check_capacity(capacity: int, total: int) -> None:
    if not 0 <= capacity < 2**31 or total >= 2**31:
        raise ValueError(f"capacity {capacity} and count bound {total} must fit in int32")


def _check_aligned(x: Tensor, name: str) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernel reads 16 bytes at a time)")


def compact_indices(flags: Tensor, capacity: int) -> tuple[Tensor, Tensor]:
    """Kernel K5a: (idx (capacity,) int32, count 0-dim int32) of the set
    entries of a (n,) bool tensor, in order, -1 padded. On a CUDA tensor
    one cooperative launch; both outputs are views of one buffer."""
    if flags.device.type == "cpu":
        return compact_indices_torch(flags, capacity)
    dev_idx, stream = launch_env(flags)
    n = flags.shape[0]
    check_tensor(flags, "flags", torch.bool, flags.device, (n,))
    _check_capacity(capacity, n)
    _check_aligned(flags, "flags")
    plan = launch_plan(n, capacity, FLAGS_PER_VEC, 1, 1, max_blocks(dev_idx, "compact"))
    out = torch.empty((plan.buffer_ints,), dtype=torch.int32, device=flags.device)
    raise_on(_lib().compact_launch(dev_idx, flags.data_ptr(), n, plan.grid, plan.steps, capacity,
                                   out.data_ptr(), stream), "compact")
    launch_counts["compact"] += 1
    return out[:capacity], out[plan.count_at]


def pair_worklist(bits: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Kernel K5b: (row, col (capacity,) int32, count 0-dim int32) of the set
    bits of (R,) int32 words, column-major, -1 padded. On a CUDA tensor one
    cooperative launch; the outputs are views of one buffer."""
    if bits.device.type == "cpu":
        return pair_worklist_torch(bits, capacity)
    dev_idx, stream = launch_env(bits)
    r = bits.shape[0]
    check_tensor(bits, "bits", torch.int32, bits.device, (r,))
    _check_capacity(capacity, r * WORD_BITS)
    _check_aligned(bits, "bits")
    plan = launch_plan(r, capacity, WORDS_PER_VEC, 2, WORD_BITS, max_blocks(dev_idx, "pair_worklist"))
    out = torch.empty((plan.buffer_ints,), dtype=torch.int32, device=bits.device)
    raise_on(_lib().pair_launch(dev_idx, bits.data_ptr(), r, plan.grid, plan.steps, capacity,
                                out.data_ptr(), stream), "pair_worklist")
    launch_counts["pair_worklist"] += 1
    return out[:capacity], out[capacity:2 * capacity], out[plan.count_at]


def empty_launch(device: torch.device, cooperative: bool) -> None:
    """An empty kernel on `device`'s current stream: the launch floor the
    worklist kernels are timed beside. cooperative: launched as they are,
    K5a's wave of THREADS-thread blocks passing one grid barrier; else one
    block. Not counted in `launch_counts`."""
    dev_idx = device.index if device.index is not None else torch.cuda.current_device()
    grid = max_blocks(dev_idx, "compact") if cooperative else 1
    raise_on(_lib().floor_launch(dev_idx, grid, int(cooperative),
                                 torch.cuda.current_stream(device).cuda_stream), "floor")
