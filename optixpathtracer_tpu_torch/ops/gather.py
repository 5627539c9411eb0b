"""Random row gather `out[i] = table[idx[i]]`, kernel K6 (port of the
SparseCore `load_gather` kernel in experiments/sparsecore_probe.py).

`gather_rows` takes its plain PyTorch version, `gather_rows_torch`
(`table.index_select(0, idx)`), for CPU tensors and launches its CUDA
kernel (csrc/gather.cu) for CUDA tensors, or raises; there is no fallback
from one to the other. `launch_counts` counts kernel launches.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from .cuda_build import check_tensor, launch_env, load, raise_on

Tensor = torch.Tensor

# kernel name -> launches since the last clear()
launch_counts: collections.Counter = collections.Counter()


def gather_rows_torch(table: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version of kernel K6: (n, w) rows of a (rows, w) table."""
    return table.index_select(0, idx)


@functools.cache
def _lib():
    lib = load("gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_launch.argtypes = [i, p, p, ctypes.c_longlong, i, i, i, p, p]
    lib.gather_launch.restype = ctypes.c_int
    return lib


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """Kernel K6: table (rows, w) f32, idx (n,) int32 in [0, rows) -> (n, w)
    f32. On the card an index outside [0, rows) yields a row of NaN; the
    plain version raises for it."""
    if table.device.type == "cpu":
        return gather_rows_torch(table, idx)
    dev_idx, stream = launch_env(table)
    rows, w = table.shape
    n = idx.shape[0]
    check_tensor(table, "table", torch.float32, table.device, (rows, w))
    check_tensor(idx, "idx", torch.int32, table.device, (n,))
    if rows >= 2**31 or w >= 2**31:
        raise ValueError(f"table shape {tuple(table.shape)} exceeds the kernel's int32 sizes")
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    vec4 = w % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    raise_on(_lib().gather_launch(dev_idx, table.data_ptr(), idx.data_ptr(), n, rows, w, int(vec4),
                                  out.data_ptr(), stream), "gather")
    launch_counts["gather"] += 1
    return out
