"""Random row gather bandwidth on the card (port of
experiments/sparsecore_probe.py; its SparseCore `load_gather` kernel is
kernel K6, `ops/gather.gather_rows`, here).

    python -m optixpathtracer_tpu_torch.experiments.gather_probe

On a (1<<20, 128) f32 table (512 MiB, on the device) filled with arange,
and random int32 row indices drawn with numpy seed 0 for each size, as the
reference's probe makes them, it times the plain gather (`index_select`)
and kernel K6 at 64k and 1M indices and prints one JSON line: the device
name, its power limit, and GB/s of gathered rows (n * 128 * 4 bytes) per
second for each. Times are CUDA events over 5 calls after a warm-up call.
It fails without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..ops.gather import gather_rows, gather_rows_torch

N_ROWS, ROW_WIDTH = 1 << 20, 128
SIZES = {"64k": 1 << 16, "1m": 1 << 20}


def probe_table(device, n_rows: int = N_ROWS, row_width: int = ROW_WIDTH) -> torch.Tensor:
    """The (n_rows, row_width) f32 arange table on `device`."""
    return torch.arange(n_rows * row_width, dtype=torch.float32, device=device).reshape(
        n_rows, row_width)


def probe_indices(device, n_idx: int, n_rows: int = N_ROWS) -> torch.Tensor:
    """(n_idx,) int32 row indices from numpy seed 0, on `device`."""
    idx = np.random.default_rng(0).integers(0, n_rows, size=n_idx).astype(np.int32)
    return torch.as_tensor(idx, device=device)


def gbs(fn, n_idx: int, row_width: int = ROW_WIDTH, iters: int = 5) -> float:
    """GB/s of gathered rows of fn() on the current CUDA device."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    seconds = e0.elapsed_time(e1) / 1e3 / iters
    return n_idx * row_width * 4 / seconds / 1e9


def measure(device) -> dict:
    """GB/s of the plain gather and of kernel K6 at each of SIZES."""
    if device.type != "cuda":
        raise RuntimeError(f"the gather probe measures a CUDA device, not {device}")
    table = probe_table(device)
    res = {}
    for name, n in SIZES.items():
        idx = probe_indices(device, n)
        res[f"plain_gather_gbs_{name}"] = gbs(lambda: gather_rows_torch(table, idx), n)
        res[f"kernel_gather_gbs_{name}"] = gbs(lambda: gather_rows(table, idx), n)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_probe: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"device_kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "table": [N_ROWS, ROW_WIDTH]}
    res.update(measure(torch.device("cuda")))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
