"""Build, load and launch the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. On first use it is compiled
with nvcc for Hopper into `_build/` (listed in .gitignore), keyed by a hash
of the source and the flags, and loaded with ctypes. Nothing is built when
a module is imported, so the CPU-only test machines (no nvcc) import every
module freely; only a launch on a CUDA tensor reaches this code. Different
sources build concurrently when `load` is called from several threads.

    -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false

`--fmad=false` and the absence of fast math keep every f32 operation
rounded once, so the kernels agree bit for bit with their PyTorch versions.

`check_tensor`, `launch_env` and `raise_on` are the wrappers' shared checks
before and after a launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_locks: dict[str, threading.Lock] = {}  # one per source: different sources build concurrently
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0.0 when cached), "ptxas": nvcc's stderr}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    with _locks.setdefault(name, threading.Lock()):
        if name in _libs:
            return _libs[name]
        src = SRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        info = {"seconds": 0.0, "ptxas": ""}
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            info = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
        lib = ctypes.CDLL(str(so))
        build_info[name] = info
        _libs[name] = lib
        return lib


def check_tensor(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    """Raise unless t has the dtype, device, shape and contiguity a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_env(x: torch.Tensor):
    """(device index, stream handle) for a launch on x's CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(x.device).cuda_stream


def raise_on(rc: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")
