"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. On first use it is compiled
with nvcc for Hopper into `_build/` (listed in .gitignore), keyed by a hash
of the source and the flags, and loaded with ctypes. Nothing is built when
a module is imported, so the CPU-only test machines (no nvcc) import every
module freely; only a launch on a CUDA tensor reaches this code.

    -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false

`--fmad=false` and the absence of fast math keep every f32 operation
rounded once, so the kernels agree bit for bit with their PyTorch versions.
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

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
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
    with _lock:
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
