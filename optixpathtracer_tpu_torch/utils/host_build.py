"""Build and load the port's native host libraries.

`csrc/host/accel.cpp` (the acceleration-structure builders) and
`csrc/host/objparser.cpp` (the OBJ tokenizer) are copies of the reference's
`native/src/` sources; `csrc/host/j2k_t1.cpp` (JPEG 2000 tier 1, the twin
of `io/codecs/j2k_t1.py`) and `csrc/host/av1_dec.cpp` (the AV1 tile
decoder of AVIF, with its tables in `av1_tables.h`) are the port's own. On first use each is compiled
with the reference's command, `g++ -O2 -shared -fPIC`, into `_build/`
(listed in .gitignore),
keyed by a hash of the source and the flags, and loaded with ctypes. A build
goes to a temporary name first and is moved into place with `os.replace`,
so processes that build the same library at once never load a half-written
file.

`OPTIX_TPU_NO_NATIVE=1` (read at call time) turns the libraries off and the
callers take their numpy / Python paths, as in the reference. Otherwise a
failed build raises: the native and numpy `treelet_order` give different
cluster orders, and tier 1 in Python takes seconds where the native one
takes milliseconds, so which one ran must not depend on whether a compiler
happened to be present.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # name -> g++ wall time (0.0 when cached)


def native_enabled() -> bool:
    """False when OPTIX_TPU_NO_NATIVE is set to anything but "" or "0"."""
    return os.environ.get("OPTIX_TPU_NO_NATIVE", "") in ("", "0")


def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/host/<name>.cpp` if needed and return the library."""
    with _locks.setdefault(name, threading.Lock()):
        if name in _libs:
            return _libs[name]
        src = SRC_DIR / f"{name}.cpp"
        # the headers beside the sources (av1_tables.h) are part of the key
        headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.h")))
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        build_seconds[name] = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.{threading.get_ident()}.tmp"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                                      capture_output=True, text=True, timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(f"g++ not found: the native builder {src.name} cannot be "
                                   "built (set OPTIX_TPU_NO_NATIVE=1 for the numpy path)") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
