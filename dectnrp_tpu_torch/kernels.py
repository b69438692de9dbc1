"""Build and load the hand-written CUDA kernels of `csrc/`.

All `csrc/*.cu` compile with nvcc for Hopper (`sm_90a`) into ONE shared
library with a plain C interface, loaded with ctypes. Nothing here includes
PyTorch's headers, so a cold build takes seconds. The library goes to
`_build/` (listed in .gitignore) under a name that carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is never
loaded. Pointers and the CUDA stream pass as `ctypes.c_void_p`; every entry
point returns its `cudaError_t` (0 = success).

Nothing is imported or built until the first kernel launch: the CPU tests
import every module of the port and never come here.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds: float | None = None   # wall time of this process's build/load
build_log: str = ""                  # nvcc's output (ptxas register/smem use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _declare(lib):
    import ctypes

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bcjr_posterior_cm.argtypes = [p, p, p, i, i, i, i, p]
    lib.bcjr_posterior_cm.restype = i
    lib.sync_detect_sm.argtypes = [p, p, p, i, i, i, i, i, i, i, f, f, p]
    lib.sync_detect_sm.restype = i
    return lib


def load():
    """The loaded kernel library (built on first call)."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    import ctypes

    t0 = time.perf_counter()
    srcs = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in sorted(_CSRC.glob("*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = _BUILD / f"libdectnrp_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    _lib = _declare(ctypes.CDLL(str(so)))
    build_seconds = time.perf_counter() - t0
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
