"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` compiles with its own nvcc for Hopper (`sm_90a`), all of
them at once, and the objects link into ONE shared library with a plain C
interface, loaded with ctypes. Nothing here includes PyTorch's headers, so a
cold build takes seconds. The library goes to
`_build/` (listed in .gitignore) under a name that carries a hash of the
sources and flags, so an edited source rebuilds and a stale library is never
loaded. Pointers and the CUDA stream pass as `ctypes.c_void_p`; every entry
point returns its `cudaError_t` (0 = success).

Nothing is imported or built until the first kernel launch: the CPU tests
import every module of the port and never come here. `graph_us` (a call's
device time by CUDA-graph replay) and `card_name` serve chip_smoke.py and
the tools that time this tree's kernels against another tree's
(`*_turns.py`); `build_one` builds that other tree's source.
`launch_counts` reads the wrappers' launch counters, `LAUNCH_KEYS` (which
chip_smoke.py, scaling.py and the children of dcn_dryrun.py report), and
beside them the program's own counters and spans (`common/trace.py`).
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
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds: float | None = None   # wall time of this process's build/load
build_log: str = ""                  # nvcc's output (ptxas register/smem use),
                                     # kept beside the library


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
    lib.bcjr_blocks_per_sm.argtypes = [i]
    lib.bcjr_blocks_per_sm.restype = i
    lib.bcjr_posterior_cm_bf16.argtypes = [p, p, p, i, i, i, i, p]
    lib.bcjr_posterior_cm_bf16.restype = i
    lib.bcjr_bf16_blocks_per_sm.argtypes = [i]
    lib.bcjr_bf16_blocks_per_sm.restype = i
    lib.sync_detect_sm.argtypes = [p, p, p, i, i, i, i, i, i, i, f, f, f, f, i,
                                   i, p]
    lib.sync_detect_sm.restype = i
    lib.sync_detect_blocks_per_sm.argtypes = [i, i, i]
    lib.sync_detect_blocks_per_sm.restype = i
    lib.polyphase_fir.argtypes = [p, p, ctypes.POINTER(i), p, i, i, i, i, i, i,
                                  i, i, p]
    lib.polyphase_fir.restype = i
    lib.polyphase_blocks_per_sm.argtypes = [i, i, i]
    lib.polyphase_blocks_per_sm.restype = i
    lib.sync_report.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                f, f, f, i, f, f, f, f, p]
    lib.sync_report.restype = i
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
        objs = [tmp.with_suffix(f".{s.stem}.o") for s in srcs]
        procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        build_log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        res = subprocess.run(
            [_nvcc(), *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        for o in objs:
            o.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{build_log}")
        so.with_suffix(".log").write_text(build_log)
        os.replace(tmp, so)
    elif so.with_suffix(".log").exists():
        build_log = so.with_suffix(".log").read_text()
    _lib = _declare(ctypes.CDLL(str(so)))
    build_seconds = time.perf_counter() - t0
    return _lib


#: the kernel launch counters of `launch_counts`
LAUNCH_KEYS = ("bcjr", "bcjr_one_window", "bcjr_bf16", "sync", "polyphase",
               "sync_report")


def launch_counts() -> dict:
    """The program's counters so far in this process: kernel launches by
    kernel (LAUNCH_KEYS: each wrapper adds one where it launches its
    kernel, B1 also counts its one-window launches apart, and nowhere
    else), then every counter and span aggregate of `trace.counters()`."""
    from .common import trace
    from .phy.fec import bcjr_cuda
    from .phy.ops import polyphase, sync_detect, sync_report
    return {"bcjr": bcjr_cuda.launches,
            "bcjr_one_window": bcjr_cuda.launches_one_window,
            "bcjr_bf16": bcjr_cuda.launches_bf16,
            "sync": sync_detect.launches, "polyphase": polyphase.launches,
            "sync_report": sync_report.launches, **trace.counters()}


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def build_one(src: pathlib.Path, name: str):
    """Build one kernel source (another tree's, to time against this one)
    into its own library `_build/<name>.so` and load it; the caller declares
    its entry points."""
    import ctypes

    _BUILD.mkdir(parents=True, exist_ok=True)
    so = _BUILD / f"{name}.so"
    subprocess.run([_nvcc(), *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


def graph_us(fn, reps: int = 20) -> float:
    """Device time of one fn() call (us): CUDA events around 5 replays of a
    CUDA graph of `reps` calls, after a warm-up on a side stream. Unlike
    eager back-to-back calls, no host launch gap lies between the launches
    (a call of tens of microseconds is otherwise timed at the Python
    wrapper's rate)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(5):
        g.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e3 / (5 * reps)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
