"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each source `csrc/<name>.cu` becomes one shared library with a plain C
interface, `_build/lib<name>-<digest>.so`, where the digest covers the
source, the shared headers and the flags, so that an edited source is
rebuilt and a stale library is never loaded. Nothing is built or loaded
when this module is imported: `build()` starts one nvcc per missing
library, all at once, and waits for every one of them.

Every C entry point takes device pointers and the CUDA stream as
`void*`, launches on that stream, does not synchronise, and returns the
`cudaError_t` of the launch (0 on success). `Kernel.__call__` raises on
any other value and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fft", "rot_decomp", "mad", "fence", "phase", "probe")
HEADERS = ("common.cuh", "ds.cuh")
# -fmad=false: no FP contraction, which would break the ds32 error-free
# transforms; no fast-math for the same reason
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build(names=SOURCES) -> dict:
    """Build every missing library among `names`, one nvcc each, all
    started together. Returns {name: seconds} for the libraries built
    (0.0 for one already present) and writes each nvcc's ptxas report to
    `_build/<name>.log`. Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    times = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            times[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, out, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "wb") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc {proc.returncode})\n{log.decode(errors='replace')}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build((name,))
        lib = ctypes.CDLL(path)
        lib.spf_error_string.argtypes = [ctypes.c_int]
        lib.spf_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


class Kernel:
    """One C entry point of a kernel library. Arguments are ints: a
    tensor's `data_ptr()` or the stream for each `ptr`, else a C int.
    `launches` counts the successful launches."""

    def __init__(self, lib: str, symbol: str, argspec: str):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = [ctypes.c_void_p if a == "p" else ctypes.c_int for a in argspec]
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library(self.lib).spf_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dispatch(name: str, t: torch.Tensor, kernel, plain, *args):
    """`kernel(*args)` when `t` is a CUDA tensor, `plain(*args)` when it
    is a CPU tensor; any other device raises."""
    if t.is_cuda:
        return kernel(*args)
    if t.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return plain(*args)


def check_cuda(name: str, *tensors, dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype`
    (any dtype for None) on the device of the first."""
    dev = tensors[0].device
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: kernels launch on the current device, not {dev}")
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
