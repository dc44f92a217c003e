"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each source under `csrc/` becomes one shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use into `build/kernels/`
at the root of the checkout. All missing libraries are compiled at once, one
nvcc process per source. A library's file name carries a hash of its source,
the shared headers and the flags, so an edited source is rebuilt. Nothing
is compiled at import time: the CPU tests import every module on hosts
without nvcc.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCES = ("stencil_spmv", "fused_cg", "eigdef_stretch", "batched_proj",
           "stencil_cg")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --fmad=false: every product and sum rounds on its own, as the plain
# PyTorch versions' elementwise ops do, so kernel and plain version agree.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "port's CUDA kernels are built from csrc/ with nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is missing, all nvcc processes at once.
    Returns {name: seconds} for the libraries compiled by this call; the
    compiler's output (with `-Xptxas -v` register counts) goes to
    `build/kernels/<name>.log`. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"{library_path(name).name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if missing."""
    if name not in _libs:
        if not library_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")


def dtype_code(t) -> int:
    """0 for float32, 1 for float64: the kernels' template switch."""
    codes = {torch.float32: 0, torch.float64: 1}
    if t.dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or float64, not {t.dtype}")
    return codes[t.dtype]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(*tensors) -> None:
    """Every tensor on the same CUDA device, contiguous, of one float dtype."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"kernel inputs must share one dtype, got "
                            f"{t.dtype} and {dt}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
