"""ctypes binding of the repo's native (C++) mesh partitioner.

Port of `krylov_spdes_tpu/fem/native.py`. The source is the repo's own
`native/partition.cpp` (RCB + FM boundary refinement + contiguity repair);
it is compiled with the host C++ compiler at first use into `build/native/`
at the root of the checkout (never into `native/`), with the flags of
`native/Makefile`, so that both packages compute the same partition. The
library's file name carries a hash of the source, the flags and, because
`-march=native` ties the code to the CPU it was compiled on, the host's
architecture and CPU feature flags: a `build/` copied to another machine is
rebuilt there rather than loaded.

Unlike the JAX package's binding, this one has no fallback: when the library
cannot be built or loaded, `native_partition` raises. The NumPy partitioner
gives a different partition, hence a different Schur system; a caller that
wants it asks for it (`mesh_partition(use_native=False)`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "partition.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_LIB = None


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (CXX, g++, c++, clang++): the "
                       "native partitioner is built from native/partition.cpp")


def _host_cpu() -> str:
    """The architecture and, where the system tells them, the CPU's feature
    flags: what `-march=native` compiles for."""
    flags = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("flags", "Features")):
                flags = " ".join(sorted(line.split(":", 1)[1].split()))
                break
    except OSError:
        pass
    return f"{platform.machine()} {flags}"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXXFLAGS).encode()
                            + _host_cpu().encode()).hexdigest()
    return BUILD_DIR / f"libkrylov_native-{digest[:12]}.so"


def load_native() -> ctypes.CDLL:
    """The native library, built first if missing. Raises if the source, the
    compiler or the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not SOURCE.exists():
        raise RuntimeError(f"native partitioner source not found: {SOURCE}")
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([_compiler(), *CXXFLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{out.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.partition_mesh.restype = ctypes.c_int64
    lib.partition_mesh.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    _LIB = lib
    return lib


def native_partition(cell_neighbors: np.ndarray, centroids: np.ndarray,
                     ndom: int, refine_passes: int = 8):
    """Contiguous ndom-way partition through the C++ library. Returns
    (epart, edge_cut); raises when the library is unavailable."""
    lib = load_native()
    nel = centroids.shape[0]
    nbr = np.ascontiguousarray(cell_neighbors, dtype=np.int32)
    cen = np.ascontiguousarray(centroids, dtype=np.float64)
    epart = np.empty(nel, dtype=np.int32)
    cut = lib.partition_mesh(nel, nbr, cen, ndom, refine_passes, epart)
    return epart, int(cut)
