"""Kernel A: the 9-point stencil SpMV, its plain PyTorch version and its
wrapper.

Replaces `krylov_spdes_tpu/ops/pallas_stencil.py::_kernel` (called by
`stencil_matvec_pallas`). The CUDA kernel is `csrc/stencil_spmv.cu`: one
thread per node, coalesced row-major reads of the 9 planes and of x, the
grid edge handled by bounds checks. On an H100 it is bound by bytes: 12
values a node (9 planes, dir_diag, x in; y out), about 3.6 µs at 250k
float32 nodes at 3.35 TB/s.

`stencil_spmv` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; `stencil_spmv.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

# (di, dj) neighbor offsets (row, column): self, E, W, N, S, NE, SW, SE, NW.
# The CUDA kernel hard-codes this order.
OFFSETS = [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
           (1, 1), (-1, -1), (1, -1), (-1, 1)]


def stencil_spmv_plain(planes: torch.Tensor, dir_diag: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """y = (P0 + dir_diag)⊙x + Σ_k P_k⊙shift_k(x), zero beyond the grid;
    x and y are flat (H·W,) vectors, planes (9, H, W)."""
    H, W = dir_diag.shape
    x2 = x.reshape(H, W)
    xp = F.pad(x2, (1, 1, 1, 1))
    y = (planes[0] + dir_diag) * x2
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        y = y + planes[k] * xp[1 + di:1 + di + H, 1 + dj:1 + dj + W]
    return y.reshape(-1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("stencil_spmv")
    lib.stencil_spmv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.stencil_spmv.restype = ctypes.c_int
    return lib


def stencil_spmv(planes: torch.Tensor, dir_diag: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return stencil_spmv_plain(planes, dir_diag, x)
    H, W = dir_diag.shape
    cuda_build.require_cuda(planes, dir_diag, x)
    if planes.shape != (9, H, W) or x.shape != (H * W,):
        raise ValueError(f"stencil_spmv: planes {tuple(planes.shape)}, "
                         f"dir_diag {tuple(dir_diag.shape)}, x {tuple(x.shape)}")
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.stencil_spmv(cuda_build.dtype_code(x), cuda_build.ptr(planes),
                           cuda_build.ptr(dir_diag), cuda_build.ptr(x),
                           cuda_build.ptr(y), H, W, cuda_build.stream(x))
    cuda_build.check(lib, err, "stencil_spmv")
    stencil_spmv.launches += 1
    return y


stencil_spmv.launches = 0
