"""Kernel H: a whole CG solve in one launch on the unpadded 9-plane layout.

Port of `krylov_spdes_tpu/ops/pallas_cg.py` (`_cg_kernel`, called by
`stencil_cg_pallas`). The CUDA kernel is `csrc/stencil_cg.cu`: one
persistent cooperative launch of one block per SM, each block holding a
band of node rows in shared memory (`ops/persistent.py::stencil_cg_plan`),
two all-gather barriers an iteration, fixed-order reductions, `it` and the
residual written on the device. Unlike
kernels C and D (ops/fused_cg.py) it takes the `StencilOp` as it is: nine
(H, W) planes, `dir_diag` added inside the kernel, no padding by the host
and no symmetric 5-plane form.

Semantics are those of solvers/cg.py (iteration accounting from 1,
stop at rᵀr <= rtol²·bᵀb, identity rows on Dirichlet nodes).

`stencil_cg` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; `stencil_cg.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build
from .persistent import stencil_cg_plan, sync_words
from .stencil import OFFSETS, StencilOp


def stencil_cg_plain(S: StencilOp, b: torch.Tensor, maxit: int, rtol: float):
    """The solve of kernel H in plain PyTorch, step by step as the TPU
    kernel takes it (the direction kept in a zero-ringed copy). Returns
    (x (n,), it int32, ‖r‖), `it` and ‖r‖ as 0-d tensors."""
    H, W = S.H, S.W
    b2 = b.reshape(H, W)
    d0 = S.planes[0] + S.dir_diag
    rTr = torch.sum(b2 * b2)
    tol2 = (rtol * rtol) * rTr
    r, p, x = b2.clone(), b2.clone(), torch.zeros_like(b2)
    it = 1
    while it < maxit and bool(rTr > tol2):
        pp = F.pad(p, (1, 1, 1, 1))
        ap = d0 * p
        for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
            ap = ap + S.planes[k] * pp[1 + di:1 + di + H, 1 + dj:1 + dj + W]
        alpha = rTr / torch.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        rTr_new = torch.sum(r * r)
        beta = rTr_new / rTr
        p = r + beta * p
        rTr = rTr_new
        it += 1
    return (x.reshape(-1), torch.tensor(it, dtype=torch.int32, device=b.device),
            torch.sqrt(rTr))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("stencil_cg")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.stencil_cg_limits.argtypes = [ci, vp]
    lib.stencil_cg.argtypes = ([ci] + [vp] * 10 + [ci] * 3
                               + [ctypes.c_double] + [ci] * 5 + [vp])
    lib.stencil_cg_limits.restype = ci
    lib.stencil_cg.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def limits(code: int, device: int) -> tuple[int, int]:
    """(SM count, the most dynamic shared memory a block of kernel H can
    ask for) on the current device."""
    lib = _lib()
    out = (ctypes.c_int * 2)()
    cuda_build.check(lib, lib.stencil_cg_limits(code, out), "stencil_cg_limits")
    return out[0], out[1]


def plan_for(b: torch.Tensor, H: int, W: int):
    """Kernel H's launch plan for a solve of an (H, W) grid on b's card."""
    code = cuda_build.dtype_code(b)
    with torch.cuda.device(b.device):
        sms, smem_max = limits(code, b.device.index or 0)
    return stencil_cg_plan(H, W, b.element_size(), sms, smem_max)


def stencil_cg(S: StencilOp, b: torch.Tensor, maxit: int, rtol: float):
    """Solve A x = b with kernel H on a CUDA tensor, with its plain version
    on a CPU tensor. Returns (x (n,), it, final ‖r‖), `it` (int32) and ‖r‖
    0-d tensors on the device of b."""
    if b.device.type == "cpu":
        return stencil_cg_plain(S, b, maxit, rtol)
    H, W = S.H, S.W
    cuda_build.require_cuda(S.planes, S.dir_diag, b)
    if (S.planes.shape != (9, H, W) or S.dir_diag.shape != (H, W)
            or b.numel() != H * W):
        raise ValueError(f"stencil_cg: planes {tuple(S.planes.shape)}, "
                         f"dir_diag {tuple(S.dir_diag.shape)}, "
                         f"b {tuple(b.shape)}")
    lib = _lib()
    code = cuda_build.dtype_code(b)
    plan = plan_for(b, H, W)
    x, rg, pg = (b.new_empty((H, W)) for _ in range(3))
    sync = torch.zeros(sync_words(plan.grid), dtype=torch.int32,
                       device=b.device)
    scratch = b.new_empty(1 if plan.vectors else plan.grid * plan.scratch_elems)
    it = torch.empty((), dtype=torch.int32, device=b.device)
    res = b.new_empty(())
    c = cuda_build.ptr
    err = lib.stencil_cg(code, c(S.planes), c(S.dir_diag), c(b), c(x), c(rg),
                         c(pg), c(sync), c(scratch), c(it), c(res),
                         H, W, int(maxit), float(rtol) * float(rtol),
                         plan.grid, plan.nrmax, int(plan.vectors),
                         int(plan.planes), plan.smem, cuda_build.stream(b))
    cuda_build.check(lib, err, "stencil_cg")
    stencil_cg.launches += 1
    return x.reshape(-1), it, res


stencil_cg.launches = 0
