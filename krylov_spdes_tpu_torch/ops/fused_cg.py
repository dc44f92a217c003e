"""Fused-iteration stencil CG on a padded layout: kernels B, C and D.

Port of `krylov_spdes_tpu/ops/fused_cg.py`. Two solve paths, each with the
reference's update order and iteration accounting (cg.jl:14-109; `it`
starts at 1 with the initial residual, stop at ||r|| <= rtol·||b||):

1. `fused_cg` / `fused_pcg`: a host loop whose sweep
       pn ← z + β·p ; Ap ← A·pn ; d ← pnᵀAp       (kernel B, `cg_sweep`)
   is one kernel, with the axpys and rᵀr left to torch, as the JAX package
   leaves them to XLA (fused_cg.py:344-351).
2. `vmem_cg` / `vmem_pcg`: the whole (Jacobi-P)CG solve in one persistent
   cooperative launch (kernels C and D, `whole_cg` / `whole_pcg`), the
   Hopper counterpart of the TPU solve that stayed in VMEM: one block per
   SM, each holding a band of node rows in shared memory
   (`ops/persistent.py::whole_cg_plan`), two all-gather barriers an
   iteration. Where a band does not fit in shared memory the same kernel
   reads it from global memory; there is no size limit and no size
   switch.

Layout (Hopper's, not the TPU's 8-row/128-lane tiling): every vector is an
(R, C) row-major grid with R = H + 4 and C = W + 1 rounded up to 32 (a
128-byte row in float32); node (i, j) sits at row i + 2, column j. Rows 0,
1, H+2, H+3 and columns W..C-1 are zero in every vector and plane, so the
flat neighbours q ± 1, q ± C, q ± C ± 1 of a node are in bounds and read
zero beyond the grid: no kernel masks. The planes are stored unblocked,
(K, R, C): K = 9 (P0 + dir_diag, E, W, N, S, NE, SW, SE, NW) or the
symmetric K = 5 (D, E, N, NE, SE), chosen by an exact host-side probe.

Each kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor; `<wrapper>.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import cuda_build
from .persistent import sync_words, whole_cg_plan
from .stencil import StencilOp

ROW0 = 2     # zero rows above the first node row (csrc/fused_cg.cu kRow0)
_ALIGN = 32  # row pitch multiple, in elements


def _cdiv(a, b):
    return -(-a // b)


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass
class PaddedStencil:
    """Padded-layout stencil operator for kernels B, C and D.

    planes: (K, R, C); K=9 (full) or K=5 (symmetric: D, E, N, NE, SE bond
            planes; the diag plane includes the Dirichlet identity).
    """
    planes: torch.Tensor
    H: int
    W: int
    R: int
    C: int
    K: int


def _check_symmetric(p9: np.ndarray) -> bool:
    """Exact host-side check that the 9-plane stencil is symmetric:
    W/S/SW/NW are shifted copies of E/N/NE/SE (bit-equal, including zero
    borders where the bond partner falls outside the grid)."""
    E, W_, N, S = p9[1], p9[2], p9[3], p9[4]
    NE, SW, SE, NW = p9[5], p9[6], p9[7], p9[8]
    ok = (np.array_equal(W_[:, 1:], E[:, :-1]) and np.all(W_[:, 0] == 0)
          and np.array_equal(S[1:, :], N[:-1, :]) and np.all(S[0, :] == 0)
          and np.array_equal(SW[1:, 1:], NE[:-1, :-1])
          and np.all(SW[0, :] == 0) and np.all(SW[:, 0] == 0)
          and np.array_equal(NW[1:, :-1], SE[:-1, 1:])
          and np.all(NW[0, :] == 0) and np.all(NW[:, -1] == 0))
    return bool(ok)


def build_padded_stencil(St: StencilOp, sym: bool | None = None) -> PaddedStencil:
    """Build the padded-layout operator from a StencilOp. `sym=None` probes
    exact symmetry on the host and picks the 5-plane layout when it holds."""
    if sym is None:
        sym = _check_symmetric(St.planes.detach().cpu().numpy())
    ps = PaddedStencil(planes=None, H=St.H, W=St.W, R=St.H + 2 * ROW0,
                       C=_cdiv(St.W + 1, _ALIGN) * _ALIGN, K=5 if sym else 9)
    return refill_padded_stencil(ps, St)


def refill_padded_stencil(ps: PaddedStencil, St: StencilOp) -> PaddedStencil:
    """Per-realization value refill (fixed symbolic structure)."""
    p9 = St.planes
    p0 = p9[0] + St.dir_diag
    if ps.K == 5:
        pk = torch.stack([p0, p9[1], p9[3], p9[5], p9[7]])
    else:
        pk = torch.cat([p0[None], p9[1:]])
    planes = p9.new_zeros((ps.K, ps.R, ps.C))
    planes[:, ROW0:ROW0 + ps.H, :ps.W] = pk
    return dataclasses.replace(ps, planes=planes)


def pad_vec(ps: PaddedStencil, x_full: torch.Tensor) -> torch.Tensor:
    out = x_full.new_zeros((ps.R, ps.C))
    out[ROW0:ROW0 + ps.H, :ps.W] = x_full.reshape(ps.H, ps.W)
    return out


def unpad_vec(ps: PaddedStencil, xp: torch.Tensor) -> torch.Tensor:
    return xp[ROW0:ROW0 + ps.H, :ps.W].reshape(-1)


def _unblock_planes(ps: PaddedStencil) -> torch.Tensor:
    """The planes as one (K·R, C) array. The JAX package pre-blocks its
    planes into row tiles for the TPU's DMAs; Hopper's layout is stored
    unblocked, so this is a view."""
    return ps.planes.reshape(ps.K * ps.R, ps.C)


def _jacobi_minv(ps: PaddedStencil, planes_flat, mdiag_full):
    """Padded (R, C) inverse diagonal; zero on the pad rows and columns."""
    if mdiag_full is None:
        diag = planes_flat[:ps.R]        # K-plane 0 = diag (incl Dirichlet)
    else:
        diag = pad_vec(ps, mdiag_full)
    return torch.where(diag != 0, 1.0 / torch.where(diag == 0, 1.0, diag), 0.0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (the CPU path, and the card's
# comparison). Same sum order as the kernels.
# ---------------------------------------------------------------------------

def _nb(a, di, dj):
    """Value at (i, j) is a[i + di, j + dj]; what wraps around is pad (zero)
    at every node, as in the kernels' flat neighbour reads."""
    return torch.roll(a, shifts=(-di, -dj), dims=(0, 1))


def _apply_plain(ps: PaddedStencil, x: torch.Tensor) -> torch.Tensor:
    """A·x on the padded grid: the nodes' values, zero on the pads."""
    P = ps.planes
    xE, xW, xN, xS = _nb(x, 0, 1), _nb(x, 0, -1), _nb(x, 1, 0), _nb(x, -1, 0)
    xNE, xSW = _nb(x, 1, 1), _nb(x, -1, -1)
    xSE, xNW = _nb(x, 1, -1), _nb(x, -1, 1)
    if ps.K == 9:
        y = (P[0] * x + P[1] * xE + P[2] * xW + P[3] * xN + P[4] * xS
             + P[5] * xNE + P[6] * xSW + P[7] * xSE + P[8] * xNW)
    else:
        # symmetric bond form: the W/S/SW/NW bonds are the E/N/NE/SE bonds
        # of the neighbour on the other end
        D, E, N, NE, SE = P
        y = (D * x + E * xE + _nb(E, 0, -1) * xW + N * xN + _nb(N, -1, 0) * xS
             + NE * xNE + _nb(NE, -1, -1) * xSW + SE * xSE
             + _nb(SE, -1, 1) * xNW)
    out = torch.zeros_like(x)
    out[ROW0:ROW0 + ps.H, :ps.W] = y[ROW0:ROW0 + ps.H, :ps.W]
    return out


def cg_sweep_plain(ps: PaddedStencil, r, p, beta):
    """pn = r + β·p, Ap = A·pn, d = pnᵀAp."""
    pn = r + beta * p
    ap = _apply_plain(ps, pn)
    return pn, ap, torch.sum(pn * ap)


def whole_cg_plain(ps: PaddedStencil, bp, maxit: int, tol2):
    """The whole CG solve of kernel C: x, it (from 1), ‖r‖."""
    r = bp.clone()
    p = torch.zeros_like(bp)
    x = torch.zeros_like(bp)
    rTr = torch.sum(bp * bp)
    beta = bp.new_zeros(())
    it = 1
    while it < maxit and bool(rTr > tol2):
        pn = r + beta * p
        p = pn
        ap = _apply_plain(ps, pn)
        alpha = rTr / torch.sum(pn * ap)
        x = x + alpha * pn
        r = r - alpha * ap
        rTr_new = torch.sum(r * r)
        beta = rTr_new / rTr
        rTr = rTr_new
        it += 1
    return x, torch.tensor(it, dtype=torch.int32), torch.sqrt(rTr)


def whole_pcg_plain(ps: PaddedStencil, minv, bp, maxit: int, tol2):
    """The whole Jacobi-PCG solve of kernel D (cg.jl:67-109 order)."""
    r = bp.clone()
    p = torch.zeros_like(bp)
    x = torch.zeros_like(bp)
    rTr = torch.sum(bp * bp)
    rTz = torch.sum(bp * (minv * bp))
    beta = bp.new_zeros(())
    it = 1
    while it < maxit and bool(rTr > tol2):
        pn = minv * r + beta * p
        p = pn
        ap = _apply_plain(ps, pn)
        alpha = rTz / torch.sum(pn * ap)
        x = x + alpha * pn
        r = r - alpha * ap
        rTr = torch.sum(r * r)
        rTz_new = torch.sum(r * (minv * r))
        beta = rTz_new / rTz
        rTz = rTz_new
        it += 1
    return x, torch.tensor(it, dtype=torch.int32), torch.sqrt(rTr)


# ---------------------------------------------------------------------------
# Kernel wrappers (csrc/fused_cg.cu)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("fused_cg")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cg_sweep_blocks.argtypes = [ci, ci]
    lib.cg_sweep.argtypes = [ci, ci] + [vp] * 8 + [ci] * 3 + [vp]
    lib.whole_cg_limits.argtypes = [ci, ci, ci, vp]
    lib.whole_cg.argtypes = [ci] * 3 + [vp] * 11 + [ci] * 9 + [vp]
    for fn in (lib.cg_sweep_blocks, lib.cg_sweep, lib.whole_cg_limits,
               lib.whole_cg):
        fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def limits(code: int, K: int, pcg: bool, device: int) -> tuple[int, int]:
    """(SM count, the most dynamic shared memory a block of kernel C or D
    can ask for) on the current device."""
    lib = _lib()
    out = (ctypes.c_int * 2)()
    cuda_build.check(lib, lib.whole_cg_limits(code, K, int(pcg), out),
                     "whole_cg_limits")
    return out[0], out[1]


def plan_for(ps: PaddedStencil, b, pcg: bool):
    """The launch plan of kernel C (pcg False) or D on ps, in b's dtype on
    b's card."""
    code = cuda_build.dtype_code(b)
    with torch.cuda.device(b.device):
        sms, smem_max = limits(code, ps.K, pcg, b.device.index or 0)
    return whole_cg_plan(ps.H, ps.C, ps.K, pcg, b.element_size(), sms,
                         smem_max)


def _check_grid(ps: PaddedStencil, *grids):
    for g in grids:
        if g.shape != (ps.R, ps.C):
            raise ValueError(f"expected a padded ({ps.R}, {ps.C}) grid, got "
                             f"{tuple(g.shape)}")


def cg_sweep(ps: PaddedStencil, r, p, beta):
    """Kernel B: (pn, Ap, d) on a CUDA tensor; the plain version on a CPU
    tensor. beta is a 0-d tensor."""
    if r.device.type == "cpu":
        return cg_sweep_plain(ps, r, p, beta)
    cuda_build.require_cuda(ps.planes, r, p, beta)
    _check_grid(ps, r, p)
    lib = _lib()
    pn = torch.zeros_like(r)
    ap = torch.zeros_like(r)
    part = r.new_empty(lib.cg_sweep_blocks(ps.H, ps.W))
    d = r.new_empty(())
    c = cuda_build.ptr
    err = lib.cg_sweep(cuda_build.dtype_code(r), ps.K, c(ps.planes), c(r),
                       c(p), c(beta), c(pn), c(ap), c(part), c(d), ps.H, ps.W,
                       ps.C, cuda_build.stream(r))
    cuda_build.check(lib, err, "cg_sweep")
    cg_sweep.launches += 1
    return pn, ap, d


cg_sweep.launches = 0


def _whole(ps: PaddedStencil, minv, bp, maxit: int, tol2):
    """Launch kernel C (minv None) or D; returns (x, it, ‖r‖) on the card."""
    pcg = minv is not None
    cuda_build.require_cuda(ps.planes, bp, tol2, *((minv,) if pcg else ()))
    _check_grid(ps, bp, *((minv,) if pcg else ()))
    if any(t.data_ptr() % 16 for t in (ps.planes, bp, *((minv,) if pcg else ()))):
        raise ValueError("kernels C and D read the planes, b and minv 16 "
                         "bytes at a time: they must be 16-byte aligned")
    lib = _lib()
    code = cuda_build.dtype_code(bp)
    plan = plan_for(ps, bp, pcg)
    x = torch.zeros_like(bp)
    rg, pg = torch.empty_like(bp), torch.empty_like(bp)   # the halo slots
    sync = torch.zeros(sync_words(plan.grid), dtype=torch.int32,
                       device=bp.device)
    scratch = bp.new_empty(1 if plan.vectors else plan.grid * plan.scratch_elems)
    it = torch.empty((), dtype=torch.int32, device=bp.device)
    res = bp.new_empty(())
    c = cuda_build.ptr
    err = lib.whole_cg(code, ps.K, int(pcg), c(ps.planes),
                       c(minv) if pcg else None, c(bp), c(tol2), c(x), c(rg),
                       c(pg), c(sync), c(scratch), c(it), c(res), ps.H, ps.W,
                       ps.C, int(maxit), plan.grid, plan.nrmax,
                       int(plan.vectors), int(plan.planes), plan.smem,
                       cuda_build.stream(bp))
    cuda_build.check(lib, err, "whole_pcg" if pcg else "whole_cg")
    return x, it, res


def whole_cg(ps: PaddedStencil, bp, maxit: int, tol2):
    """Kernel C on a CUDA tensor, its plain version on a CPU tensor."""
    if bp.device.type == "cpu":
        return whole_cg_plain(ps, bp, maxit, tol2)
    out = _whole(ps, None, bp, maxit, tol2)
    whole_cg.launches += 1
    return out


def whole_pcg(ps: PaddedStencil, minv, bp, maxit: int, tol2):
    """Kernel D on a CUDA tensor, its plain version on a CPU tensor."""
    if bp.device.type == "cpu":
        return whole_pcg_plain(ps, minv, bp, maxit, tol2)
    out = _whole(ps, minv, bp, maxit, tol2)
    whole_pcg.launches += 1
    return out


whole_cg.launches = 0
whole_pcg.launches = 0


# ---------------------------------------------------------------------------
# Solvers: the same (x_full, it, res) as the JAX package's
# ---------------------------------------------------------------------------

def fused_cg(ps: PaddedStencil, b_full, maxit: int = 0, rtol: float = 1e-7):
    """CG on the padded layout, one kernel-B sweep per iteration. Returns
    (x_full (n,), it, res_norm history (maxit,))."""
    maxit = ps.H * ps.W if maxit == 0 else maxit
    bp = pad_vec(ps, b_full)
    rTr = _dot(bp, bp)
    res0 = torch.sqrt(rTr)
    tol = rtol * res0
    res_norm = bp.new_zeros(maxit)
    res_norm[0] = res0
    x = torch.zeros_like(bp)
    r, p, beta = bp, bp, bp.new_zeros(())
    it = 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        pn, ap, d = cg_sweep(ps, r, p, beta)
        alpha = rTr / d
        x = x + alpha * pn
        r = r - alpha * ap
        rTr_new = _dot(r, r)
        beta = rTr_new / rTr
        res_norm[it] = torch.sqrt(rTr_new)
        rTr, p = rTr_new, pn
        it += 1
    return unpad_vec(ps, x), torch.tensor(it, dtype=torch.int32), res_norm


def fused_pcg(ps: PaddedStencil, b_full, mdiag_full=None, maxit: int = 0,
              rtol: float = 1e-7):
    """Jacobi-PCG on the padded layout, kernel B with z in place of r.
    `mdiag_full` (n,) overrides the Jacobi diagonal (defaults to A's own).
    Same iteration semantics as solvers.pcg (cg.jl:67-109). Returns
    (x_full (n,), it, res_norm history (maxit,))."""
    maxit = ps.H * ps.W if maxit == 0 else maxit
    bp = pad_vec(ps, b_full)
    minv = _jacobi_minv(ps, _unblock_planes(ps), mdiag_full).to(bp.dtype)
    res0 = torch.sqrt(_dot(bp, bp))
    tol = rtol * res0
    res_norm = bp.new_zeros(maxit)
    res_norm[0] = res0
    x = torch.zeros_like(bp)
    r = bp
    z = minv * bp
    rTz = _dot(bp, z)
    p, beta = torch.zeros_like(bp), bp.new_zeros(())
    it = 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        pn, ap, d = cg_sweep(ps, z, p, beta)
        alpha = rTz / d
        x = x + alpha * pn
        r = r - alpha * ap
        z = minv * r
        rTz_new = _dot(r, z)
        beta = rTz_new / rTz
        res_norm[it] = torch.sqrt(_dot(r, r))
        rTz, p = rTz_new, pn
        it += 1
    return unpad_vec(ps, x), torch.tensor(it, dtype=torch.int32), res_norm


def _tol2(bp, rtol):
    return torch.tensor(rtol, dtype=bp.dtype, device=bp.device) ** 2 * _dot(bp, bp)


def vmem_cg(ps: PaddedStencil, b_full, maxit: int = 0, rtol: float = 1e-7):
    """The whole CG solve in one launch of kernel C. Same semantics as
    solvers.cg (cg.jl:14-64). Returns (x_full (n,), it, final ‖r‖), it and
    ‖r‖ as 0-d tensors on the device of b_full."""
    maxit = ps.H * ps.W if maxit == 0 else maxit
    bp = pad_vec(ps, b_full)
    x, it, res = whole_cg(ps, bp, maxit, _tol2(bp, rtol))
    return unpad_vec(ps, x), it, res


def vmem_pcg(ps: PaddedStencil, b_full, mdiag_full=None, maxit: int = 0,
             rtol: float = 1e-7):
    """The whole Jacobi-PCG solve in one launch of kernel D. `mdiag_full`
    (n,) is the operator diagonal (defaults to the stencil's own); the
    kernel applies M⁻¹ = diag(1/mdiag). Same semantics as solvers.pcg
    (cg.jl:67-109). Returns (x_full, it, final ‖r‖)."""
    maxit = ps.H * ps.W if maxit == 0 else maxit
    bp = pad_vec(ps, b_full)
    minv = _jacobi_minv(ps, _unblock_planes(ps), mdiag_full).to(bp.dtype)
    x, it, res = whole_pcg(ps, minv, bp, maxit, _tol2(bp, rtol))
    return unpad_vec(ps, x), it, res
