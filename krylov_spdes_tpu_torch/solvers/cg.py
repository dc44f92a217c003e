"""Conjugate-gradient solvers with the reference's iteration accounting.

Port of `krylov_spdes_tpu/solvers/cg.py` (reference: RecyclingKrylovSolvers/
cg.jl:14-109): the same update order, the same convergence test (||r|| <=
rtol·||b||, tested on the PREVIOUS residual before each step) and the same
count (`it` starts at 1 with the initial residual; the loop runs while
it < maxit and res > tol). PyTorch runs eagerly, so the loop is a host loop
that reads the stop test back once per iteration; on the card the A-apply of
a StencilOp is kernel A.
"""

from __future__ import annotations

import torch

from ..config import config
from .base import SolveResult, as_linear_op, as_precond_op, f32_exact


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _cg_impl(A, b, x0, maxit, rtol):
    x = x0.to(b.dtype)
    r = b - A(x)
    rTr = _dot(r, r)
    p = r
    res_norm = b.new_zeros(maxit)
    res_norm[0] = torch.sqrt(rTr)
    tol = rtol * torch.linalg.vector_norm(b)
    it = 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        Ap = A(p)
        d = _dot(p, Ap)
        alpha = rTr / d
        x = x + alpha * p
        r = r - alpha * Ap
        rTr_new = _dot(r, r)
        beta = rTr_new / rTr
        p = r + beta * p
        res_norm[it] = torch.sqrt(rTr_new)
        rTr = rTr_new
        it += 1
    return x, it, res_norm


@f32_exact
def cg(A, b, x=None, maxit: int = 0, rtol: float | None = None) -> SolveResult:
    """Plain CG (cg.jl:14-64). `maxit=0` means n, as in the reference."""
    n = b.shape[0]
    maxit = n if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    xs, it, res = _cg_impl(as_linear_op(A), b, x0, maxit, rtol)
    return SolveResult(x=xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=res)


def _pcg_impl(A, M, b, x0, maxit, rtol):
    x = x0.to(b.dtype)
    r = b - A(x)
    rTr = _dot(r, r)
    z = M(r)
    rTz = _dot(r, z)
    p = z
    res_norm = b.new_zeros(maxit)
    res_norm[0] = torch.sqrt(rTr)
    tol = rtol * torch.linalg.vector_norm(b)
    it = 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        Ap = A(p)
        d = _dot(p, Ap)
        alpha = rTz / d
        x = x + alpha * p
        r = r - alpha * Ap
        rTr = _dot(r, r)
        z = M(r)
        rTz_new = _dot(r, z)
        beta = rTz_new / rTz
        p = z + beta * p
        res_norm[it] = torch.sqrt(rTr)
        rTz = rTz_new
        it += 1
    return x, it, res_norm


@f32_exact
def pcg(A, b, x=None, M=None, maxit: int = 0,
        rtol: float | None = None) -> SolveResult:
    """Preconditioned CG (cg.jl:67-109)."""
    n = b.shape[0]
    maxit = n if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    xs, it, res = _pcg_impl(as_linear_op(A), as_precond_op(M), b, x0, maxit,
                            rtol)
    return SolveResult(x=xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=res)
