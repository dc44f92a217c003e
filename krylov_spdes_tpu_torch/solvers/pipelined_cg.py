"""Pipelined PCG (Ghysels & Vanroose): one fused reduction an iteration.

Port of `krylov_spdes_tpu/solvers/pipelined_cg.py`. Standard PCG has two
dependent scalar reductions an iteration (p·Ap before the update, r·z
after the preconditioner); pipelined PCG computes both scalars (γ = r·u,
δ = w·u) together from vectors already at hand, so that with sharded
vectors the iteration has one reduction phase, overlappable with the
matvec and the preconditioner. Cost: one extra preconditioner apply and
~3 extra vector updates an iteration; equal to PCG up to rounding.

Reference: Ghysels & Vanroose, "Hiding global synchronization latency in
the preconditioned Conjugate Gradient algorithm", Parallel Computing 40
(2014).
"""

from __future__ import annotations

import torch

from ..config import config
from .base import SolveResult, as_linear_op, as_precond_op, f32_exact
from .cg import _dot


@f32_exact
def _pipecg_impl(A, M, b, x0, maxit, rtol):
    x = x0.to(b.dtype)
    r = b - A(x)
    u = M(r)
    w = A(u)
    res_norm = b.new_zeros(maxit)
    res_norm[0] = torch.linalg.vector_norm(r)
    tol = rtol * torch.linalg.vector_norm(b)
    z = q = s = p = torch.zeros_like(b)
    gamma_old = alpha_old = None
    it = 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        # the two scalars come from one fused reduction over (r, w) x u
        gamma = _dot(r, u)
        delta = _dot(w, u)
        m = M(w)
        n = A(m)
        if it == 1:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - beta * gamma / alpha_old)
        z = n + beta * z
        q = m + beta * q
        s = w + beta * s
        p = u + beta * p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        res_norm[it] = torch.linalg.vector_norm(r)
        gamma_old, alpha_old = gamma, alpha
        it += 1
    return x, it, res_norm


def pipelined_pcg(A, b, x=None, M=None, maxit: int = 0,
                  rtol: float | None = None) -> SolveResult:
    """Pipelined PCG: the convergence of pcg() up to rounding, one global
    reduction point an iteration."""
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    xs, it, res = _pipecg_impl(as_linear_op(A), as_precond_op(M), b, x0,
                               maxit, rtol)
    return SolveResult(x=xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=res)
