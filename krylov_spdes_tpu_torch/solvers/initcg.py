"""Init-CG / Init-PCG: deflated initial guess, then plain (P)CG.

Port of `krylov_spdes_tpu/solvers/initcg.py` (reference:
RecyclingKrylovSolvers/initcg.jl:28-159, Erhel & Guyomarc'h 2000; the
reference's `initpcg` uses `z` before allocation, initcg.jl:134, and the
correct algorithm is implemented here, as in the JAX package).
"""

from __future__ import annotations

import torch

from ..config import config
from .base import SolveResult, as_linear_op, as_precond_op, f32_exact
from .cg import _cg_impl, _pcg_impl
from .defcg import _deflation_setup, _plain_result


@f32_exact
def deflated_guess(A, b, x0, W):
    """x0 + W (WᵀAW)⁻¹ Wᵀ(b - A x0)."""
    return _deflation_setup(A, W, x0, b)[2]


@f32_exact
def initcg(A, b, x=None, W=None, maxit: int = 0,
           rtol: float | None = None) -> SolveResult:
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    Afn = as_linear_op(A)
    x0 = deflated_guess(Afn, b, x0, W)
    return _plain_result(_cg_impl(Afn, b, x0, maxit, rtol))


@f32_exact
def initpcg(A, b, x=None, W=None, M=None, maxit: int = 0,
            rtol: float | None = None) -> SolveResult:
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    Afn = as_linear_op(A)
    x0 = deflated_guess(Afn, b, x0, W)
    return _plain_result(_pcg_impl(Afn, as_precond_op(M), b, x0, maxit, rtol))
