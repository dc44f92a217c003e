"""Block CG/PCG: all right-hand sides advance together.

Port of `krylov_spdes_tpu/solvers/block_cg.py`: O'Leary's block recurrence
with small k×k Gram solves, every operator apply an (n, k) block
(`apply_block`, the port's form of the JAX package's vmap over columns).
The reference has no block solver: this is the multiple-RHS workload of
its Example11, which solves the sampled b's one at a time. The loop is a
host loop with one read-back an iteration.
"""

from __future__ import annotations

import torch

from ..config import config
from .base import (SolveResult, apply_block, as_linear_op, as_precond_op,
                   f32_exact)


def _solve_gram(G, B):
    """Solve the small SPD k×k system G X = B (Cholesky, with an eps-sized
    ridge)."""
    k = G.shape[0]
    Gs = (G + G.T) / 2 + torch.finfo(G.dtype).eps * torch.trace(G) / k * \
        torch.eye(k, dtype=G.dtype, device=G.device)
    return torch.cholesky_solve(B, torch.linalg.cholesky(Gs))


@f32_exact
def _block_pcg_impl(A, M, B, X0, maxit, rtol):
    X = X0.to(B.dtype)
    R = B - apply_block(A, X)
    Z = apply_block(M, R)
    P = Z
    RtZ = R.T @ Z
    tol = rtol * torch.linalg.vector_norm(B, dim=0)
    hist = B.new_zeros((maxit, B.shape[1]))
    hist[0] = torch.linalg.vector_norm(R, dim=0)
    it = 1
    while it < maxit and bool(torch.any(hist[it - 1] > tol)):
        AP = apply_block(A, P)
        alpha = _solve_gram(P.T @ AP, RtZ)
        X = X + P @ alpha
        R = R - AP @ alpha
        Z = apply_block(M, R)
        RtZ_new = R.T @ Z
        beta = _solve_gram(RtZ, RtZ_new)
        P = Z + P @ beta
        hist[it] = torch.linalg.vector_norm(R, dim=0)
        RtZ = RtZ_new
        it += 1
    return X, it, hist


def block_pcg(A, B, X=None, M=None, maxit: int = 0,
              rtol: float | None = None) -> SolveResult:
    """Solve A X = B for all k columns simultaneously. Stops when EVERY
    column satisfies ||r_j|| <= rtol ||b_j||. A and M take (n, k) blocks."""
    maxit = B.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    X0 = torch.zeros_like(B) if X is None else X
    Xs, it, hist = _block_pcg_impl(as_linear_op(A), as_precond_op(M), B, X0,
                                   maxit, rtol)
    return SolveResult(x=Xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=hist)
