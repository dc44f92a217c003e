"""Deflated CG/PCG and their eigenvector-recycling variants.

Port of `krylov_spdes_tpu/solvers/defcg.py` (reference:
RecyclingKrylovSolvers/defcg.jl):

- `defcg` / `defpcg` (Saad, Yeung, Erhel & Guyomarc'h 1999): projected
  initial guess x += W (WᵀAW)⁻¹Wᵀr and per-iteration direction deflation
  p <- beta p + z - W (WᵀAW)⁻¹(WᵀA z).
- `eigdefcg` / `eigdefpcg` ("RR-LO-TR-Def-(P)CG", Venkovic et al. 2020):
  Def-CG plus eigCG-style online harvesting, search space SEEDED with W
  (V[:nvec] = W, VtAV[:nvec,:nvec] = WᵀAW, defcg.jl:158-162). eigdefpcg
  adds per-iteration residual re-orthogonalization r -= W(WᵀW)⁻¹Wᵀr
  (defcg.jl:407).

The deflation solves use a Cholesky factor of WᵀAW computed once; the
deflation projections are tall-skinny products (n×nvec). Each solve is a
host loop with one read-back per iteration.
"""

from __future__ import annotations

import torch

from ..config import config
from .base import SolveResult, as_linear_op, as_precond_op, f32_exact
from .cg import _dot
from .eig_common import thick_restart_basis
from .eigcg import _compress, _go_and_nev, _result


def _cho_solve(L, rhs):
    """Solve with a lower Cholesky factor; rhs (k,) or (k, j)."""
    if rhs.ndim == 1:
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.cholesky_solve(rhs, L)


def _apply_cols(A, W):
    """Rows A w_i of the columns of W: (n, nvec) -> (nvec, n) (A SPD)."""
    return torch.stack([A(w) for w in W.T.contiguous()])


def _deflation_setup(A, W, x, b):
    """WtA (nvec, n), chol(WtAW), deflated initial guess.

    The deflation Gram WᵀAW is kept Cholesky-factored as in the reference
    (defcg.jl:40), not rank-revealing-pseudo-inverted: its small
    eigenvalues are the low Ritz modes (the most valuable deflation
    directions), not noise."""
    WtA = _apply_cols(A, W)
    WtAW = WtA @ W
    cho = torch.linalg.cholesky(WtAW)
    r = b - A(x)
    mu = _cho_solve(cho, W.T @ r)
    x = x + W @ mu
    return WtA, cho, x


def _needs_reorth(dtype) -> bool:
    """Def-CG maintains Wᵀr = 0 only in exact arithmetic; in float32 the
    deflated (lowest-mode) components re-grow from rounding and the
    iteration can stall or diverge, so the residual is re-orthogonalized
    against W each step (float64 needs none of this, and the reference's
    defcg.jl:225-310 has no reorth)."""
    return dtype == torch.float32


def _defpcg_loop(A, M, b, x0, W, maxit, rtol):
    """Shared body of Def-CG (M None) and Def-PCG."""
    x = x0.to(b.dtype)
    WtA, cho, x = _deflation_setup(A, W, x, b)
    reorth = _needs_reorth(b.dtype)

    r = b - A(x)
    rTr = _dot(r, r)
    z = r if M is None else M(r)
    rTz = rTr if M is None else _dot(r, z)
    p = z - W @ _cho_solve(cho, WtA @ z)
    res_norm = b.new_zeros(maxit)
    res_norm[0] = torch.sqrt(rTr)
    tol = rtol * torch.linalg.vector_norm(b)
    it = 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        Ap = A(p)
        alpha = rTz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if reorth:
            # remove the re-grown span(W) component via the deflation
            # correction x += W (WᵀAW)⁻¹Wᵀr, r -= A W c: keeps b − A x
            # consistent with r (a bare projection of r lets x and r drift)
            cw = _cho_solve(cho, W.T @ r)
            x = x + W @ cw
            r = r - WtA.T @ cw
        rTr = _dot(r, r)
        z = r if M is None else M(r)
        rTz_new = rTr if M is None else _dot(r, z)
        beta = rTz_new / rTz
        p = beta * p + z - W @ _cho_solve(cho, WtA @ z)
        res_norm[it] = torch.sqrt(rTr)
        rTz = rTz_new
        it += 1
    return x, it, res_norm


@f32_exact
def _defcg_impl(A, b, x0, W, maxit, rtol):
    return _defpcg_loop(A, None, b, x0, W, maxit, rtol)


@f32_exact
def _defpcg_impl(A, M, b, x0, W, maxit, rtol):
    return _defpcg_loop(A, M, b, x0, W, maxit, rtol)


def _plain_result(out):
    xs, it, res = out
    return SolveResult(x=xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=res)


def defcg(A, b, x=None, W=None, maxit: int = 0,
          rtol: float | None = None) -> SolveResult:
    """Deflated CG (defcg.jl:24-90)."""
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    return _plain_result(_defcg_impl(as_linear_op(A), b, x0, W, maxit, rtol))


def defpcg(A, b, x=None, W=None, M=None, maxit: int = 0,
           rtol: float | None = None) -> SolveResult:
    """Deflated PCG (defcg.jl:225-310)."""
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    return _plain_result(_defpcg_impl(as_linear_op(A), as_precond_op(M), b,
                                      x0, W, maxit, rtol))


def round_to(t, basis_dtype):
    """t rounded to basis_dtype and carried in its own dtype, so that a
    product of two such operands is exact in float32 and accumulates in
    float32, as the JAX package's bf16 einsums with a float32
    `preferred_element_type` do. (A torch product of two bf16 tensors
    would round its result to bf16 as well.)"""
    return t if basis_dtype is None else t.to(basis_dtype).to(t.dtype)


def _first_fix(VtAV, WtA, V, nvec, m):
    """VtAV[:nvec, nvec:m] = WᵀA·V[nvec:m]ᵀ: the coupling of the seeded W
    block with the Lanczos columns, filled at the first restart or harvest
    (defcg.jl:428-436)."""
    VtAV[:nvec, nvec:m] = WtA @ V[nvec:m].T


@f32_exact
def _eigdef_impl(A, M, b, x0, W, nvec, spdim, maxit, rtol, precond, reorth,
                 mdiag=None, basis_dtype=None):
    """Shared eigdefcg (precond=False) / eigdefpcg (precond=True) body.

    When `mdiag` is given (with precond and reorth), M is diag(mdiag) and
    the four per-iteration (n, nvec) passes (Wᵀr, W cw, WᵀA z, W mu) fuse
    into one stacked (2 nvec, n) read plus one 2-column product, by
    linearity: z = m⊙(r − W cw), so WᵀA z = (WᵀA·m) r − [(WᵀA·m) W] cw with
    both factors precomputed.

    `basis_dtype` (fused path only): the projection operands G = [Wᵀ;
    WᵀA·m], W, r and the coefficients are rounded to it (torch.bfloat16)
    before the products, which accumulate in the working dtype. All setup
    algebra (WᵀAW, Cholesky factors) uses the full-precision W.
    """
    fused = mdiag is not None
    assert not fused or (precond and reorth)
    n = b.shape[0]
    x = x0.to(b.dtype)
    WtA, cho, x = _deflation_setup(A, W, x, b)
    WtAW = WtA @ W
    cho_w = torch.linalg.cholesky(W.T @ W)
    if fused:
        WtAM = WtA * mdiag[None, :]
        K = WtAM @ W
        Gq = round_to(torch.cat([W.T, WtAM]), basis_dtype)    # (2 nvec, n)
        Wq = round_to(W, basis_dtype)

    V = b.new_zeros((spdim, n))
    VtAV = b.new_zeros((spdim, spdim))

    r = b - A(x)
    rTr = _dot(r, r)
    z = mdiag * r if fused else (M(r) if precond else r)
    rTz = _dot(r, z)
    p = z - W @ _cho_solve(cho, WtA @ z)
    res0 = torch.sqrt(rTr)
    res_norm = b.new_zeros(maxit)
    res_norm[0] = res0

    V[:nvec] = W.T
    VtAV[:nvec, :nvec] = WtAW
    V[nvec] = r / res0 if not precond else z / torch.sqrt(rTz)
    tol = rtol * torch.linalg.vector_norm(b)

    it, ivec, first, jr = 1, nvec, True, False
    go = bool(res0 > tol)
    while it < maxit and go:
        Ap = A(p)
        alpha = rTz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if fused:
            # one read of [Wᵀ; WᵀA·m]: reorth + deflation coefficients
            U = Gq @ round_to(r, basis_dtype)
            cw = _cho_solve(cho_w, U[:nvec])             # (defcg.jl:407)
            mu = _cho_solve(cho, U[nvec:] - K @ cw)      # = (WᵀAW)⁻¹ WᵀA z
            T = Wq @ round_to(torch.stack([cw, mu], dim=1), basis_dtype)
            r = r - T[:, 0]
            rTr = _dot(r, r)
            z = mdiag * r
            rTz_new = _dot(r, z)
            beta = rTz_new / rTz
            p = beta * p + z - T[:, 1]
        else:
            if precond and reorth:
                # residual re-orthogonalization against W (defcg.jl:407)
                r = r - W @ _cho_solve(cho_w, W.T @ r)
            rTr = _dot(r, r)
            z = M(r) if precond else r
            rTz_new = _dot(r, z)
            beta = rTz_new / rTz
            p = beta * p + z - W @ _cho_solve(cho, WtA @ z)
        res_new = torch.sqrt(rTr)
        res_norm[it] = res_new
        it += 1
        rTz = rTz_new

        VtAV[ivec, ivec] += 1.0 / alpha
        vcol = r / res_new if not precond else z / torch.sqrt(rTz_new)
        if ivec == spdim - 1:
            if first:
                _first_fix(VtAV, WtA, V, nvec, spdim)
            vals, QZ, nev = thick_restart_basis(VtAV, nvec, spdim)
            go, nev = _go_and_nev(res_new > tol, nev)
            _compress(V, VtAV, QZ, vals, nvec)
            V[nev] = vcol
            VtAV[nev, nev] = beta / alpha
            ivec, first, jr = nev, False, True
        else:
            V[ivec + 1] = vcol
            VtAV[ivec, ivec + 1] = -torch.sqrt(beta) / alpha
            VtAV[ivec + 1, ivec + 1] = beta / alpha
            ivec, jr = ivec + 1, False
            go = bool(res_new > tol)

    # post-loop harvest (defcg.jl:438-465)
    if precond and not jr and ivec > nvec:
        if first:
            _first_fix(VtAV, WtA, V, nvec, ivec)
        _, QZ, _ = thick_restart_basis(VtAV, nvec, ivec)
        V[:2 * nvec] = QZ.T @ V
    return x, it, res_norm, V[:nvec].T.contiguous()


def eigdefcg(A, b, x=None, W=None, spdim: int = 32, maxit: int = 0,
             rtol: float | None = None) -> SolveResult:
    """eigDef-CG (defcg.jl:93-222): deflated solve + online eigenvector
    refresh; W' returned for the next system in the sampled sequence."""
    nvec = W.shape[1]
    assert spdim >= 2 * nvec + 1
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    return _result(_eigdef_impl(as_linear_op(A), as_precond_op(None), b, x0,
                                W, nvec, spdim, maxit, rtol, False, False))


def eigdefpcg(A, b, x=None, M=None, W=None, spdim: int = 32, maxit: int = 0,
              rtol: float | None = None, Mdiag=None) -> SolveResult:
    """eigDef-PCG (defcg.jl:313-473): the workhorse for MCMC chains of
    correlated systems.

    Pass the preconditioner's (already inverted) diagonal as `Mdiag`
    instead of a callable `M` to take the fused low-traffic path, which is
    equivalent up to rounding (the deflation coefficients come from a
    precomputed (WᵀA·m) W product instead of an explicit WᵀA z)."""
    nvec = W.shape[1]
    assert spdim >= 2 * nvec + 1
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    if Mdiag is not None:
        assert M is None
        return _result(_eigdef_impl(
            as_linear_op(A), as_precond_op(None), b, x0, W, nvec, spdim,
            maxit, rtol, True, True, Mdiag))
    return _result(_eigdef_impl(as_linear_op(A), as_precond_op(M), b, x0, W,
                                nvec, spdim, maxit, rtol, True, True))
