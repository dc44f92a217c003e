"""eigCG / eigPCG: CG with online eigenvector harvesting.

Port of `krylov_spdes_tpu/solvers/eigcg.py` (reference:
RecyclingKrylovSolvers/eigcg.jl, Stathopoulos & Orginos 2010): solves
A x = b while extracting `nvec` approximate least-dominant eigenvectors of
A (resp. M⁻¹A) from the iteration's tridiagonal, thick-restarting the
(spdim, n) search space with the double-basis rank-SVD merge.

The solve is a host loop that reads the stop test back once per iteration
(at a restart the rank `nev` comes back in the same read). The search space
V is stored row-major (spdim, n) and updated in place; the restart
compression V ← (QZ)ᵀV is one (2nvec, spdim)×(spdim, n) product. The
reference's `tvec` trick that saves a matvec at restart (eigcg.jl:69,77-80,
100-102) is kept.
"""

from __future__ import annotations

import torch

from ..config import config
from .base import SolveResult, as_linear_op, as_precond_op, f32_exact
from .cg import _dot
from .eig_common import thick_restart_basis


def _apply_rows(A, V):
    """Apply the operator to each row of V: (s, n) -> (s, n)."""
    return torch.stack([A(v) for v in V])


def _go_and_nev(go, nev):
    """One read-back for the stop test and the restart's rank."""
    flag, nev = torch.stack([go.to(torch.int64), nev]).tolist()
    return bool(flag), int(nev)


def _compress(V, VtAV, QZ, vals, nvec):
    """V[:2nvec] ← QZᵀV and VtAV ← diag(vals), in place."""
    V[:2 * nvec] = QZ.T @ V
    VtAV.zero_()
    d = torch.arange(2 * nvec, device=V.device)
    VtAV[d, d] = vals


@f32_exact
def _eigcg_impl(A, b, x0, nvec, spdim, maxit, rtol):
    n = b.shape[0]
    x = x0.to(b.dtype)
    V = b.new_zeros((spdim, n))
    VtAV = b.new_zeros((spdim, spdim))

    r = b - A(x)
    rTr = _dot(r, r)
    p = r
    res0 = torch.sqrt(rTr)
    res_norm = b.new_zeros(maxit)
    res_norm[0] = res0
    V[0] = r / res0
    tol = rtol * torch.linalg.vector_norm(b)
    tvec = torch.zeros_like(b)
    it, ivec, jr = 1, 0, False
    go = bool(res0 > tol)
    while it < maxit and go:
        res_prev = res_norm[it - 1]
        Ap = A(p)
        alpha = rTr / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rTr_new = _dot(r, r)
        beta = rTr_new / rTr
        at_end = ivec == spdim - 1
        if at_end:
            tvec = tvec - beta * Ap
        p = r + beta * p
        res_new = torch.sqrt(rTr_new)
        res_norm[it] = res_new
        it += 1
        rTr = rTr_new

        VtAV[ivec, ivec] += 1.0 / alpha
        if jr:
            # just-restarted fixup: VtAV[:nev, ivec] = V[:nev] (tvec / res_prev)
            # with nev = ivec (eigcg.jl:77-80)
            tvec = tvec + Ap
            VtAV[:ivec, ivec] = V[:ivec] @ (tvec / res_prev)
        if at_end:
            vals, QZ, nev = thick_restart_basis(VtAV, nvec, spdim)
            go, nev = _go_and_nev(res_new > tol, nev)
            _compress(V, VtAV, QZ, vals, nvec)
            V[nev] = r / res_new
            VtAV[nev, nev] = beta / alpha
            ivec, tvec, jr = nev, -beta * Ap, True
        else:
            V[ivec + 1] = r / res_new
            VtAV[ivec, ivec + 1] = -torch.sqrt(beta) / alpha
            VtAV[ivec + 1, ivec + 1] = beta / alpha
            ivec, jr = ivec + 1, False
            go = bool(res_new > tol)
    return x, it, res_norm, V[:nvec].T.contiguous()


def _result(out):
    xs, it, res, W = out
    return SolveResult(x=xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=res, W=W)


def eigcg(A, b, x=None, nvec: int = 8, spdim: int = 32, maxit: int = 0,
          rtol: float | None = None) -> SolveResult:
    """eigCG (eigcg.jl:27-117). Returns W = nvec approximate least-dominant
    eigenvectors of A alongside the solution."""
    assert spdim >= 2 * nvec + 1, "eigCG requires spdim >= 2 nvec + 1"
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    return _result(_eigcg_impl(as_linear_op(A), b, x0, nvec, spdim, maxit,
                               rtol))


@f32_exact
def _eigpcg_impl(A, M, b, x0, nvec, spdim, maxit, rtol):
    n = b.shape[0]
    x = x0.to(b.dtype)
    V = b.new_zeros((spdim, n))
    VtAV = b.new_zeros((spdim, spdim))

    r = b - A(x)
    rTr = _dot(r, r)
    z = M(r)
    rTz = _dot(r, z)
    p = z
    res0 = torch.sqrt(rTr)
    res_norm = b.new_zeros(maxit)
    res_norm[0] = res0
    V[0] = z / torch.sqrt(rTz)
    tol = rtol * torch.linalg.vector_norm(b)
    tvec = torch.zeros_like(b)
    hlpr = b.new_zeros(())
    it, ivec, jr = 1, 0, False
    go = bool(res0 > tol)
    while it < maxit and go:
        Ap = A(p)
        alpha = rTz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rTr = _dot(r, r)
        z = M(r)
        if jr:
            hlpr = torch.sqrt(rTz)              # eigcg.jl:196-198
        rTz_new = _dot(r, z)
        beta = rTz_new / rTz
        at_end = ivec == spdim - 1
        if at_end:
            tvec = tvec - beta * Ap
        p = z + beta * p
        res_new = torch.sqrt(rTr)
        res_norm[it] = res_new
        it += 1
        rTz = rTz_new

        VtAV[ivec, ivec] += 1.0 / alpha
        if jr:
            tvec = tvec + Ap
            VtAV[:ivec, ivec] = V[:ivec] @ (tvec / hlpr)
        vcol = z / torch.sqrt(rTz_new)
        if at_end:
            # explicit VtAV = V A Vᵀ recompute (eigcg.jl:211-219)
            VtAV_full = V @ _apply_rows(A, V).T
            vals, QZ, nev = thick_restart_basis(VtAV_full, nvec, spdim)
            go, nev = _go_and_nev(res_new > tol, nev)
            _compress(V, VtAV, QZ, vals, nvec)
            V[nev] = vcol
            VtAV[nev, nev] = beta / alpha
            ivec, tvec, jr = nev, -beta * Ap, True
        else:
            V[ivec + 1] = vcol
            VtAV[ivec, ivec + 1] = -torch.sqrt(beta) / alpha
            VtAV[ivec + 1, ivec + 1] = beta / alpha
            ivec, jr = ivec + 1, False
            go = bool(res_new > tol)

    # post-loop harvest (eigcg.jl:248-264); ivec = completed columns
    if not jr and ivec > nvec:
        _, QZ, _ = thick_restart_basis(VtAV, nvec, ivec)
        V[:2 * nvec] = QZ.T @ V
    return x, it, res_norm, V[:nvec].T.contiguous()


def eigpcg(A, b, x=None, M=None, nvec: int = 8, spdim: int = 32,
           maxit: int = 0, rtol: float | None = None) -> SolveResult:
    """eigPCG (eigcg.jl:120-267): harvests eigenvectors of M⁻¹A."""
    assert spdim >= 2 * nvec + 1, "eigPCG requires spdim >= 2 nvec + 1"
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    return _result(_eigpcg_impl(as_linear_op(A), as_precond_op(M), b, x0,
                                nvec, spdim, maxit, rtol))
