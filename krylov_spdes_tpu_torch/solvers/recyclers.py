"""The RR/HR × {post, TR, LO-TR} deflation-recycler family (12 solvers).

Port of `krylov_spdes_tpu/solvers/recyclers.py` (reference:
RecyclingKrylovSolvers/{rrdefpcg,hrdefpcg,trrrdefpcg,trhrdefpcg,
lotrrrdefpcg,lotrhrdefpcg}.jl and their six no-deflation bootstrap
variants). All share one deflated-PCG skeleton; what varies is

  projection   RR: Ritz over V, new W2 = least gen-eigvecs of (VᵀAV, I)
               HR: harmonic Ritz, gen-eigvecs of (VᵀA M⁻¹A V, VᵀAV)
  window       RR stores normalized preconditioned residuals z/√(rᵀz);
               HR stores search directions p
  schedule     post: one projection after the solve
               tr: in-loop thick restart whenever the window fills
               lotr: like tr, but with the eigCG double-basis rank-SVD merge
               letting the kept count nev grow in [nvec, 2nvec]

One buffer V (spdim, n) holds [W2 rows | window rows]. The JAX package runs
the iteration in a `lax.while_loop` with an in-loop `lax.cond` restart; here
it is a host loop that reads the stop test back once an iteration and the
projection's (finite, nev) once a projection, with the same semantics: the
post schedule's row writes stop when the window is full, a TR/LO-TR restart
happens exactly when nev + wcount == spdim, a bootstrap run that ends before
any projection projects what it has, and a projection with non-finite rows
keeps the previous basis. A projection applies A, and for HR M, to the
whole (n, spdim) block in one call (`apply_block`).
"""

from __future__ import annotations

import torch

from ..config import config
from .base import (SolveResult, apply_block, as_linear_op, as_precond_op,
                   f32_exact)
from .cg import _dot
from .defcg import _cho_solve
from .eig_common import _sym, ritz_basis_gen, thick_restart_basis_gen


def _blockdiag_mask(G, nev: int):
    """HR right-hand metric: keep the leading nev×nev block and the diagonal
    (search directions are A-conjugate: PᵀAP is diagonal,
    hrdefpcg.jl:148-155)."""
    i = torch.arange(G.shape[0], device=G.device)
    keep = (((i[:, None] < nev) & (i[None, :] < nev))
            | (i[:, None] == i[None, :]))
    return torch.where(keep, G, torch.zeros((), dtype=G.dtype,
                                            device=G.device))


def _unitize(rows):
    """Row-normalize an HR basis block (span-preserving; zero rows kept).

    The reference stores raw search directions in the HR window
    (hrdefpcg.jl:167) and raw projected bases: fine in float64, but in
    float32 the p-magnitudes span ~1e±10 and one LO-TR restart can return a
    ~1e-7-norm basis whose WᵀAW underflows and poisons the next solve of a
    chain. Both HR pencil metrics (VᵀAM⁻¹AV, blockdiag VᵀAV) are quadratic
    in V, so row scaling is exactly span-invariant. RR's identity metric is
    not scale-invariant (T = I, rrdefpcg.jl:126-148) and RR rows are left
    as they are: its z/√(rᵀz) window vectors are O(1) already."""
    nrm = torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    return rows / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def _project(A, M, V, proj, schedule, nvec, active_dim, nev):
    """Overwrite the deflation rows of V with the projection of its active
    rows; returns the new nev (one read-back). A degenerate small problem (a
    float32 rank collapse) yields non-finite rows: the previous basis is
    kept and the caller flushes the window (the reference's policy for
    degenerate chains is discard-and-redo, Example09..._Functions.jl:
    358-360; here recycling skips a beat)."""
    spdim = V.shape[0]
    AV = apply_block(A, V.T.contiguous()).T                # (spdim, n)
    G = V @ AV.T                                           # VᵀAV
    if proj == "rr":
        S = _sym(G)
        T = torch.eye(spdim, dtype=G.dtype, device=G.device)
    else:
        MAV = apply_block(M, AV.T.contiguous()).T
        S, T = _sym(AV @ MAV.T), _blockdiag_mask(_sym(G), nev)
    if schedule == "lotr":
        _, QZ, nev_new = thick_restart_basis_gen(S, T, nvec, active_dim)
        rows = QZ.T @ V
    else:
        rows = ritz_basis_gen(S, T, nvec, active_dim).T @ V
        nev_new = torch.tensor(nvec, device=V.device)
    if proj == "hr":
        rows = _unitize(rows)
    ok, nev_new = torch.stack([torch.isfinite(rows).all().to(nev_new.dtype),
                               nev_new]).tolist()
    if not ok:
        return nev
    V[:rows.shape[0]] = rows
    return nev_new


@f32_exact
def _recycler_impl(A, M, b, x0, W, proj, schedule, deflated, nvec, spdim,
                   maxit, rtol):
    n = b.shape[0]
    x = x0.to(b.dtype)

    if deflated:
        WtA = apply_block(A, W).T                          # (nvec, n)
        cho_a = torch.linalg.cholesky(WtA @ W)
        cho_w = torch.linalg.cholesky(W.T @ W)
        r = b - A(x)
        x = x + W @ _cho_solve(cho_a, W.T @ r)

        def deflate_dir(z):
            return z - W @ _cho_solve(cho_a, WtA @ z)

        def reorth(r):
            return r - W @ _cho_solve(cho_w, W.T @ r)
    else:
        def deflate_dir(z):
            return z

        def reorth(r):
            return r

    r = b - A(x)
    rTr = _dot(r, r)
    z = M(r)
    rTz = _dot(r, z)
    p = deflate_dir(z)
    res_norm = b.new_zeros(maxit)
    res_norm[0] = torch.sqrt(rTr)
    tol = rtol * torch.linalg.vector_norm(b)

    def window_vec():
        return (z / torch.sqrt(rTz) if proj == "rr"
                else p / torch.linalg.vector_norm(p))

    V = b.new_zeros((spdim, n))
    nev0 = nvec if deflated else 0
    if deflated:
        V[:nvec] = W.T
    V[nev0] = window_vec()

    it, nev, wcount = 1, nev0, 1
    while it < maxit and bool(res_norm[it - 1] > tol):
        Ap = A(p)
        alpha = rTz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        r = reorth(r)
        rTr = _dot(r, r)
        z = M(r)
        rTz_new = _dot(r, z)
        beta = rTz_new / rTz
        p = beta * p + deflate_dir(z)
        res_norm[it] = torch.sqrt(rTr)
        rTz = rTz_new
        it += 1
        if schedule == "post":
            # fill while room remains; never restart in the loop
            if nev + wcount < spdim:
                V[nev + wcount] = window_vec()
            wcount = min(wcount + 1, spdim - nev0)
        else:
            V[nev + wcount] = window_vec()
            wcount += 1
            if nev + wcount == spdim:
                nev = _project(A, M, V, proj, schedule, nvec, spdim, nev)
                wcount = 0

    if schedule == "post" or (not deflated and nev == 0):
        # post: the one projection; a bootstrap TR/LO-TR run that ended
        # mid-window before any restart projects what it has
        _project(A, M, V, proj, schedule, nvec, nev + wcount, nev)
    return x, it, res_norm, V[:nvec].T.contiguous()


def _run(A, b, x, W, M, proj, schedule, nvec, spdim, maxit, rtol):
    deflated = W is not None
    if deflated:
        W = torch.as_tensor(W, dtype=b.dtype, device=b.device)
        nvec = W.shape[1]
    if schedule == "lotr" and spdim < 2 * nvec + 1:
        raise ValueError("LO-TR requires spdim >= 2 nvec + 1")
    if schedule != "lotr" and spdim <= nvec:
        raise ValueError("recyclers require spdim > nvec")
    maxit = b.shape[0] if maxit == 0 else maxit
    rtol = config.rtol if rtol is None else rtol
    x0 = torch.zeros_like(b) if x is None else x
    xs, it, res, W2 = _recycler_impl(
        as_linear_op(A), as_precond_op(M), b, x0, W, proj, schedule,
        deflated, nvec, spdim, maxit, rtol)
    return SolveResult(x=xs, it=torch.tensor(it, dtype=torch.int32),
                       res_norm=res, W=W2)


# --- deflated variants (rrdefpcg.jl:48, hrdefpcg.jl:48, trrrdefpcg.jl:48,
#     trhrdefpcg.jl:48, lotrrrdefpcg.jl:48, lotrhrdefpcg.jl:48) -------------

def rrdefpcg(A, b, x=None, W=None, M=None, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, W, M, "rr", "post", None, spdim, maxit, rtol)


def hrdefpcg(A, b, x=None, W=None, M=None, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, W, M, "hr", "post", None, spdim, maxit, rtol)


def trrrdefpcg(A, b, x=None, W=None, M=None, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, W, M, "rr", "tr", None, spdim, maxit, rtol)


def trhrdefpcg(A, b, x=None, W=None, M=None, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, W, M, "hr", "tr", None, spdim, maxit, rtol)


def lotrrrdefpcg(A, b, x=None, W=None, M=None, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, W, M, "rr", "lotr", None, spdim, maxit, rtol)


def lotrhrdefpcg(A, b, x=None, W=None, M=None, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, W, M, "hr", "lotr", None, spdim, maxit, rtol)


# --- bootstrap variants (no initial deflation space; rrdefpcg.jl:200,
#     hrdefpcg.jl:214, trrrdefpcg.jl:230, trhrdefpcg.jl:245, ...) -----------

def rrpcg(A, b, x=None, M=None, nvec=8, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, None, M, "rr", "post", nvec, spdim, maxit, rtol)


def hrpcg(A, b, x=None, M=None, nvec=8, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, None, M, "hr", "post", nvec, spdim, maxit, rtol)


def trrrpcg(A, b, x=None, M=None, nvec=8, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, None, M, "rr", "tr", nvec, spdim, maxit, rtol)


def trhrpcg(A, b, x=None, M=None, nvec=8, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, None, M, "hr", "tr", nvec, spdim, maxit, rtol)


def lotrrrpcg(A, b, x=None, M=None, nvec=8, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, None, M, "rr", "lotr", nvec, spdim, maxit, rtol)


def lotrhrpcg(A, b, x=None, M=None, nvec=8, spdim=32, maxit=0, rtol=None):
    return _run(A, b, x, None, M, "hr", "lotr", nvec, spdim, maxit, rtol)
