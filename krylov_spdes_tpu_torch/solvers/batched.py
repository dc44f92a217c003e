"""Natively-batched eigDef-PCG for multi-chain MCMC.

Port of `krylov_spdes_tpu/solvers/batched.py`. The solver keeps the
iteration/restart SCHEDULE in scalars shared across the batch (it, ivec,
first), so the restart stays a real branch of the host loop and all V row
writes have a uniform index. Per-chain state (x, r, p, rTz, convergence) is
masked: a converged chain freezes (its x, V, VtAV and recorded iteration
count stop updating) while the loop runs until every chain converges; the
per-chain counts still match the reference accounting (defcg.jl:337-473).
The loop reads one flag back per iteration.

One deliberate deviation from the sequential schedule, as in the JAX
package: after a restart the next window always starts at ivec = 2·nvec.
When the merged double basis is full-rank (nev = 2·nvec, the generic case)
this is EXACTLY the reference schedule; when rank-deficient, the dead rows
[nev, 2nvec) keep zero V rows and a BIG diagonal in VtAV so the masked
restart machinery (eig_common.py) never selects them, instead of compacting
the window per chain (which would desynchronize the batch).

Preconditioner: the fused diagonal form (M = diag(mdiag)) used by the chain
workload, the same algebra as `_eigdef_impl`'s fused path (solvers/defcg.py).
"""

from __future__ import annotations

import torch

from .base import f32_exact
from .defcg import round_to
from .eig_common import thick_restart_basis


def _bdot(u, v):
    return torch.sum(u * v, dim=-1)


def _csolve(L, rhs):
    """Batched Cholesky solve with (B, k) right-hand sides."""
    return torch.cholesky_solve(rhs[..., None], L)[..., 0]


def _bmv(Mat, v):
    """(B, i, j) · (B, j) -> (B, i)."""
    return (Mat @ v[..., None])[..., 0]


@f32_exact
def batched_operands(A, mdiag, b, x0, W, nvec, basis_dtype=None, Mop=None):
    """Deflation setup of the batched solve (defcg.jl:357-377): the operands
    every iteration projects with, and the deflated start.

    Returns a dict with Wt (B, nvec, n), WtA, WtAW, the Cholesky factors cho
    (of WᵀAW) and cho_w (of WᵀW), K = (WᵀA·m)W, the rounded G = [Wᵀ; WᵀA·m]
    (B, 2nvec, n) and Wq (see solvers/defcg.round_to), and the start x, r,
    z, p (B, n), rTr, rTz (B,)."""
    if Mop is None:
        appM = lambda v: mdiag * v                      # noqa: E731
        appM_rows = lambda R: R * mdiag[:, None, :]     # noqa: E731
    else:
        appM = Mop
        appM_rows = lambda R: torch.stack(              # noqa: E731
            [Mop(R[:, k]) for k in range(R.shape[1])], dim=1)
    Wt = W.transpose(1, 2)                              # (B, nvec, n)
    WtA = torch.stack([A(Wt[:, k].contiguous()) for k in range(nvec)], dim=1)
    WtAW = WtA @ W                                      # (B, nvec, nvec)
    cho = torch.linalg.cholesky(WtAW)
    r = b - A(x0)
    x = x0 + _bmv(W, _csolve(cho, _bmv(Wt, r)))
    cho_w = torch.linalg.cholesky(Wt @ W)
    WtAM = appM_rows(WtA)
    r = b - A(x)
    z = appM(r)
    return dict(
        appM=appM, Wt=Wt, WtA=WtA, WtAW=WtAW, cho=cho, cho_w=cho_w,
        K=WtAM @ W,
        Gq=round_to(torch.cat([Wt, WtAM], dim=1), basis_dtype),
        Wq=round_to(W, basis_dtype), x=x, r=r, z=z,
        p=z - _bmv(W, _csolve(cho, _bmv(WtA, z))),
        rTr=_bdot(r, r), rTz=_bdot(r, z))


def projection_coefficients(ops, rn, nvec, basis_dtype=None):
    """One read of G = [Wᵀ; WᵀA·m] against the updated residual rn (B, n):
    U = G·rn, the reorthogonalisation coefficients cw = (WᵀW)⁻¹U₁ and the
    deflation coefficients mu = (WᵀAW)⁻¹(U₂ − K·cw), each (B, nvec)."""
    U = _bmv(ops["Gq"], round_to(rn, basis_dtype))
    cw = _csolve(ops["cho_w"], U[:, :nvec])
    mu = _csolve(ops["cho"], U[:, nvec:] - _bmv(ops["K"], cw))
    return cw, mu


@f32_exact
def _batched_eigdef_impl(A, mdiag, b, x0, W, nvec, spdim, maxit, rtol,
                         basis_dtype=None, Mop=None):
    """Batched fused-diagonal eigDef-PCG.

    A: (B, n) -> (B, n) batched operator
    mdiag: (B, n) preconditioner diagonal (M⁻¹ = diag(mdiag)); pass a
        general batched preconditioner (B, n) -> (B, n) via Mop instead
        (mdiag is then ignored)
    b, x0: (B, n); W: (B, n, nvec)
    Returns (x (B,n), it (B,) int32, res (B, maxit), W' (B, n, nvec)).
    """
    Bn, n = b.shape
    dtype, dev = b.dtype, b.device
    ops = batched_operands(A, mdiag, b, x0, W, nvec, basis_dtype, Mop)
    appM, Wt, WtA, WtAW, Wq = (ops[k] for k in ("appM", "Wt", "WtA", "WtAW",
                                                "Wq"))
    x, r, z, p, rTr, rTz = (ops[k] for k in ("x", "r", "z", "p", "rTr",
                                             "rTz"))

    V = b.new_zeros((Bn, spdim, n))
    VtAV = b.new_zeros((Bn, spdim, spdim))

    res0 = torch.sqrt(rTr)
    res = b.new_zeros((Bn, maxit))
    res[:, 0] = res0
    tol = rtol * torch.linalg.vector_norm(b, dim=1)

    V[:, :nvec] = Wt
    VtAV[:, :nvec, :nvec] = WtAW
    V[:, nvec] = z / torch.sqrt(rTz)[:, None]

    it, ivec, first = 1, nvec, True
    alive = res0 > tol
    itc = torch.ones(Bn, dtype=torch.int32, device=dev)
    ivec_c = torch.full((Bn,), nvec, dtype=torch.int64, device=dev)
    first_c = torch.ones(Bn, dtype=torch.bool, device=dev)
    jr_c = torch.zeros(Bn, dtype=torch.bool, device=dev)
    d2 = torch.arange(2 * nvec, device=dev)
    go = bool(alive.any())
    while it < maxit and go:
        am = alive[:, None]
        Ap = A(p)
        alpha = rTz / _bdot(p, Ap)
        x = torch.where(am, x + alpha[:, None] * p, x)
        rn = r - alpha[:, None] * Ap
        # fused reorth + deflation coefficients: one read of [Wᵀ; WᵀA·m]
        cw, mu = projection_coefficients(ops, rn, nvec, basis_dtype)
        T = Wq @ round_to(torch.stack([cw, mu], dim=-1), basis_dtype)
        rn = rn - T[..., 0]
        rTr = _bdot(rn, rn)
        z = appM(rn)
        rTz_new = _bdot(rn, z)
        beta = rTz_new / rTz
        pn = beta[:, None] * p + z - T[..., 1]
        res_new = torch.sqrt(rTr)

        r = torch.where(am, rn, r)
        p = torch.where(am, pn, p)
        rTz = torch.where(alive, rTz_new, rTz)
        res[:, it] = torch.where(alive, res_new, 0.0)
        newly = alive & (res_new <= tol)
        itc = torch.where(newly, it + 1, itc).to(torch.int32)

        # search-space update at the SHARED scalar ivec
        VtAV[:, ivec, ivec] += torch.where(alive, 1.0 / alpha, 0.0)
        vcol = z / torch.sqrt(rTz_new)[:, None]
        if ivec == spdim - 1:
            VtAV_f = VtAV
            if first:
                VtAV_f = VtAV.clone()
                VtAV_f[:, :nvec, nvec:] = WtA @ V[:, nvec:spdim].transpose(1, 2)
            vals, QZ, nev = thick_restart_basis(VtAV_f, nvec, spdim)
            Vn = V.clone()
            Vn[:, :2 * nvec] = QZ.transpose(1, 2) @ V      # (B, 2nvec, n)
            Vn[:, 2 * nvec] = vcol
            # dead rows [nev, 2nvec) get a BIG diagonal so the masked
            # restart machinery never selects them (vals are zero there)
            big = 2.0 + vals.abs().sum(dim=1)
            dead = d2[None, :] >= nev[:, None]
            Wn = torch.zeros_like(VtAV)
            Wn[:, d2, d2] = torch.where(dead, big[:, None], vals)
            Wn[:, 2 * nvec, 2 * nvec] = beta / alpha
            # frozen chains keep their state
            V = torch.where(alive[:, None, None], Vn, V)
            VtAV = torch.where(alive[:, None, None], Wn, VtAV)
            ivec, first, jr = 2 * nvec, False, True
        else:
            iv = ivec + 1
            V[:, iv] = torch.where(am, vcol, V[:, iv])
            VtAV[:, ivec, iv] = torch.where(alive, -torch.sqrt(beta) / alpha,
                                            VtAV[:, ivec, iv])
            VtAV[:, iv, iv] = torch.where(alive, beta / alpha, VtAV[:, iv, iv])
            ivec, jr = iv, False
        ivec_c = torch.where(alive, ivec, ivec_c)
        first_c = torch.where(alive, first, first_c)
        jr_c = torch.where(alive, jr, jr_c)
        alive = alive & ~newly
        it += 1
        go = bool(alive.any())

    # --- post-loop harvest (defcg.jl:438-465), batched & per-chain-masked ---
    m = ivec_c
    colmask = torch.arange(nvec, spdim, device=dev)[None, :] < m[:, None]
    block = WtA @ V[:, nvec:spdim].transpose(1, 2)
    fixed = VtAV.clone()
    fixed[:, :nvec, nvec:] = torch.where(colmask[:, None, :], block,
                                         VtAV[:, :nvec, nvec:])
    VtAV_f = torch.where(first_c[:, None, None], fixed, VtAV)
    _, QZ, _ = thick_restart_basis(VtAV_f, nvec, m)
    Vh = QZ.transpose(1, 2) @ V
    do_h = (~jr_c) & (m > nvec)
    Wout = torch.where(do_h[:, None, None], Vh[:, :nvec], V[:, :nvec])
    return x, itc, res, Wout.transpose(1, 2).contiguous()
