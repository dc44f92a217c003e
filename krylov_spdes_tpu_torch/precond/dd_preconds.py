"""Domain-decomposition preconditioners for the full system: LORASC, DDLR,
NN-induced.

Port of `krylov_spdes_tpu/precond/dd_preconds.py` (reference:
Fem/EllipticPdeDomainDecomposition.jl:1406-2440). All three act on the
free-dof vector, gather it into (batched interiors, Γ), work blockwise and
scatter back:

- LORASC (:1406-1993, Grigori/Nataf/Youssef 2014): interior Cholesky
  solves, an A_ΓΓ solve, and a low-rank correction from the `nvec` least
  dominant generalized eigenpairs of (S, A_ΓΓ) with σ < ε, applied as
  x_Γ += Σ_k ((ε−σ_k)/σ_k)(e_kᵀz)e_k (:1954-1957). The exact path is a
  dense Cholesky-reduced `eigh`; the randomized one a range finder with q
  power iterations (:1553-1585).
- DDLR (:1996-2271, Li & Saad 2017): the shifted splitting
  A0 = blkdiag(A_II + α⁻²A_IΓA_IΓᵀ, A_ΓΓ + α²I) and a Woodbury-style
  correction from the top eigenpairs of H (dense here).
- NN-induced (:2274-2440): the Neumann-Neumann Schur preconditioner lifted
  to the full system.

Every sum over subdomains into Γ runs through the Γ gather table of the
SchurOperator in a fixed order (`fem/schur.py::gamma_sum`), so an apply and
the dense Γ matrices built here repeat bit for bit on the card. Padded
interior slots gather a zero and scatter into one extra slot that is
dropped (`free_dof_tables`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fem.bc import DirichletMaps
from ..fem.dd import DDPartition
from ..fem.schur import (SchurOperator, _masked_pinv, assemble_local_schurs,
                         gamma_sum, interior_solve)
from ..kl.dd_device import _chol_qr2
from ..solvers.base import f32_exact


def free_dof_tables(part: DDPartition, maps: DirichletMaps, device=None):
    """Gather tables from the free-dof vector: ifree (ndom, nI) and gfree
    (n_gamma,). Padded interior slots carry n_free: the applies read them
    from a zero appended to r and write them to an (n_free + 1)-th slot
    that they drop."""
    ifree = maps.free_g2l[np.maximum(part.interior_l2g, 0)].astype(np.int64)
    ifree[part.interior_l2g < 0] = maps.n_free
    gfree = maps.free_g2l[part.gamma_l2g].astype(np.int64)
    return (torch.as_tensor(ifree, device=device),
            torch.as_tensor(gfree, device=device))


def _gather(r, ifree, gfree):
    """(r_I (ndom, nI), r_Γ (n_gamma,)) from the free-dof vector r."""
    return torch.cat([r, r.new_zeros(1)])[ifree], r[gfree]


def _scatter(n_free, ifree, gfree, x_I, x_G):
    """The free-dof vector of (x_I, x_Γ); the padded slots land in the
    dropped slot n_free."""
    out = x_G.new_zeros(n_free + 1)
    out[gfree] = x_G
    out[ifree.reshape(-1)] = x_I.reshape(-1)
    return out[:n_free]


def _gamma_rows(S, vals):
    """Σ_d scatter_d of per-subdomain rows vals (ndom, nG, k) into a dense
    (n_gamma, k), in the Γ gather table's fixed order."""
    return gamma_sum(S.gamma_gather, vals.permute(2, 0, 1)).T


def _gamma_assemble(S, blocks):
    """Dense Σ_d scatter_d(blocks_d) over Γ × Γ, blocks (ndom, nG, nG)
    masked by gmask: columns placed per subdomain (distinct within one),
    rows summed in the table's fixed order."""
    n = S.n_gamma
    ndom, nG = S.gmask.shape
    col = torch.where(S.gmask > 0, S.gammad_to_gamma, n)
    C = blocks.new_zeros((ndom, nG, n + 1))
    C.scatter_(2, col[:, None, :].expand(ndom, nG, nG), blocks)
    return _gamma_rows(S, C[..., :n])


def _masked(S, blocks):
    return blocks * S.gmask[:, :, None] * S.gmask[:, None, :]


def assemble_gamma_matrix(S: SchurOperator):
    """Dense global A_ΓΓ from the batched local blocks
    (assemble_A_ΓΓ_from_local_blocks analogue, reference :1059-1108)."""
    return _gamma_assemble(S, _masked(S, S.A_GGd))


def assemble_gamma_sparse(S: SchurOperator):
    """Sparse (scipy CSR) global A_ΓΓ from the batched local blocks, for
    interfaces too large to densify. Host-side setup only."""
    import scipy.sparse as sp
    g = S.gammad_to_gamma.cpu().numpy()
    vals = _masked(S, S.A_GGd).cpu().numpy()
    rows = np.repeat(g[:, :, None], g.shape[1], axis=2)
    cols = np.repeat(g[:, None, :], g.shape[1], axis=1)
    n = S.n_gamma
    return sp.csr_matrix((vals.reshape(-1),
                          (rows.reshape(-1), cols.reshape(-1))), (n, n))


def assemble_global_schur_dense(S: SchurOperator):
    """Dense global S = Σ_d scatter_d(Sd)."""
    return _gamma_assemble(S, assemble_local_schurs(S))


def _eigh(A):
    """Symmetric eigendecomposition computed in float64, returned in A's
    dtype. cuSOLVER's float32 eigh, as torch calls it on an NVIDIA H100,
    gave the eigenvalues of DDLR's H (n_Γ 425) 1.4e-4 off, relative, where
    LAPACK's float32 gives 6e-7 on the same H; DDLR's weights 1/(1−λ)
    carry that into the apply. The decompositions here are of n_Γ-sized or
    smaller matrices, once a build."""
    w, V = torch.linalg.eigh(A.double())
    return w.to(A.dtype), V.to(A.dtype)


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _solve_upper(U, B):
    return torch.linalg.solve_triangular(U, B, upper=True)


@f32_exact
def _gamma_correction_pairs_exact(S: SchurOperator, A_GG, nvec):
    """nvec least dominant generalized eigenpairs of (S, A_ΓΓ), dense.
    Returns (σ (nvec,), E (n_Γ, nvec) A_ΓΓ-orthonormal, L = chol(A_ΓΓ))."""
    Sg = assemble_global_schur_dense(S)
    L = torch.linalg.cholesky(A_GG)
    B = _solve_lower(L, _solve_lower(L, Sg).T)
    w, U = _eigh((B + B.T) / 2)
    return w[:nvec], _solve_upper(L.T, U[:, :nvec]), L


def _schur_cols(S: SchurOperator, Y):
    """S Y for a block of columns Y (n_Γ, k)."""
    xd = Y[S.gammad_to_gamma] * S.gmask[..., None]          # (ndom, nG, k)
    t1 = S.A_GGd @ xd
    t2 = S.A_IG.transpose(-1, -2) @ interior_solve(S.A_II_L, S.A_IG @ xd)
    return _gamma_rows(S, (t1 - t2) * S.gmask[..., None])


@f32_exact
def _gamma_correction_pairs_randomized(S: SchurOperator, A_GG, ell, q,
                                       generator=None, H0=None):
    """Randomized subspace iteration on B = L⁻¹(A_ΓΓ − S)L⁻ᵀ (reference
    :1553-1585). The top modes of B are the small σ of (S, A_ΓΓ), the pairs
    LORASC keeps. The start block is H0 (n_Γ, ell) when given, else drawn
    from `generator`. Returns (σ ascending, E, L)."""
    L = torch.linalg.cholesky(A_GG)

    def bmat(X):
        Y = _solve_upper(L.T, X)
        # S applied 64 columns at a time bounds the (ndom, nI, k) transients
        SY = torch.cat([_schur_cols(S, Y[:, s:s + 64])
                        for s in range(0, Y.shape[1], 64)], dim=1)
        return _solve_lower(L, A_GG @ Y - SY)

    if H0 is None:
        H = torch.randn(S.n_gamma, ell, generator=generator,
                        dtype=A_GG.dtype, device=A_GG.device)
    else:
        H = torch.as_tensor(H0, dtype=A_GG.dtype, device=A_GG.device)
    for _ in range(2 * q + 1):
        H = _chol_qr2(bmat(H)[None])[0]
    Br = H.T @ bmat(H)
    zeta, U = _eigh((Br + Br.T) / 2)
    sig = 1.0 - zeta.flip(0)           # σ of (S, A_ΓΓ) = 1 − ζ of B
    E = _solve_upper(L.T, H @ U.flip(1))
    order = torch.argsort(sig, stable=True)
    return sig[order], E[:, order], L


def _dense_gamma_solve(LG, z):
    return _solve_upper(LG.T, _solve_lower(LG, z[:, None]))[:, 0]


def _lorasc_apply(n_free, A_II_L, A_IG, g2g, gmask, gather, ifree, gfree,
                  gamma_solve, E, Sig, r):
    x_I, x_G = _gather(r, ifree, gfree)
    # interior solves and their interface contribution
    xi = interior_solve(A_II_L, x_I)
    w = torch.einsum("dig,di->dg", A_IG, xi) * gmask
    z_G = x_G - gamma_sum(gather, w)
    # the A_ΓΓ solve (dense Cholesky or banded block-tridiagonal)
    x_G = gamma_solve(z_G)
    # low-rank correction: x_Γ += Σ_k ((ε−σ_k)/σ_k)(e_kᵀ z)e_k
    if E.shape[1] > 0:
        x_G = x_G + E @ (Sig * (E.T @ z_G))
    # back-substitution
    ug = x_G[g2g] * gmask
    xi = xi - interior_solve(A_II_L, torch.einsum("dig,dg->di", A_IG, ug))
    return _scatter(n_free, ifree, gfree, xi, x_G)


def lorasc_from_state(S: SchurOperator, part: DDPartition,
                      maps: DirichletMaps, gamma_solve, E, Sig):
    """The LORASC apply from its setup: the Γ solve and the correction pairs
    E (n_Γ, nev) with weights Sig = (ε−σ)/σ."""
    ifree, gfree = free_dof_tables(part, maps, S.A_IG.device)
    return functools.partial(
        _lorasc_apply, maps.n_free, S.A_II_L, S.A_IG, S.gammad_to_gamma,
        S.gmask, S.gamma_gather, ifree, gfree, gamma_solve,
        E.to(S.A_IG.dtype), Sig.to(S.A_IG.dtype))


@f32_exact
def prepare_lorasc_precond(S: SchurOperator, part: DDPartition,
                           maps: DirichletMaps, nvec: int = 25,
                           eps_threshold: float = 0.01,
                           low_rank_correction: str = "auto",
                           ell: int | None = None, q: int = 2,
                           generator: torch.Generator | None = None,
                           H0=None, gamma_solver: str = "dense",
                           verbose: bool = False):
    """LORASC for the full free-dof system (reference :1502-1678).

    gamma_solver "dense": dense Cholesky of A_ΓΓ on the device; "banded":
    RCM and a block-tridiagonal factor (precond/block_tridiag_chol.py) of
    the sparse A_ΓΓ, never densified.

    low_rank_correction "auto" takes the exact pairs, and the randomized
    range finder (q ≥ 4, a wider ell) once n_Γ ≥ 2048 when S lives on an
    accelerator: the rule of the JAX package, keyed here on the device of
    S's tensors. The randomized start block is H0 when given, else drawn
    from `generator` (one on S's device seeded with 0 when None)."""
    dt, dev = S.A_IG.dtype, S.A_IG.device
    if low_rank_correction == "auto":
        if dev.type != "cpu" and S.n_gamma >= 2048:
            low_rank_correction = "randomized"
            q = max(q, 4)
            if ell is None:
                ell = max(int(part.ndom + 0.1 * S.n_gamma), 6 * nvec)
        else:
            low_rank_correction = "exact"
    if gamma_solver == "banded":
        from .block_tridiag_chol import get_banded_cholesky
        gamma_solve = get_banded_cholesky(
            assemble_gamma_sparse(S),
            dtype=torch.float64 if dt == torch.float64 else torch.float32,
            out_dtype=dt, device=dev)
        if eps_threshold > 0 and low_rank_correction != "exact":
            raise ValueError("the banded gamma_solver pairs with exact "
                             "corrections or eps_threshold = 0")
    if eps_threshold > 0:
        A_GG = assemble_gamma_matrix(S)
        if low_rank_correction == "exact":
            sig, E, LG = _gamma_correction_pairs_exact(S, A_GG, nvec)
        else:
            if ell is None:
                ell = int(part.ndom + 0.1 * S.n_gamma)   # reference :1888
            if generator is None and H0 is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            sig, E, LG = _gamma_correction_pairs_randomized(
                S, A_GG, ell, q, generator=generator, H0=H0)
            sig, E = sig[:nvec], E[:, :nvec]
        nev = int((sig < eps_threshold).sum())
        if nev == 0:
            nev = min(nvec, sig.shape[0])
        Sig = (eps_threshold - sig[:nev]) / sig[:nev]
        E = E[:, :nev]
        if verbose:
            print(f"eps = {eps_threshold}, nev = {nev}")
    else:
        E = torch.zeros((S.n_gamma, 0), dtype=dt, device=dev)
        Sig = torch.zeros(0, dtype=dt, device=dev)
        if gamma_solver == "dense":
            LG = torch.linalg.cholesky(assemble_gamma_matrix(S))
    if gamma_solver == "dense":
        gamma_solve = functools.partial(_dense_gamma_solve, LG)
    return lorasc_from_state(S, part, maps, gamma_solve, E, Sig)


# ---------------------------------------------------------------------------
# DDLR (Li & Saad), reference :1996-2271
# ---------------------------------------------------------------------------

def _ddlr_a0_solve(L0_I, L0_G, x_I, x_G):
    return interior_solve(L0_I, x_I), _dense_gamma_solve(L0_G, x_G)


def _ddlr_apply(n_free, alpha, theta, L0_I, L0_G, A_IG, g2g, gmask, gather,
                ifree, gfree, U, Lam, r):
    x_I, x_G = _gather(r, ifree, gfree)
    # z = A0⁻¹ x
    z_I, z_G = _ddlr_a0_solve(L0_I, L0_G, x_I, x_G)
    # y_Γ = Eᵀ z with E = [α⁻¹A_IΓ; −αI]
    w = torch.einsum("dig,di->dg", A_IG, z_I) * gmask
    y_G = gamma_sum(gather, w) / alpha - alpha * z_G
    # w_Γ = G⁻¹ y_Γ, approximated from the top eigenpairs of H
    w_G = y_G / (1.0 - theta)
    if U.shape[1] > 0:
        coef = (1.0 / (1.0 - Lam) - 1.0 / (1.0 - theta)) * (U.T @ y_G)
        w_G = w_G + U @ coef
    # x += E w_Γ
    ug = w_G[g2g] * gmask
    x_I = x_I + torch.einsum("dig,dg->di", A_IG, ug) / alpha
    x_G = x_G - alpha * w_G
    # u = A0⁻¹ x
    u_I, u_G = _ddlr_a0_solve(L0_I, L0_G, x_I, x_G)
    return _scatter(n_free, ifree, gfree, u_I, u_G)


@f32_exact
def prepare_ddlr_precond(S: SchurOperator, part: DDPartition,
                         maps: DirichletMaps, A_II, plan_imask,
                         nvec: int = 25, alpha: float = 1.0):
    """Domain-decomposition low-rank preconditioner (reference :2140-2176).
    The top eigenpairs of H = Eᵀ A0⁻¹ E come from a dense n_Γ-sized eigh."""
    dt, dev = S.A_IG.dtype, S.A_IG.device
    n = S.n_gamma
    I_G = torch.eye(n, dtype=dt, device=dev)
    L0_G = torch.linalg.cholesky(assemble_gamma_matrix(S) + alpha ** 2 * I_G)
    # A0_I = A_II + α⁻² A_IΓ A_IΓᵀ (batched, padded rows identity)
    nI = A_II.shape[1]
    imask = plan_imask
    A0_I = A_II + (alpha ** -2) * (S.A_IG @ S.A_IG.transpose(-1, -2))
    A0_I = A0_I * imask[:, :, None] * imask[:, None, :] + \
        (1.0 - imask)[:, :, None] * torch.eye(nI, dtype=dt, device=dev)
    L0_I = torch.linalg.cholesky(A0_I)

    # dense H = Eᵀ A0⁻¹ E, applied to the identity (n_Γ columns)
    g2g, gmask = S.gammad_to_gamma, S.gmask
    Xg = I_G[g2g] * gmask[:, :, None]                       # (ndom, nG, n)
    ZI = interior_solve(L0_I, S.A_IG @ Xg / alpha)          # (ndom, nI, n)
    ZG = _solve_upper(L0_G.T, _solve_lower(L0_G, -alpha * I_G))
    W = (S.A_IG.transpose(-1, -2) @ ZI) * gmask[:, :, None]
    H = _gamma_rows(S, W) / alpha - alpha * ZG
    w, V = _eigh((H + H.T) / 2)
    Lam = w.flip(0)[:nvec]
    U = V.flip(1)[:, :nvec]
    theta = w.flip(0)[nvec]

    ifree, gfree = free_dof_tables(part, maps, dev)
    return functools.partial(
        _ddlr_apply, maps.n_free, torch.tensor(alpha, dtype=dt, device=dev),
        theta, L0_I, L0_G, S.A_IG, g2g, gmask, S.gamma_gather, ifree, gfree,
        U, Lam)


# ---------------------------------------------------------------------------
# NN-induced, reference :2274-2440
# ---------------------------------------------------------------------------

def _nn_induced_apply(n_free, A_II_L, A_IG, PiSd, g2g, gmask, gather,
                      cnt_inv, ifree, gfree, r):
    r_I, r_G = _gather(r, ifree, gfree)
    # the Schur residual
    z_I = interior_solve(A_II_L, r_I)
    w = torch.einsum("dig,di->dg", A_IG, z_I) * gmask
    r_s = r_G - gamma_sum(gather, w)
    # NN on the Schur residual
    rd = (r_s * cnt_inv)[g2g] * gmask
    zd = torch.einsum("dgh,dh->dg", PiSd, rd) * gmask
    z_G = gamma_sum(gather, zd) * cnt_inv
    # back-substitution with the local zd (reference :2412-2416)
    z_I = interior_solve(A_II_L, r_I - torch.einsum("dig,dg->di", A_IG, zd))
    return _scatter(n_free, ifree, gfree, z_I, z_G)


@f32_exact
def prepare_nn_induced_precond(S: SchurOperator, part: DDPartition,
                               maps: DirichletMaps):
    """Neumann-Neumann preconditioner induced on the full system. The
    reference notes that it "only seems to work with deflation" (:2302)."""
    PiSd = _masked_pinv(assemble_local_schurs(S), S.gmask)
    ifree, gfree = free_dof_tables(part, maps, S.A_IG.device)
    return functools.partial(
        _nn_induced_apply, maps.n_free, S.A_II_L, S.A_IG, PiSd,
        S.gammad_to_gamma, S.gmask, S.gamma_gather, 1.0 / S.gamma_cnt,
        ifree, gfree)

