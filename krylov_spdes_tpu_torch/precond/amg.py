"""Smoothed-aggregation AMG preconditioner: host setup, V-cycle on the
device.

Port of `krylov_spdes_tpu/precond/amg.py` (the reference's
`AMGPreconditioner{SmoothedAggregation}`, AlgebraicMultigrid.jl, e.g.
Example01:56, Example06:117):

- the setup (strength of connection, greedy aggregation, tentative
  prolongator, Jacobi-smoothed P = (I − ω D⁻¹A) T, Galerkin coarse grids
  A_{l+1} = PᵀA_l P) stays on the host in scipy, a copy of the JAX
  package's, so the same matrix gives the same hierarchy bit for bit (its
  spectral-radius estimate draws from numpy's `default_rng(0)`);
- the apply is one V-cycle with weighted-Jacobi smoothing through the
  port's `ell_spmv` and a dense Cholesky solve on the coarsest level;
- matvec="banded" gives every level but the coarsest the RCM-banded
  block-tridiagonal operator of `ops/banded.py`, each level's permutation
  folded into P and R on the host, so the V-cycle permutes only on entry
  and exit (the JAX package's option, kept for parity; on a GPU the ELL
  levels are the faster ones).

The hierarchy takes its dtype from A's values.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve
from ..ops.sparse import SparseOp, ell_spmv, from_scipy

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _strength(A: sp.csr_matrix, theta: float = 0.0):
    """Symmetric strength of connection: keep |a_ij| ≥ θ √(a_ii a_jj)."""
    if theta <= 0:
        return A
    d = np.sqrt(np.abs(A.diagonal()))
    C = A.tocoo()
    keep = np.abs(C.data) >= theta * d[C.row] * d[C.col]
    return sp.csr_matrix((C.data[keep], (C.row[keep], C.col[keep])), A.shape)


def _aggregate(S: sp.csr_matrix):
    """Greedy (standard) aggregation. Returns the aggregate of each node and
    their count."""
    n = S.shape[0]
    agg = -np.ones(n, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    na = 0
    # pass 1: root nodes with all-free neighbourhoods
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.all(agg[nbrs] < 0):
            agg[i] = na
            agg[nbrs] = na
            na += 1
    # pass 2: attach leftovers to an adjacent aggregate
    for i in range(n):
        if agg[i] < 0:
            nbrs = indices[indptr[i]:indptr[i + 1]]
            hit = nbrs[agg[nbrs] >= 0]
            if len(hit):
                agg[i] = agg[hit[0]]
            else:
                agg[i] = na
                na += 1
    return agg, na


def _spectral_radius_est(A: sp.csr_matrix, its: int = 15) -> float:
    rng = np.random.default_rng(0)
    v = rng.normal(size=A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(its):
        w = A @ v
        lam = np.linalg.norm(w)
        v = w / (lam + 1e-30)
    return float(lam)


def amg_setup(A_host: sp.spmatrix, max_levels: int = 10,
              max_coarse: int = 64, theta: float = 0.0,
              omega: float = 4.0 / 3.0, dtype=None, matvec: str = "ell",
              device=None):
    """Build the SA-AMG hierarchy on the host; the levels go to `device` in
    `dtype` (A's own when None). Returns dict(levels, coarse_L, perm0);
    perm0 is None, or (perm, iperm) of level 0 with matvec="banded"."""
    A = sp.csr_matrix(A_host)
    device, dtype = resolve(device, dtype or _TORCH_DTYPE.get(A.dtype))
    raw = []
    while A.shape[0] > max_coarse and len(raw) < max_levels - 1:
        agg, na = _aggregate(_strength(A, theta))
        if na >= A.shape[0]:  # aggregation stalled
            break
        T = sp.csr_matrix((np.ones(A.shape[0]), (np.arange(A.shape[0]), agg)),
                          shape=(A.shape[0], na))
        colnorm = np.sqrt(np.asarray(T.multiply(T).sum(axis=0)).ravel())
        T = T @ sp.diags(1.0 / colnorm)
        DinvA = sp.diags(1.0 / A.diagonal()) @ A
        rho = _spectral_radius_est(DinvA)
        P = sp.csr_matrix((sp.identity(A.shape[0]) - (omega / rho) * DinvA)
                          @ T)
        raw.append((A, P))
        A = sp.csr_matrix(P.T @ A @ P)

    def level(Aop, P, dinv):
        return dict(A=Aop, P=from_scipy(P, dtype=dtype, device=device),
                    R=from_scipy(sp.csr_matrix(P.T), dtype=dtype,
                                 device=device),
                    dinv=torch.as_tensor(dinv, dtype=dtype, device=device))

    perm0 = None
    if matvec == "banded" and raw:
        from ..ops.banded import build_banded_op
        bops = [build_banded_op(Al, dtype=dtype, device=device)
                for Al, _ in raw]
        # the coarsest level keeps the natural order
        perms = [b.perm.cpu().numpy() for b in bops] + [np.arange(A.shape[0])]
        levels = tuple(
            level(bops[k], sp.csr_matrix(P[perms[k]][:, perms[k + 1]]),
                  1.0 / Al.diagonal()[perms[k]])
            for k, (Al, P) in enumerate(raw))
        perm0 = (bops[0].perm, bops[0].iperm)
    else:
        levels = tuple(level(from_scipy(Al, dtype=dtype, device=device), P,
                             1.0 / Al.diagonal()) for Al, P in raw)
    coarse = torch.as_tensor(A.toarray(), dtype=dtype, device=device)
    coarse_L = torch.linalg.cholesky(
        coarse + 1e-12 * torch.eye(A.shape[0], dtype=dtype, device=device))
    return dict(levels=levels, coarse_L=coarse_L, perm0=perm0)


def _vcycle(npre, npost, hier, omega, r):
    """One V-cycle on r (n,) or on every column of a block r (n, k) at
    once (the JAX package vmaps the single apply over the columns)."""
    levels = hier["levels"]
    tail = [1] * (r.ndim - 1)

    def smooth(A, dinv, x, b, nsweep):
        dinv = dinv.view(-1, *tail)
        for _ in range(nsweep):
            x = x + omega * dinv * (b - A(x))
        return x

    def down(level, b):
        if level == len(levels):
            L = hier["coarse_L"]
            B = b.reshape(b.shape[0], -1)
            y = torch.linalg.solve_triangular(L, B, upper=False)
            return torch.linalg.solve_triangular(L.T, y,
                                                 upper=True).reshape(b.shape)
        lev = levels[level]
        x = smooth(lev["A"], lev["dinv"], torch.zeros_like(b), b, npre)
        xc = down(level + 1, ell_spmv(lev["R"], b - lev["A"](x)))
        x = x + ell_spmv(lev["P"], xc)
        return smooth(lev["A"], lev["dinv"], x, b, npost)

    if hier["perm0"] is not None:
        perm, iperm = hier["perm0"]
        return down(0, r[perm])[iperm]
    return down(0, r)


def amg_precond(A, max_levels: int = 10, max_coarse: int = 64,
                theta: float = 0.0, omega_smooth: float = 2.0 / 3.0,
                npre: int = 1, npost: int = 1, matvec: str = "ell",
                device=None, dtype=None):
    """One-V-cycle SA-AMG preconditioner (AMGPreconditioner analogue), on
    the device of A's values when A is a SparseOp. A scipy matrix is set up
    as given (its column order steers the aggregation) and its levels go
    to `device` (the config's when None); `dtype` is the levels' (A's own
    when None)."""
    if isinstance(A, SparseOp):
        A_host, device = A.to_scipy(), A.data.device
    else:
        A_host = sp.csr_matrix(A)
    hier = amg_setup(A_host, max_levels=max_levels, max_coarse=max_coarse,
                     theta=theta, matvec=matvec, device=device, dtype=dtype)
    return functools.partial(_vcycle, npre, npost, hier, omega_smooth)
