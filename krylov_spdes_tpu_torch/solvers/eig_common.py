"""eigCG restart machinery, shared by all recycling solvers.

Port of `krylov_spdes_tpu/solvers/eig_common.py`. The reference's thick
restart (RecyclingKrylovSolvers/eigcg.jl:83-101) merges two least-dominant
eigenbases of the projected tridiagonal, takes `nev = rank(Y)` (nvec <= nev
<= 2nvec), and compresses the search space to nev vectors. As in the JAX
package the computation runs at the full shapes (spdim, 2nvec) with masking,
so that one code path serves every rank and a leading batch axis:

- Inactive coordinates get a BIG diagonal shift: eigenpairs of masked-out
  coordinates get an eigenvalue above the Gershgorin bound of the valid
  block, so ascending `eigh` sorts every true least-dominant pair into the
  leading columns.
- Columns >= nev of the results are zero.

The generalized-pair variants (`_masked_gen_eigvecs`, `ritz_basis_gen`,
`thick_restart_basis_gen`) are the projections of the RR/HR recyclers
(solvers/recyclers.py).
"""

from __future__ import annotations

import torch


def _sym(T):
    return (T + T.transpose(-1, -2)) / 2


def _spd_ridge(T):
    """eps-scaled diagonal ridge before a small Cholesky: in float32 the
    projected metrics are SPD only up to rounding and a marginal pivot
    NaN-poisons the whole recycled basis. The ridge is ~10·eps relative to
    the largest diagonal entry: invisible in float64, a rescue in float32."""
    d = torch.diagonal(T, dim1=-2, dim2=-1).abs().max()
    s = T.shape[-1]
    return T + (10 * torch.finfo(T.dtype).eps * d) * torch.eye(
        s, dtype=T.dtype, device=T.device)


def _abs_sum(T):
    return T.abs().sum(dim=(-2, -1))[..., None, None]


def masked_least_eigvecs(Tm, k: int, active):
    """Least-dominant k eigenvectors of the active block of Tm.

    Tm: (s, s) with valid block active×active (already zero outside).
    active: (s,) bool mask. Returns (s, k) vectors supported on active
    coordinates."""
    big = 2.0 + _abs_sum(Tm)
    shifted = Tm + big * torch.diag_embed((~active).to(Tm.dtype))
    _, U = torch.linalg.eigh(shifted)
    return U[..., :, :k]


def matrix_rank_tol(s, m: int, n: int):
    """nev = rank from singular values (descending, last axis) with numpy's
    default tolerance s_max·max(m, n)·eps."""
    eps = torch.finfo(s.dtype).eps
    return torch.sum(s > s[..., :1] * (max(m, n) * eps), dim=-1)


def thick_restart_basis(Tm, nvec: int, active_dim):
    """eigCG restart: (vals, QZ, nev) at full shapes.

    Tm: (..., spdim, spdim) projected operator whose valid block has size
    active_dim (an int, or an integer tensor of the batch shape). Returns
      vals: (..., 2nvec) new Ritz values ascending, zero beyond nev
      QZ:   (..., spdim, 2nvec) combination weights, columns >= nev zero
      nev:  (...) int64 tensor, rank of the merged double basis
    """
    spdim = Tm.shape[-1]
    dtype, dev = Tm.dtype, Tm.device
    i = torch.arange(spdim, device=dev)
    ad = torch.as_tensor(active_dim, device=dev)[..., None]
    act = (i < ad).to(dtype)
    Tm0 = _sym(Tm) * act[..., :, None] * act[..., None, :]

    # the two least-dominant bases use independent BIG-shifted matrices:
    # one batched eigh
    act2 = (i < ad - 1).to(dtype)
    Tm2 = Tm0 * act2[..., :, None] * act2[..., None, :]
    sh0 = Tm0 + (2.0 + _abs_sum(Tm0)) * torch.diag_embed(1.0 - act)
    sh2 = Tm2 + (2.0 + _abs_sum(Tm2)) * torch.diag_embed(1.0 - act2)
    _, Ub = torch.linalg.eigh(torch.stack([sh0, sh2]))
    Y = torch.cat([Ub[0][..., :, :nvec], Ub[1][..., :, :nvec]], dim=-1)

    U, s, _ = torch.linalg.svd(Y, full_matrices=False)
    nev = matrix_rank_tol(s, spdim, 2 * nvec)
    colmask = (torch.arange(2 * nvec, device=dev) < nev[..., None]).to(dtype)

    Q = U[..., :, :2 * nvec] * colmask[..., None, :]
    H = Q.transpose(-1, -2) @ Tm0 @ Q
    Hm = _sym(H) + (2.0 + _abs_sum(H)) * torch.diag_embed(1.0 - colmask)
    vals, Z = torch.linalg.eigh(Hm)
    vals = vals * colmask
    QZ = (Q @ Z) * colmask[..., None, :]
    return vals, QZ, nev


def _masked_gen_eigvecs(S, T, k: int, active):
    """First k generalized eigenvectors of (S, T) restricted to the active
    block. T's active block must be SPD.

    Masking: T gets identity on inactive coordinates (stays SPD), S gets a
    BIG diagonal there so inactive pairs sort last under ascending eigh.
    Returns (..., s, k) vectors supported on active coordinates. `active`
    may carry a leading batch axis: every factorization then runs batched,
    as in the JAX package (LO-TR's two masks are one call)."""
    dtype = S.dtype
    act = active.to(dtype)
    actf = act[..., :, None]                             # (..., s, 1)
    actr = actf * actf.transpose(-1, -2)                 # (..., s, s)
    eye_in = torch.diag_embed(1.0 - act)
    S0 = _sym(S) * actr
    T0 = _sym(T) * actr + eye_in
    S0 = S0 + (2.0 + _abs_sum(S0)) * eye_in
    L = torch.linalg.cholesky(_spd_ridge(T0))
    Y = torch.linalg.solve_triangular(L, S0, upper=False)
    B = torch.linalg.solve_triangular(L, Y.transpose(-1, -2), upper=False)
    _, U = torch.linalg.eigh(_sym(B))
    V = torch.linalg.solve_triangular(L.transpose(-1, -2), U[..., :, :k],
                                      upper=True)
    return V * actf


def ritz_basis_gen(S, T, nvec: int, active_dim: int):
    """First nvec generalized Ritz vectors of (S, T) over the active block:
    the single-basis RR/HR projection (rrdefpcg.jl:126-148,
    hrdefpcg.jl:130-161). Returns coefs (s, nvec)."""
    act = torch.arange(S.shape[-1], device=S.device) < active_dim
    return _masked_gen_eigvecs(S, T, nvec, act)


def thick_restart_basis_gen(S, T, nvec: int, active_dim: int):
    """LO-TR restart: double generalized basis + rank-SVD merge
    (lotrrrdefpcg.jl:167-182). Returns (vals, QZ, nev) like
    `thick_restart_basis`, for a generalized pair (S, T).

    The compressed nev-sized problem is itself generalized: the reference
    solves eigen(QᵀSQ, QᵀTQ) (lotrhrdefpcg.jl:185-188). For the RR metric
    T = I this reduces to the plain eigh(QᵀSQ) of lotrrrdefpcg.jl:172-174."""
    s = S.shape[-1]
    dtype, dev = S.dtype, S.device
    i = torch.arange(s, device=dev)
    act = i < active_dim
    actf = act.to(dtype)
    S0 = _sym(S) * actf[:, None] * actf[None, :]
    T0 = _sym(T) * actf[:, None] * actf[None, :]

    Yb = _masked_gen_eigvecs(S, T, nvec,
                             torch.stack([act, i < active_dim - 1]))
    Y = torch.cat([Yb[0], Yb[1]], dim=1)

    U, sv, _ = torch.linalg.svd(Y, full_matrices=False)
    nev = matrix_rank_tol(sv, s, 2 * nvec)
    colmask = (torch.arange(2 * nvec, device=dev) < nev).to(dtype)
    Q = U[:, :2 * nvec] * colmask[None, :]
    H = Q.T @ S0 @ Q
    Hm = _sym(H) + (2.0 + _abs_sum(H)) * torch.diag(1.0 - colmask)
    # Q's rows are supported on active coordinates, so QᵀT0Q is exactly VᵀTV
    # on the live columns; masked columns get identity to keep it SPD
    Gm = _sym(Q.T @ T0 @ Q) + torch.diag(1.0 - colmask)
    L = torch.linalg.cholesky(_spd_ridge(Gm))
    B = torch.linalg.solve_triangular(L, Hm, upper=False)
    B = torch.linalg.solve_triangular(L, B.T, upper=False)
    vals, Zo = torch.linalg.eigh(_sym(B))
    Z = torch.linalg.solve_triangular(L.T, Zo, upper=True)
    vals = vals * colmask
    QZ = (Q @ Z) * colmask[None, :]
    return vals, QZ, nev
