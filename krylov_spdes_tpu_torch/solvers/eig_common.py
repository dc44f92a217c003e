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

The generalized-pair variants of the JAX module (`ritz_basis_gen`,
`thick_restart_basis_gen`) belong to the RR/HR recyclers and are not ported
yet.
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
