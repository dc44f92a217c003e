"""Blocked LOBPCG for the generalized KL eigenproblem C ψ = λ M ψ.

Port of `krylov_spdes_tpu/kl/lobpcg.py`: the ARPACK replacement at scale.
`solve_kl`'s dense Cholesky+eigh path is O(n³); LOBPCG needs only C-applies
((n, n)×(n, k) products, or the row-chunked matrix-free apply) and small
Rayleigh–Ritz eigensolves, O(n²k) an iteration with block size k. It solves
for the nev LARGEST eigenvalues of (C, M), the dominant KL modes.

The start block is X0 when given, else drawn from `generator`: the JAX
package draws it from PRNGKey(0), and parity checks hand that block over.
"""

from __future__ import annotations

import torch

from ..config import resolve
from ..solvers.base import f32_exact


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _m_orthonormalize(X, Mfn):
    """M-orthonormalize the columns of X via the Cholesky factor of XᵀMX."""
    G = X.T @ Mfn(X)
    L = torch.linalg.cholesky((G + G.T) / 2)
    return _solve_lower(L, X.T).T


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


@f32_exact
def _lobpcg_impl(Cfn, Mfn, X0, iters):
    k = X0.shape[1]

    def rayleigh_ritz(S):
        """Ritz pairs of (C, M) over span(S); returns the top-k pairs."""
        G = S.T @ Mfn(S)
        # regularize + whiten the basis
        G = (G + G.T) / 2 + 1e-12 * torch.trace(G) / G.shape[0] * _eye(
            G.shape[0], G)
        L = torch.linalg.cholesky(G)
        H = S.T @ Cfn(S)
        H = (H + H.T) / 2
        Hw = _solve_lower(L, H)
        Hw = _solve_lower(L, Hw.T)
        w, U = torch.linalg.eigh((Hw + Hw.T) / 2)
        w = w.flip(0)[:k]
        U = U.flip(1)[:, :k]
        Y = torch.linalg.solve_triangular(L.T, U, upper=True)
        return w, S @ Y

    def proj_out(A, B):
        """Remove the M-span of B from A (B M-orthonormal)."""
        return A - B @ (B.T @ Mfn(A))

    def safe_orthonormalize(A):
        G = A.T @ Mfn(A)
        G = (G + G.T) / 2 + torch.finfo(A.dtype).eps * 10 * torch.trace(G) \
            / G.shape[0] * _eye(G.shape[0], G)
        return _solve_lower(torch.linalg.cholesky(G), A.T).T

    X = _m_orthonormalize(X0, Mfn)
    lam, X = rayleigh_ritz(X)
    # a random conjugate-direction block (a zero P would make the first
    # orthonormalization singular)
    P = X0.flip(1)
    for _ in range(iters):
        R = Cfn(X) - Mfn(X) * lam[None, :]
        # keep the trial basis well-conditioned: project R, P off X and
        # M-orthonormalize each block before Rayleigh–Ritz
        R = safe_orthonormalize(proj_out(R, X))
        P = safe_orthonormalize(proj_out(P, X))
        lam_new, X_new = rayleigh_ritz(torch.cat([X, R, P], dim=1))
        P = X_new - X @ (X.T @ Mfn(X_new))
        X, lam = X_new, lam_new
    return lam, X


def lobpcg_generalized(Cfn, Mfn, n, nev, iters: int = 40, extra: int = 8,
                       generator: torch.Generator | None = None, X0=None,
                       dtype=None, device=None):
    """Top-nev eigenpairs of (C, M); block size nev + extra for the
    convergence of the trailing pairs. Cfn/Mfn: (n, k) -> (n, k)."""
    device, dtype = resolve(device, dtype)
    k = nev + extra
    if X0 is None:
        X0 = torch.randn(n, k, generator=generator, dtype=dtype,
                         device=device)
    else:
        X0 = (X0 if isinstance(X0, torch.Tensor) else torch.tensor(X0)).to(
            dtype=dtype, device=device)
    lam, X = _lobpcg_impl(Cfn, Mfn, X0, iters)
    return lam[:nev], X[:, :nev]
