"""Diagonal (Jacobi) and Chebyshev preconditioners.

Port of `krylov_spdes_tpu/precond/simple.py`. Chebyshev polynomial
preconditioning stands in where the reference reaches for sequential
smoothers.
"""

from __future__ import annotations

import functools

import torch

from ..ops.sparse import SparseOp
from ..solvers.base import as_linear_op


def sparse_diagonal(A: SparseOp) -> torch.Tensor:
    """diag(A) from the CSR view without densifying."""
    contrib = torch.where(A.indices == A.rows, A.data, 0.0)
    return contrib.new_zeros(A.n_rows).index_add_(0, A.rows, contrib)


def jacobi_precond(A: SparseOp):
    """M⁻¹ = diag(A)⁻¹."""
    return functools.partial(_diag_apply, 1.0 / sparse_diagonal(A))


def _diag_apply(dinv, r):
    """dinv ⊙ r for a vector r (n,) or each column of a block r (n, k)."""
    return dinv.view(-1, *[1] * (r.ndim - 1)) * r


def _cheby_apply(degree, A, dinv, lmin, lmax, r):
    """Chebyshev iteration on the Jacobi-scaled operator, zero initial guess,
    on a vector r or on each column of a block r (n, k)."""
    dinv = dinv.view(-1, *[1] * (r.ndim - 1))
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    z = dinv * r
    x = z / theta
    rk = r - A(x)
    prev_x = x
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        z = dinv * rk
        x_new = x + (2.0 * rho_new / delta) * z + rho_new * rho * (x - prev_x)
        prev_x, rho, x = x, rho_new, x_new
        rk = r - A(x)
    return x


def chebyshev_precond(A: SparseOp, lmax_est: float | None = None,
                      degree: int = 4, lmin_frac: float = 0.06,
                      generator: torch.Generator | None = None):
    """Degree-k Chebyshev polynomial preconditioner on D⁻¹A.

    lmax is estimated by 12 power iterations when not given, from a start
    vector drawn with `generator` (a generator on A's device seeded with 0
    when None; the JAX package draws it from PRNGKey(0), so the two
    estimates differ and parity checks pass `lmax_est`). The window is
    [lmin_frac·lmax, 1.1·lmax]."""
    if not isinstance(A, SparseOp):
        raise TypeError("chebyshev_precond needs a SparseOp (for its diagonal)")
    Afn = as_linear_op(A)
    dinv = 1.0 / sparse_diagonal(A)
    if lmax_est is None:
        if generator is None:
            generator = torch.Generator(device=A.data.device).manual_seed(0)
        v = torch.randn(A.n_rows, generator=generator, dtype=A.data.dtype,
                        device=A.data.device)
        for _ in range(12):
            v = dinv * Afn(v)
            v = v / torch.linalg.vector_norm(v)
        lmax_est = float(torch.dot(v, dinv * Afn(v)))
    return functools.partial(_cheby_apply, degree, Afn, dinv,
                             lmin_frac * lmax_est, 1.1 * lmax_est)
