"""Diagonal (Jacobi) preconditioner.

Port of the Jacobi part of `krylov_spdes_tpu/precond/simple.py`.
"""

from __future__ import annotations

import functools

import torch

from ..ops.sparse import SparseOp


def sparse_diagonal(A: SparseOp) -> torch.Tensor:
    """diag(A) from the CSR view without densifying."""
    contrib = torch.where(A.indices == A.rows, A.data, 0.0)
    return contrib.new_zeros(A.n_rows).index_add_(0, A.rows, contrib)


def jacobi_precond(A: SparseOp):
    """M⁻¹ = diag(A)⁻¹."""
    return functools.partial(_diag_apply, 1.0 / sparse_diagonal(A))


def _diag_apply(dinv, r):
    return dinv * r
