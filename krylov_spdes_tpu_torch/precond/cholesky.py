"""Low-precision dense Cholesky preconditioners.

Port of `krylov_spdes_tpu/precond/cholesky.py` (reference:
MyPreconditioners/CholPreconditioners.jl:5-56, `Cholesky32`/`Cholesky16`).
The factorisation runs at the chosen precision on the device: float32, or
bfloat16 storage of the float32 factor. `torch.linalg.solve_triangular` has
no bfloat16, so the bfloat16 factor is upcast to float32 for the solves,
as the JAX package does.
"""

from __future__ import annotations

import functools

import torch

from ..ops.sparse import SparseOp


def _dense(A):
    return A.todense() if isinstance(A, SparseOp) else torch.as_tensor(A)


def _chol_apply(out_dtype, L, r):
    y = torch.linalg.solve_triangular(L, r.to(L.dtype)[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x[:, 0].to(out_dtype)


def _chol_apply_bf16(out_dtype, L16, r):
    return _chol_apply(out_dtype, L16.to(torch.float32), r)


def get_cholesky(A, dtype=torch.float32):
    """Dense Cholesky preconditioner of A, factorised at `dtype`; the apply
    returns A's dtype."""
    Ad = _dense(A)
    L = torch.linalg.cholesky(Ad.to(dtype))
    return functools.partial(_chol_apply, Ad.dtype, L)


def get_cholesky32(A):
    """Cholesky32 analogue (CholPreconditioners.jl:31-56)."""
    return get_cholesky(A, torch.float32)


def get_cholesky16(A):
    """Cholesky16 analogue (CholPreconditioners.jl:5-29): bfloat16 storage
    of the float32 factor, upcast for the triangular solves."""
    Ad = _dense(A)
    L = torch.linalg.cholesky(Ad.to(torch.float32)).to(torch.bfloat16)
    return functools.partial(_chol_apply_bf16, Ad.dtype, L)
