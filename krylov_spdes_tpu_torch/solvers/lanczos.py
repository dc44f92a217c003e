"""Plain Lanczos Ritz-pair extraction.

Port of `krylov_spdes_tpu/solvers/lanczos.py` (reference:
RecyclingKrylovSolvers/eigen.jl:1-64): nvec reorthogonalization-free Lanczos
steps, then `nev` most- (MD) or least- (LD) dominant Ritz pairs with
residual estimates |β·y_last|. The recurrence runs nvec fixed steps with no
read-back; the tridiagonal eigensolve is one small eigh.
"""

from __future__ import annotations

import torch

from ..config import resolve
from .base import as_linear_op, f32_exact
from .cg import _dot


@f32_exact
def _lanczos_impl(A, v0, nev, nvec, which):
    n = v0.shape[0]
    V = v0.new_zeros((nvec, n))
    v1 = v0 / torch.linalg.vector_norm(v0)
    V[0] = v1
    p = A(v1)
    alpha = _dot(v1, p)
    diag = v0.new_zeros(nvec)
    diag[0] = alpha
    off = v0.new_zeros(nvec - 1)
    beta = v0.new_zeros(())
    for i in range(nvec - 1):
        w = p - alpha * V[i]
        if i > 0:
            w = w - beta * V[i - 1]
        beta = torch.linalg.vector_norm(w)
        vi = w / beta
        V[i + 1] = vi
        p = A(vi)
        alpha = _dot(vi, p)
        diag[i + 1] = alpha
        off[i] = beta

    w = p - alpha * V[nvec - 1] - beta * V[nvec - 2]
    beta = torch.linalg.vector_norm(w)

    T = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
    vals, vecs = torch.linalg.eigh(T)   # ascending
    if which == "MD":
        idx = torch.arange(nvec - 1, nvec - 1 - nev, -1, device=v0.device)
    else:  # least dominant
        idx = torch.arange(nev, device=v0.device)
    sel_vals = vals[idx]
    sel_vecs = vecs[:, idx]
    Y = (sel_vecs.T @ V).T                      # (n, nev)
    res = torch.abs(beta * sel_vecs[nvec - 1, :])
    return sel_vals, Y, res


def lanczos(A, n=None, nev: int = 5, nvec: int = 30, which: str = "MD",
            generator: torch.Generator | None = None, v0=None):
    """Returns (vals, Y, res): nev Ritz values/vectors + residual estimates.

    The start vector is v0 when given, else drawn uniform on [0, 1) from
    `generator` (the JAX package draws it from PRNGKey(0); parity checks
    hand over the same v0). It takes A's dtype and device when A has values
    (`.data`), else the config's."""
    Afn = as_linear_op(A)
    if v0 is None:
        if n is None:
            n = A.shape[0]
        data = getattr(A, "data", None)
        if isinstance(data, torch.Tensor):
            device, dtype = data.device, data.dtype
        else:
            device, dtype = resolve()
        v0 = torch.rand(n, generator=generator, dtype=dtype, device=device)
    return _lanczos_impl(Afn, v0, nev, nvec, which)
