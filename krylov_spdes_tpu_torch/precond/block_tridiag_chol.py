"""Sparse Cholesky as block-tridiagonal Cholesky.

Port of `krylov_spdes_tpu/precond/block_tridiag_chol.py` (reference call
sites: EllipticPdeDomainDecomposition.jl:1518-1537,
MyPreconditioners/CholPreconditioners.jl:5-56). Two structures reduce to
one engine:

1. A 9-point stencil operator on an (H, W) grid is block-tridiagonal with H
   dense (W, W) blocks (a grid row couples only with its two neighbours).
2. A general sparse SPD matrix, ordered by reverse Cuthill-McKee on the
   host (scipy), has a band of width b and is block-tridiagonal with blocks
   of size m ≥ b.

The engine is the sequential block recurrence the DD interiors already use
(`fem/schur.py::bt_factor_batched`, `bt_interior_solve`): a host loop of
dense (m, m) Cholesky, triangular-inverse and product steps, storing L_i⁻¹
and G_i = L_i⁻¹ E_i, optionally in bfloat16 (upcast to float32 for the
solves). These factors are preconditioners at reduced precision, as in the
reference's Cholesky arms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve
from ..fem.schur import bt_factor_batched, bt_interior_solve
from ..ops.stencil import StencilOp


def btc_factor(D, E, store_dtype=None):
    """Factor a block-tridiagonal SPD matrix: D (nb, m, m) diagonal blocks,
    E (nb, m, m) with E[i] = A[block i, block i+1] (E[nb-1] unused).
    Returns (Linv, G): Linv[i] the inverse lower Cholesky factor of the
    i-th Schur complement, G[i] = Linv[i] E[i], stored in `store_dtype`."""
    Linv, G = bt_factor_batched(D, E)
    if store_dtype is not None:
        Linv, G = Linv.to(store_dtype), G.to(store_dtype)
    return Linv, G


def _btc_solve(out_dtype, Linv, G, b):
    """x = A⁻¹ b through the block factors; b (nb, m)."""
    cdt = torch.float32 if Linv.dtype == torch.bfloat16 else Linv.dtype
    x = bt_interior_solve(Linv.to(cdt), G.to(cdt), b.reshape(-1).to(cdt))
    return x.reshape(b.shape).to(out_dtype)


def stencil_to_block_tridiag(S: StencilOp):
    """D[i]: the coupling within grid row i (tridiagonal W × W); E[i]: the
    coupling of row i to row i + 1 (the N, NE and NW planes). Plane order
    follows ops/stencil.OFFSETS: self, E, W, N, S, NE, SW, SE, NW."""
    H, W = S.H, S.W
    p = S.planes
    j = torch.arange(W, device=p.device)
    D = p.new_zeros((H, W, W))
    D[:, j, j] = p[0] + S.dir_diag
    D[:, j[:-1], j[:-1] + 1] = p[1][:, :-1]     # E: (0, +1)
    D[:, j[1:], j[1:] - 1] = p[2][:, 1:]        # W: (0, -1)
    E = p.new_zeros((H, W, W))
    E[:, j, j] = p[3]                           # N: (+1, 0)
    E[:, j[:-1], j[:-1] + 1] = p[5][:, :-1]     # NE: (+1, +1)
    E[:, j[1:], j[1:] - 1] = p[7][:, 1:]        # SE-labelled (+1, -1)
    return D, E


def get_stencil_cholesky(S: StencilOp, dtype=torch.float32, store_dtype=None):
    """Full-system Cholesky preconditioner of a stencil operator: the
    Cholesky32 (dtype float32) or Cholesky16 (store_dtype bfloat16)
    analogue at scale."""
    D, E = stencil_to_block_tridiag(S)
    L, G = btc_factor(D.to(dtype), E.to(dtype), store_dtype=store_dtype)
    return functools.partial(_stencil_btc_apply, S.planes.dtype, S.H, S.W,
                             L, G)


def _stencil_btc_apply(out_dtype, H, W, L, G, r):
    return _btc_solve(out_dtype, L, G, r.reshape(H, W)).reshape(-1)


def band_block_tridiag(A_sp, block: int | None = None):
    """Host-side: RCM-order a scipy sparse SPD matrix and pack its band into
    block-tridiagonal (D, E) with block size m ≥ bandwidth, n padded to a
    multiple of m with identity rows. Returns (D, E, perm, n) as numpy."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    if hasattr(A_sp, "to_scipy"):     # the port's SparseOp
        A_sp = A_sp.to_scipy()
    A_sp = sp.csr_matrix(A_sp)
    n = A_sp.shape[0]
    perm = np.asarray(reverse_cuthill_mckee(A_sp, symmetric_mode=True))
    Ap = A_sp[perm][:, perm].tocoo()
    bw = int(np.abs(Ap.row - Ap.col).max()) if Ap.nnz else 1
    m = block or max(bw, 1)
    if m < bw:
        raise ValueError(f"block {m} is below the bandwidth {bw}")
    nb = -(-n // m)
    D = np.zeros((nb, m, m))
    E = np.zeros((nb, m, m))
    bi, ri = Ap.row // m, Ap.row % m
    bj, cj = Ap.col // m, Ap.col % m
    same = bi == bj
    np.add.at(D, (bi[same], ri[same], cj[same]), Ap.data[same])
    up = bj == bi + 1
    np.add.at(E, (bi[up], ri[up], cj[up]), Ap.data[up])
    for k in range(n, nb * m):        # padded tail rows: identity
        D[k // m, k % m, k % m] = 1.0
    return D, E, perm, n


def get_banded_cholesky(A_sp, dtype=torch.float32, store_dtype=None,
                        block: int | None = None, out_dtype=None,
                        device=None):
    """Sparse Cholesky preconditioner of a general SPD matrix (the A_ΓΓ
    class): RCM and band packing on the host, the block-tridiagonal factor
    and solves on `device`. The apply returns `out_dtype` (the port's
    default dtype when None)."""
    device, out_dtype = resolve(device, out_dtype)
    D, E, perm, n = band_block_tridiag(A_sp, block=block)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    L, G = btc_factor(t(D), t(E), store_dtype=store_dtype)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    idx = lambda a: torch.as_tensor(a.astype(np.int64),  # noqa: E731
                                    device=device)
    return functools.partial(_perm_btc_apply, out_dtype, n, D.shape[1], L, G,
                             idx(perm), idx(iperm))


def _perm_btc_apply(out_dtype, n, m, L, G, perm, iperm, r):
    nb = L.shape[0]
    rp = r.new_zeros(nb * m)
    rp[:n] = r[perm]
    x = _btc_solve(out_dtype, L, G, rp.reshape(nb, m)).reshape(-1)
    return x[:n][iperm]
