"""Fixed-sparsity sparse matrix container and SpMV.

Port of `krylov_spdes_tpu/ops/sparse.py`. The symbolic structure (indices)
is computed once on the host per mesh; per-realization updates rewrite only
the value vector (`update_isotropic_elliptic_assembly!`,
Fem/EllipticPde.jl:291). Two views share one CSR-ordered value vector:

- CSR (indptr/indices/rows): the symbolic structure.
- ELL (row-padded to the max row degree k): `y = sum_k data[n,k] x[cols[n,k]]`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve


@dataclasses.dataclass
class SparseOp:
    """Square-ish sparse operator with fixed symbolic structure.

    data:     (nnz,)  values in CSR order
    indptr:   (n_rows+1,) CSR row pointers
    indices:  (nnz,)  CSR column indices
    rows:     (nnz,)  row index of each value
    ell_idx:  (n_rows, k) index into [data, 0.0-pad] for the ELL view
    ell_cols: (n_rows, k) column index for the ELL view (0 where padded)
    """
    data: torch.Tensor
    indptr: torch.Tensor
    indices: torch.Tensor
    rows: torch.Tensor
    ell_idx: torch.Tensor
    ell_cols: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def with_data(self, data: torch.Tensor) -> "SparseOp":
        return dataclasses.replace(self, data=data)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)

    def todense(self) -> torch.Tensor:
        out = self.data.new_zeros((self.n_rows, self.n_cols))
        out[self.rows, self.indices] = self.data
        return out


def ell_spmv(A: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """SpMV through the ELL view: two gathers + a k-axis reduction."""
    data_pad = torch.cat([A.data, A.data.new_zeros(1)])
    d = data_pad[A.ell_idx]                  # (n, k)
    xg = x[A.ell_cols]                       # (n, k) (or (n, k, m) for multi-rhs)
    if x.ndim == 1:
        return torch.sum(d * xg, dim=1)
    return torch.einsum("nk,nkm->nm", d, xg)


def build_sparse_op(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                    n_cols: int, dtype=None, device=None):
    """Host-side symbolic construction from (unsorted, possibly duplicated)
    COO coordinates. Returns (op_with_zero_data, slot) where slot[i] is the
    canonical nnz index of coordinate i: summing contributions into slots
    reproduces `sparse(I, J, V)` (Fem/EllipticPde.jl:146)."""
    device, dtype = resolve(device, dtype)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    key = rows * n_cols + cols
    uniq, slot = np.unique(key, return_inverse=True)
    u_rows = uniq // n_cols
    u_cols = uniq % n_cols
    nnz = uniq.shape[0]

    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, u_rows + 1, 1)
    np.cumsum(indptr, out=indptr)

    row_deg = np.diff(indptr)
    k = int(row_deg.max()) if nnz else 1
    ell_idx = np.full((n_rows, k), nnz, dtype=np.int64)  # nnz == zero-pad slot
    ell_cols = np.zeros((n_rows, k), dtype=np.int64)
    pos = np.arange(nnz) - np.repeat(indptr[:-1], row_deg)
    ell_idx[u_rows, pos] = np.arange(nnz)
    ell_cols[u_rows, pos] = u_cols

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    op = SparseOp(
        data=torch.zeros(nnz, dtype=dtype, device=device),
        indptr=t(indptr), indices=t(u_cols), rows=t(u_rows),
        ell_idx=t(ell_idx), ell_cols=t(ell_cols),
        n_rows=n_rows, n_cols=n_cols)
    return op, slot.astype(np.int64)
