"""RCM-banded block-tridiagonal operator for unstructured meshes.

Port of `krylov_spdes_tpu/ops/banded.py`. Reverse Cuthill-McKee orders an
SPD matrix into a band of width bw ≈ O(√n) on a 2-D mesh; the band is
packed into block-tridiagonal (D, E) with (m, m) blocks, m ≥ bw (the
packing of `precond/block_tridiag_chol.py::band_block_tridiag`). The matvec
is three batched (m, m) products and no gather:

    y_i = D_i x_i + E_i x_{i+1} + E_{i-1}ᵀ x_{i-1}

The JAX package built this for the TPU, whose CSR/ELL gathers run on its
scalar core. On a GPU the ELL gather is cheap and the banded form moves
2·nb·m²·4 bytes a matvec against ~n·k·12 for ELL, so there the banded
path is the slower one; it is ported for its semantics (the same options as
the JAX package, `amg_setup(matvec="banded")`, `banded_system`), not as a
fast path.

The permutation is folded into the system, not the matvec: solve A'x' = b'
with A' = A[perm][:, perm] (one gather at entry and one at exit of a
solve). `banded_system` packages that contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve
from ..solvers.base import f32_exact


@dataclasses.dataclass
class BandedOp:
    """Block-tridiagonal view of an RCM-banded SPD matrix.

    D: (nb, m, m) diagonal blocks (both triangles; padded tail rows are
       identity, so the padding is inert)
    E: (nb, m, m) super-diagonal blocks, E[i] couples block i to block i+1
       (E[nb-1] is zero)
    perm/iperm: the RCM permutation, original <-> banded ordering
    n: true dimension (nb·m ≥ n)
    m: block size (≥ bandwidth)
    """
    D: torch.Tensor
    E: torch.Tensor
    perm: torch.Tensor
    iperm: torch.Tensor
    n: int
    m: int

    @property
    def nb(self) -> int:
        return self.D.shape[0]

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, xp: torch.Tensor) -> torch.Tensor:
        return banded_matvec(self, xp)

    def __call__(self, xp: torch.Tensor) -> torch.Tensor:
        return banded_matvec(self, xp)


@f32_exact
def banded_matvec(op: BandedOp, xp: torch.Tensor) -> torch.Tensor:
    """y' = A' x' in the permuted (banded) ordering; xp is (n,) or an
    (n, k) block. TF32 stays off (the JAX package's Precision.HIGHEST)."""
    nb, m, n = op.nb, op.m, op.n
    x = xp.new_zeros((nb * m,) + tuple(xp.shape[1:]))
    x[:n] = xp
    x = x.reshape(nb, m, -1)
    y = op.D @ x
    y[:-1] += op.E[:-1] @ x[1:]
    y[1:] += op.E[:-1].transpose(-1, -2) @ x[:-1]
    return y.reshape((nb * m,) + tuple(xp.shape[1:]))[:n]


def build_banded_op(A_sp, block: int | None = None, dtype=None,
                    device=None) -> BandedOp:
    """RCM and band packing on the host (`band_block_tridiag`), the blocks
    on `device` in `dtype`. A_sp: a scipy sparse matrix or a SparseOp."""
    from ..precond.block_tridiag_chol import band_block_tridiag
    device, dtype = resolve(device, dtype)
    D, E, perm, n = band_block_tridiag(A_sp, block=block)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    idx = lambda a: torch.as_tensor(a.astype(np.int64),  # noqa: E731
                                    device=device)
    return BandedOp(D=torch.as_tensor(D, dtype=dtype, device=device),
                    E=torch.as_tensor(E, dtype=dtype, device=device),
                    perm=idx(perm), iperm=idx(iperm), n=int(n),
                    m=int(D.shape[1]))


def banded_system(A_sp, b, block: int | None = None, dtype=None,
                  device=None):
    """Permute the whole system once: returns (op, b', unpermute, op) with
    `op` the banded matvec (a callable the solvers take), b' = b[perm] and
    `unpermute(x')` the solution in the original ordering. A SparseOp's
    device and dtype are the defaults."""
    if device is None and dtype is None and hasattr(A_sp, "data") \
            and torch.is_tensor(A_sp.data):
        device, dtype = A_sp.data.device, A_sp.data.dtype
    op = build_banded_op(A_sp, block=block, dtype=dtype, device=device)
    bp = torch.as_tensor(b, dtype=op.D.dtype, device=op.D.device)[op.perm]
    return op, bp, (lambda xp: xp[op.iperm]), op
