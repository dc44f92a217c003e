"""Block-Jacobi preconditioner with batched Cholesky.

Port of `krylov_spdes_tpu/precond/block_jacobi.py` (reference:
MyPreconditioners/BJPreconditioner.jl:1-32): the index range is cut into
`nb` contiguous blocks, the blocks (padded to the largest) are gathered from
the CSR value vector into a dense (nb, bmax, bmax) batch through a plan
built once on the host, factorised by one batched Cholesky and applied by
batched triangular solves. A rebuild per realization is a refresh of the
values, on the device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.sparse import SparseOp


@dataclasses.dataclass
class BlockJacobiPlan:
    """Static plan: CSR slot -> (block, i, j) for the in-block entries."""
    sel: torch.Tensor     # (n_in,) indices into A.data of in-block entries
    blk: torch.Tensor     # (n_in,) block of each entry
    ii: torch.Tensor      # (n_in,) local row
    jj: torch.Tensor      # (n_in,) local column
    starts: np.ndarray    # (nb,) block start offsets
    sizes: np.ndarray     # (nb,) block sizes
    nb: int
    bmax: int
    n: int


def prepare_block_jacobi_plan(A: SparseOp, nb: int) -> BlockJacobiPlan:
    """Host-side symbolic setup (contiguous equal slices, BJPreconditioner.jl
    `slice`, :12-18)."""
    n = A.n_rows
    sizes = np.full(nb, n // nb, dtype=np.int64)
    sizes[:n % nb] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rows = A.rows.cpu().numpy()
    cols = A.indices.cpu().numpy()
    rb = np.searchsorted(starts, rows, side="right") - 1
    cb = np.searchsorted(starts, cols, side="right") - 1
    inb = rb == cb
    t = lambda a: torch.as_tensor(a.astype(np.int64),  # noqa: E731
                                  device=A.data.device)
    return BlockJacobiPlan(
        sel=t(np.nonzero(inb)[0]), blk=t(rb[inb]),
        ii=t(rows[inb] - starts[rb[inb]]), jj=t(cols[inb] - starts[cb[inb]]),
        starts=starts, sizes=sizes, nb=nb, bmax=int(sizes.max()), n=n)


def _factorize(data, plan: BlockJacobiPlan):
    """Cholesky factors of the padded blocks; the padding is identity."""
    blocks = data.new_zeros((plan.nb, plan.bmax, plan.bmax))
    blocks[plan.blk, plan.ii, plan.jj] = data[plan.sel]   # distinct entries
    pad = torch.as_tensor(np.arange(plan.bmax)[None, :] >= plan.sizes[:, None],
                          device=data.device)
    blocks.diagonal(dim1=-2, dim2=-1).add_(pad.to(data.dtype))
    return torch.linalg.cholesky(blocks)


def _bj_apply(L, gather_idx, scatter_mask, valid, r):
    """Batched lower/upper triangular solves over the padded blocks; the
    blocks tile [0, n) in order, so the valid slots, read in order, are the
    output."""
    rb = r[gather_idx] * scatter_mask                      # (nb, bmax)
    y = torch.linalg.solve_triangular(L, rb[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x.reshape(-1)[valid]


def block_jacobi_precond(A: SparseOp, nb: int,
                         plan: BlockJacobiPlan | None = None):
    """The preconditioner for the current values of A. Reuse `plan` across
    realizations (fixed sparsity)."""
    if plan is None:
        plan = prepare_block_jacobi_plan(A, nb)
    L = _factorize(A.data, plan)
    local = np.arange(plan.bmax)[None, :]
    gi = np.minimum(plan.starts[:, None] + local, plan.n - 1)
    mask = local < plan.sizes[:, None]
    dev = A.data.device
    return functools.partial(
        _bj_apply, L, torch.as_tensor(gi, device=dev),
        torch.as_tensor(mask, dtype=A.data.dtype, device=dev),
        torch.as_tensor(np.flatnonzero(mask), device=dev))
