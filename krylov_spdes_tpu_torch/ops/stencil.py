"""Stencil-form operator for structured-topology meshes.

Port of `krylov_spdes_tpu/ops/stencil.py`. Every mesh from `get_mesh`
(jittered ones included) has structured topology: each node's neighbours sit
at fixed grid offsets, so A is a 9-point stencil with spatially varying
values,

    y[i,j] = Σ_o P_o[i,j] · x[i+di_o, j+dj_o]        o ∈ 9 offsets.

Dirichlet rows carry an identity diagonal, so solves run on full-grid
vectors with the same Krylov iterates as the eliminated free-dof system.
The apply is kernel A on the card (ops/stencil_kernel.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.bc import DirichletMaps
from .sparse import SparseOp
from .stencil_kernel import OFFSETS, stencil_spmv

__all__ = ["OFFSETS", "StencilOp", "stencil_matvec", "stencil_matvec_batched",
           "build_stencil_op", "to_full_vector", "to_free_vector"]


@dataclasses.dataclass
class StencilOp:
    """9-plane stencil operator over an (H, W) node grid.

    planes:   (9, H, W) stiffness values per offset
    dir_diag: (H, W) additive identity on Dirichlet rows
    slot:     (nnz,) flattened plane index of each CSR value (refill map)
    """
    planes: torch.Tensor
    dir_diag: torch.Tensor
    slot: torch.Tensor
    H: int
    W: int

    @property
    def n(self) -> int:
        return self.H * self.W

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return stencil_matvec(self, x)

    def __call__(self, x):
        return stencil_matvec(self, x)

    def with_csr_data(self, data: torch.Tensor) -> "StencilOp":
        """Refill from a new CSR value vector (fixed sparsity): one scatter."""
        flat = data.new_zeros(9 * self.H * self.W)
        flat[self.slot] = data
        return dataclasses.replace(self, planes=flat.reshape(9, self.H, self.W))

    def diagonal(self):
        return (self.planes[0] + self.dir_diag).reshape(-1)


def stencil_matvec(S: StencilOp, x: torch.Tensor) -> torch.Tensor:
    """y = A x on full-grid vectors: kernel A on the card, its plain version
    on the CPU."""
    return stencil_spmv(S.planes, S.dir_diag, x)


def build_stencil_op(A: SparseOp, maps: DirichletMaps, grid_shape) -> StencilOp:
    """Host-side symbolic construction from the assembled free-dof CSR
    operator. Raises if the mesh topology is not structured (an offset falls
    outside the 9-point set)."""
    H, W = grid_shape
    rows_g = maps.free_l2g[A.rows.cpu().numpy()].astype(np.int64)
    cols_g = maps.free_l2g[A.indices.cpu().numpy()].astype(np.int64)
    di = cols_g // W - rows_g // W
    dj = cols_g % W - rows_g % W
    off_id = -np.ones(rows_g.shape[0], dtype=np.int64)
    for k, (oi, oj) in enumerate(OFFSETS):
        off_id[(di == oi) & (dj == oj)] = k
    if (off_id < 0).any():
        raise ValueError("mesh topology is not a 9-point structured grid")
    slot = off_id * H * W + rows_g

    dir_diag = np.zeros((H, W))
    dg = maps.dir_l2g
    dir_diag[dg // W, dg % W] = 1.0

    data = A.data
    op = StencilOp(planes=data.new_zeros((9, H, W)),
                   dir_diag=torch.as_tensor(dir_diag, dtype=data.dtype,
                                            device=data.device),
                   slot=torch.as_tensor(slot, device=data.device),
                   H=H, W=W)
    return op.with_csr_data(data)


def to_full_vector(maps: DirichletMaps, b_free: torch.Tensor, n_full: int):
    """Lift a free-dof vector to the full grid (zeros on Dirichlet)."""
    out = b_free.new_zeros(n_full)
    out[torch.as_tensor(maps.free_l2g, dtype=torch.int64,
                        device=b_free.device)] = b_free
    return out


def to_free_vector(maps: DirichletMaps, x_full: torch.Tensor):
    return x_full[torch.as_tensor(maps.free_l2g, dtype=torch.int64,
                                  device=x_full.device)]


def stencil_matvec_batched(planes, dir_diag, x):
    """Batched y = A_b x_b over a leading chain axis, in plain torch ops (as
    the JAX package leaves it to XLA): the batch axis rides along, so the
    per-iteration launch latency is shared by the chains.

    planes: (B, 9, H, W) per-chain stiffness planes; dir_diag (H, W) shared;
    x (B, H·W). Same sum order as the unbatched apply."""
    B = x.shape[0]
    H, W = dir_diag.shape
    x2 = x.reshape(B, H, W)
    xp = F.pad(x2, (1, 1, 1, 1))
    y = (planes[:, 0] + dir_diag[None]) * x2
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        y = y + planes[:, k] * xp[:, 1 + di:1 + di + H, 1 + dj:1 + dj + W]
    return y.reshape(B, -1)
