"""Recycler state holder.

Port of `krylov_spdes_tpu/solvers/recycler_state.py` (reference:
RecyclingKrylovSolvers/Recyclers.jl:3-12, a bare W-holder stub): it also
tracks the basis's health and the sample index, which is what the chain
drivers need (Example09's rank guard and retry bookkeeping).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import resolve
from .base import check_w_rank


@dataclasses.dataclass
class Recycler:
    W: torch.Tensor           # (n, nvec) deflation basis
    sample_idx: int = 0
    healthy: bool = True

    @property
    def nvec(self) -> int:
        return self.W.shape[1]

    def update(self, W_new, frac: float = 0.9) -> "Recycler":
        """Adopt a refreshed basis; flags degeneration like the reference's
        rank(W) < 0.9 nvec chain guard."""
        return Recycler(W=W_new, sample_idx=self.sample_idx + 1,
                        healthy=check_w_rank(W_new, frac))


def prepare_recycler(n: int, nvec: int, dtype=None, device=None) -> Recycler:
    device, dtype = resolve(device, dtype)
    return Recycler(W=torch.zeros((n, nvec), dtype=dtype, device=device))
