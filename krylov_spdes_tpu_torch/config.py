"""Global configuration of the PyTorch port.

Mirrors `krylov_spdes_tpu/config.py`: the reference hard-codes its
tolerances as module constants (RecyclingKrylovSolvers.jl:21 `const eps =
1e-7`, cg.jl:33-35); here they live in one config object. The port adds its
default device and dtype: entry points run on the card unless the caller
passes another device, and the card computes in float32 (parity tests pass
float64 on the CPU explicitly).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    # Outer Krylov relative tolerance: ||r|| <= rtol * ||b||
    # (reference: RecyclingKrylovSolvers.jl:21)
    rtol: float = 1e-7
    # Inner CG tolerance used inside matrix-free Schur applies
    # (reference: EllipticPdeDomainDecomposition.jl:634)
    schur_inner_rtol: float = 1e-9
    # Inner CG tolerance used when preparing Neumann-Neumann pseudo-inverses
    # (reference: EllipticPdeDomainDecomposition.jl:1168)
    nn_prep_rtol: float = 1e-15
    # Device and floating dtype of the port's tensors when a caller gives none.
    device: str = "cuda"
    dtype: torch.dtype = torch.float32
    # Integer dtype for index tensors (torch indexing wants int64).
    itype: torch.dtype = torch.int64


config = Config()


def resolve(device=None, dtype=None):
    """(device, dtype) with the config defaults filled in."""
    return (torch.device(config.device if device is None else device),
            config.dtype if dtype is None else dtype)
