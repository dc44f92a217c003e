"""KL field synthesis and latent-coordinate recovery.

Port of `krylov_spdes_tpu/kl/synthesis.py` (reference:
Fem/KarhunenLoeveDomainDecomposition.jl:985-1163). The reference loops BLAS
axpys per mode (:1040-1045); here synthesis is one matvec g = Ψ(√Λ ⊙ ξ).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import SparseOp, ell_spmv


def draw(lam, psi, gen: torch.Generator):
    """ξ ~ N(0, I), g = Ψ(√Λ ξ). Returns (ξ, g)
    (KarhunenLoeveDomainDecomposition.jl:985-1000). `gen` is a generator on
    the device of psi."""
    xi = torch.randn(lam.shape[0], generator=gen, dtype=psi.dtype,
                     device=psi.device)
    return xi, set_field(lam, psi, xi)


def set_field(lam, psi, xi):
    """g = Σ_α √λ_α ξ_α ψ_α (reference `set!`, :1135-1163)."""
    return psi @ (torch.sqrt(lam) * xi)


def trim_and_order(lam, phi):
    """Drop negative eigenvalues and sort most→least dominant (:1070-1096).
    The reference receives eigenpairs ascending (LAPACK order) and reverses.
    Host-side, on numpy arrays."""
    lam = np.asarray(lam)
    phi = np.asarray(phi)
    keep = lam > 0
    lam, phi = lam[keep], phi[:, keep]
    order = np.argsort(lam)[::-1]
    return lam[order], phi[:, order]


def get_kl_coordinates(g, lam, phi, M: SparseOp):
    """Latent recovery ξ = Φᵀ M g / √Λ (:1109-1146): checks the
    M-orthonormality of the KL basis end to end."""
    return (phi.T @ ell_spmv(M, g)) / torch.sqrt(lam)
