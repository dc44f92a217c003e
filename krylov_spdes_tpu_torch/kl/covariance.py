"""Covariance models (vectorized; reference Fem/Covariances.jl:23-28).

Port of `krylov_spdes_tpu/kl/covariance.py`. The reference implements only
the squared-exponential model; its README also names "Exp" as a valid model
(KarhunenLoeveDomainDecompositionHelper.jl:54), so both are provided.
"""

from __future__ import annotations

import torch


def cov_sexp(p1, p2, sig2: float = 1.0, L: float = 0.1):
    """Squared-exponential: sig2 * exp(-(dx^2+dy^2)/L^2).

    p1: (..., 2), p2: (..., 2) broadcastable point tensors.
    NOTE the reference uses distance^2 / L^2 (not 2L^2): matched exactly.
    """
    d2 = torch.sum((p1 - p2) ** 2, dim=-1)
    return sig2 * torch.exp(-d2 / L ** 2)


def cov_exp(p1, p2, sig2: float = 1.0, L: float = 0.1):
    """Exponential: sig2 * exp(-sqrt(dx^2+dy^2)/L)."""
    d2 = torch.sum((p1 - p2) ** 2, dim=-1)
    return sig2 * torch.exp(-torch.sqrt(d2) / L)


def make_cov(name: str, sig2: float = 1.0, L: float = 0.1):
    """Factory keyed by the reference's model names ("SExp", "Exp")."""
    name = name.lower()
    if name == "sexp":
        return lambda p1, p2: cov_sexp(p1, p2, sig2, L)
    if name == "exp":
        return lambda p1, p2: cov_exp(p1, p2, sig2, L)
    raise ValueError(f"unknown covariance model {name!r}")


def cov_matrix(cov, pts1, pts2):
    """Dense cross-covariance matrix between two point sets: (n1, n2)."""
    return cov(pts1[:, None, :], pts2[None, :, :])
