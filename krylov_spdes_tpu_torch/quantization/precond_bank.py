"""Quantized, interpolating and truncated preconditioner strategies.

Port of `krylov_spdes_tpu/quantization/precond_bank.py` (reference):

- centroidal bank (Example12_Quantization_Functions.jl:86-167,
  Example20..._Functions.jl:96-147): one constant preconditioner per Voronoi
  centroid; each sampled system is solved with the nearest centroid's;
- Shepard inverse-distance interpolation (Example14..._Functions.jl:18-327):
  M⁻¹r = Σ_i c_i Π_i⁻¹ r with c_i ∝ 1/d_i², d_i the (Λ-weighted or CDF)
  distance from the sample to interpolation point i;
- truncated-KL preconditioners (Example19_TruncatedPreconditioners.jl:70-114):
  the preconditioner of the field synthesized from the first k KL modes.

Every function works on the port's `kl/synthesis.set_field` and takes any
port preconditioner factory (`get_cholesky32`, `get_banded_cholesky`,
`amg_precond`, ...); the bank is a list of their applies.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..kl.synthesis import set_field


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_centroidal_preconds(centroids_xi, lam, psi, assemble_fn,
                              precond_factory):
    """One preconditioner per centroid (get_centroidal_preconds analogue).

    lam, psi: the KL basis as tensors; assemble_fn(coeff_nodes) -> operator
    (a SparseOp, say); precond_factory(A) -> apply. Returns the list of
    preconditioners."""
    bank = []
    for p in range(centroids_xi.shape[0]):
        xi = torch.as_tensor(centroids_xi[p], dtype=psi.dtype,
                             device=psi.device)
        A = assemble_fn(torch.exp(set_field(lam, psi, xi)))
        bank.append(precond_factory(A))
    return bank


def select_nearest(bank, xi, centroids_xi, lam):
    """Nearest-centroid preconditioner (test_solver_with_centroidal_preconds,
    Example12:146-160), chosen on the host. Returns (M, index, distance)."""
    w = np.sqrt(_host(lam))
    d2 = np.sum(((_host(centroids_xi) - _host(xi)[None, :]) * w[None, :])
                ** 2, axis=1)
    p = int(np.argmin(d2))
    return bank[p], p, float(np.sqrt(d2[p]))


def _shepard_apply(preconds, coeffs, r):
    out = coeffs[0] * preconds[0](r)
    for c, M in zip(coeffs[1:], preconds[1:]):
        out = out + c * M(r)
    return out


def shepard_interpolating_precond(xi, interpolators_xi, bank, lam,
                                  distance: str = "L2-full"):
    """Inverse-distance-squared Shepard combination
    (shepard_interpolating_precond, Example14..._Functions.jl:174-210).
    The reference weighs Δξ by Λ, not √Λ, here; so does this port."""
    xi, pts, lam = _host(xi), _host(interpolators_xi), _host(lam)
    if distance == "L2-full":
        d = np.sqrt(np.sum(((pts - xi[None, :]) * lam[None, :]) ** 2, axis=1))
    elif distance in ("cdf", "cdf-full"):
        from scipy.stats import norm
        d = np.sqrt(np.sum(norm.cdf(pts - xi[None, :]) ** 2, axis=1))
    else:
        raise ValueError(distance)
    w = 1.0 / np.maximum(d, 1e-300) ** 2
    coeffs = w / w.sum()
    return partial(_shepard_apply, tuple(bank),
                   tuple(float(c) for c in coeffs))


def truncated_kl_precond(lam, psi, k: int, assemble_fn, precond_factory,
                         xi=None):
    """Preconditioner from the first k KL modes (Example19:70-114): the field
    synthesized from modes [0, k) of xi (zeros when None), the tail set to
    zero, the median beyond mode k."""
    if xi is None:
        xi = torch.zeros(lam.shape[0], dtype=psi.dtype, device=psi.device)
    xi_t = torch.as_tensor(xi, dtype=psi.dtype, device=psi.device).clone()
    xi_t[k:] = 0.0
    g = set_field(lam, psi, xi_t)
    return precond_factory(assemble_fn(torch.exp(g)))
