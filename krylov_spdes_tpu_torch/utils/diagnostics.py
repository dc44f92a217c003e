"""Spectral diagnostics: preconditioned spectra and condition numbers.

Port of `krylov_spdes_tpu/utils/diagnostics.py` (reference: the
`save_spectra`/`save_conditioning` paths of
Example06_PcgStochasticEllipticPde.jl:185-241). The dense Π⁻¹A is one block
apply of A and then of M to the identity (`solvers/base.py::apply_block`),
and the condition estimate is Lanczos on the preconditioned operator in the
A-inner product (the ArnoldiMethod replacement).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve
from ..solvers.base import apply_block, as_linear_op, as_precond_op


def preconditioned_spectrum(A, M=None, n: int | None = None, device=None,
                            dtype=None):
    """Full spectrum of M⁻¹A (dense; study-sized problems). M⁻¹A is similar
    to M^{-1/2}AM^{-1/2}, so its eigenvalues are real. Returns them
    ascending, on the host. A and M must take an (n, n) block."""
    device, dtype = resolve(device, dtype)
    Afn, Mfn = as_linear_op(A), as_precond_op(M)
    if n is None:
        n = A.shape[0]
    eye = torch.eye(n, dtype=dtype, device=device)
    cols = apply_block(Mfn, apply_block(Afn, eye))
    w = np.linalg.eigvals(cols.cpu().numpy())
    return np.sort(w.real)


def condition_estimate(A, M=None, n: int | None = None, iters: int = 60,
                       generator=None, v0=None, device=None, dtype=None):
    """(λmin, λmax, κ) of M⁻¹A by Lanczos (Example06's LD/MD estimates).

    B = M⁻¹A is self-adjoint in the A-inner product ⟨u,v⟩_A = uᵀAv, so
    standard Lanczos runs there: α = (Av)ᵀM⁻¹(Av), β = √(wᵀAw). The start
    vector is `v0`, or standard normal from `generator` (a generator seeded
    0 on `device` when None)."""
    device, dtype = resolve(device, dtype)
    Afn, Mfn = as_linear_op(A), as_precond_op(M)
    if n is None:
        n = A.shape[0]
    iters = min(iters, n - 1)
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        v0 = torch.randn(n, generator=generator, dtype=dtype, device=device)
    v = torch.as_tensor(v0, dtype=dtype, device=device)
    v = v / torch.sqrt(torch.dot(v, Afn(v)))
    tiny = torch.finfo(dtype).tiny
    w_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas, betas = [], []
    for _ in range(iters):
        Av = Afn(v)
        Bv = Mfn(Av)
        alpha = torch.dot(Av, Bv)
        w = Bv - alpha * v - beta * w_prev
        beta_new = torch.sqrt(torch.abs(torch.dot(w, Afn(w))))
        alphas.append(alpha)
        betas.append(beta_new)
        w_prev = v
        v = w / torch.clamp_min(beta_new, tiny)
        beta = beta_new
    a = torch.stack(alphas).cpu().numpy().astype(np.float64)
    b = torch.stack(betas).cpu().numpy().astype(np.float64)
    T = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
    w = np.linalg.eigvalsh(T)
    lmin, lmax = float(w[0]), float(w[-1])
    return lmin, lmax, lmax / max(lmin, 1e-300)
