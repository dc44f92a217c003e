"""Single-domain Karhunen-Loève eigenproblem, dense.

Port of `krylov_spdes_tpu/kl/single.py` (reference:
Fem/KarhunenLoeve.jl:27-193):

- The reference assembles the Galerkin covariance operator
  C[i,j] = ∫∫ φi cov φj in two O(nnode²·nel) node×element scalar passes
  (KarhunenLoeve.jl:33-107). With P1 elements and the reference's
  (2,1,1)/12 quadrature each pass is exactly a consistent-mass-matrix
  product, so C = M Ĉ M where Ĉ[i,j] = cov(x_i, x_j): a dense broadcasted
  covariance and two sparse×dense products.
- The generalized eigenproblem C ψ = λ M ψ (reference: `Arpack.eigs(C, M)`,
  KarhunenLoeve.jl:138) becomes a Cholesky reduction + dense `eigh`.
- Truncation keeps dominant positive eigenpairs until the captured energy
  reaches `relative · Area · cov(center, center)` (KarhunenLoeve.jl:150-176),
  then M-renormalizes the modes (KarhunenLoeve.jl:183-185).

Besides the dense path, `method="lobpcg"` runs LOBPCG (kl/lobpcg.py) on the
dense operator and `method="chunked"` runs it on a row-chunked matrix-free
Ĉ apply (`make_chunked_cov_apply`) that never forms the n×n kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve
from ..fem.mesh import element_geometry
from ..ops.sparse import SparseOp, ell_spmv
from .covariance import cov_matrix
from .lobpcg import lobpcg_generalized


def make_chunked_cov_apply(cov, points, dtype, chunk: int = 2048,
                           device=None):
    """Matrix-free Y ↦ Ĉ Y (Ĉ[i,j] = cov(x_i, x_j)) in row chunks: the n×n
    kernel is never formed, so the single-domain KL scales past the dense
    path's memory wall (O(chunk·n) live memory). Each step forms one
    (chunk, n) covariance tile and multiplies it into Y."""
    device, dtype = resolve(device, dtype)
    pts = torch.as_tensor(np.asarray(points), dtype=dtype, device=device)
    n = pts.shape[0]

    def apply(Y):
        Y2 = Y if Y.ndim == 2 else Y[:, None]
        out = torch.cat([cov(pts[s:s + chunk, None, :], pts[None, :, :]) @ Y2
                         for s in range(0, n, chunk)])
        return out if Y.ndim == 2 else out[:, 0]

    return apply


def mass_covariance_operator(M: SparseOp, points, cov) -> torch.Tensor:
    """Dense C = M Ĉ M with Ĉ[i,j] = cov(x_i, x_j).

    Equal (in exact arithmetic) to `do_mass_covariance_assembly`
    (KarhunenLoeve.jl:27-107), since the reference's quadrature rule is the
    consistent P1 mass matrix applied to nodal covariance samples."""
    pts = torch.as_tensor(points, dtype=M.data.dtype, device=M.data.device)
    Chat = cov_matrix(cov, pts, pts)             # (nnode, nnode) dense
    R = ell_spmv(M, Chat)                        # M @ Ĉ
    return ell_spmv(M, R.T.contiguous())         # M @ (M Ĉ)ᵀ = Cᵀ = C


def _generalized_eigh(C: torch.Tensor, Md: torch.Tensor):
    """Solve C ψ = λ M ψ for all pairs, descending λ. Returns (λ, ψ)."""
    L = torch.linalg.cholesky(Md)
    # B = L⁻¹ C L⁻ᵀ
    Y = torch.linalg.solve_triangular(L, C, upper=False)
    B = torch.linalg.solve_triangular(L, Y.T, upper=False)
    w, V = torch.linalg.eigh(B)
    w = w.flip(0)
    V = V.flip(1)
    psi = torch.linalg.solve_triangular(L.T, V, upper=True)
    return w, psi


def solve_kl(cells, points, cov, nev: int, M: SparseOp,
             relative: float = 0.99, verbose: bool = False,
             method: str = "auto", lobpcg_iters: int = 60,
             generator: torch.Generator | None = None, X0=None):
    """KL eigenpairs with energy-ratio truncation (KarhunenLoeve.jl:123-193).

    Returns (Λ: (nvec,), Ψ: (nnode, nvec)) as numpy, M-normalized,
    nvec <= nev chosen by the reference's truncation rule.

    method: "dense" (Cholesky+eigh, O(n³)), "lobpcg" (O(n²·nev) an
    iteration on the dense operator), "chunked" (LOBPCG with the
    matrix-free row-chunked Ĉ apply, O(chunk·n) memory), or "auto", which
    resolves as in the JAX package: "chunked" above 20k nodes, "lobpcg"
    above 1500 nodes when nev < n/8, else "dense". LOBPCG's start block
    (n, nev + 8) is X0 when given, else drawn from `generator`."""
    n = M.n_rows
    if method == "auto":
        if n > 20_000:
            method = "chunked"
        else:
            method = "lobpcg" if (n > 1500 and nev < n // 8) else "dense"
    dtype, device = M.data.dtype, M.data.device
    if method in ("lobpcg", "chunked"):
        Mfn = M.matvec
        if method == "chunked":
            chat = make_chunked_cov_apply(cov, points, dtype, device=device)

            def Cfn(X):
                return Mfn(chat(Mfn(X)))
        else:
            C = mass_covariance_operator(M, points, cov)

            def Cfn(X):
                return C @ X
        w, psi = lobpcg_generalized(Cfn, Mfn, n, nev, iters=lobpcg_iters,
                                    generator=generator, X0=X0, dtype=dtype,
                                    device=device)
    elif method == "dense":
        C = mass_covariance_operator(M, points, cov)
        w, psi = _generalized_eigh(C, M.todense())
        w, psi = w[:nev], psi[:, :nev]
    else:
        raise ValueError(f"unknown method {method!r}")
    w = w.cpu().numpy()

    # Energy target: relative · Area · cov(center, center), where center is
    # the mean of element centroids (KarhunenLoeve.jl:141-168).
    cells, points = np.asarray(cells), np.asarray(points)
    _, _, area = element_geometry(cells, points)
    total_area = float(area.sum())
    center = points[cells].mean(axis=1).mean(axis=0)
    c_pt = torch.as_tensor(center, dtype=dtype, device=device)[None, :]
    var0 = float(cov(c_pt, c_pt)[0])
    energy_expected = relative * total_area * var0

    energy = 0.0
    nvec = 0
    for lam in w:
        if lam <= 0:
            break
        nvec += 1
        energy += float(lam)
        if energy >= energy_expected:
            break

    lam = w[:nvec]
    psi = psi[:, :nvec]
    # M-renormalize (KarhunenLoeve.jl:183-185)
    Mpsi = ell_spmv(M, psi.contiguous())
    psi = psi / torch.sqrt(torch.sum(psi * Mpsi, dim=0))
    if verbose:
        print(f"{nvec}/{nev} vectors kept for "
              f"{energy / energy_expected * relative:.5f} relative energy")
    return lam, psi.cpu().numpy()

