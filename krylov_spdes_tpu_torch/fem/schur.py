"""Schur-complement operators over batched subdomain blocks.

Port of `krylov_spdes_tpu/fem/schur.py` (reference:
Fem/EllipticPdeDomainDecomposition.jl:585-1108 and the Neumann-Neumann
preconditioner, :1111-1403):

- Interiors are batched dense Cholesky factors (padded with identity rows),
  so S x = A_ΓΓ x − Σ_d A_IΓdᵀ A_IId⁻¹ A_IΓd x is three batched products and
  one batched triangular solve pair: exact, no inner tolerance.
- Assembled local Schurs Sd = A_ΓΓd − A_IΓᵀ A_II⁻¹ A_IΓ are ONE batched
  solve on matrix right-hand sides.
- The NN preconditioner's pinv of the singular local Schurs (:1181,
  rtol = √eps) is a batched masked eigendecomposition pinv.

Every function takes its blocks with any number of leading batch axes
((ndom, ...) for one realization, (B, ndom, ...) for a batch of chains):
the JAX package vmaps, here the axis is written out.

The sum over subdomains into Γ has a fixed order. The JAX package ends each
apply in a scatter-add (`.at[g2g].add`), which on a CUDA tensor would be
`index_add_` with float atomics: up to four subdomains add into one Γ node,
in an order that changes from run to run, and this is the operator a
recycled solver applies every iteration and harvests its basis from. Here
`gamma_sum` gathers each Γ node's (subdomain, slot) entries through a
precomputed (n_gamma, max multiplicity) table and sums them along the last
axis, so an apply repeats bit for bit.

TF32 stays off in every function (`f32_exact`): at reduced precision the
Schur blocks carry ~1e-3 relative error and float32 solves stall at maxit.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..solvers.base import f32_exact
from .dd import DDAssemblyPlan, DDPartition, assemble_dd_values


def gamma_gather_table(g2g: torch.Tensor, gmask: torch.Tensor,
                       n_gamma: int) -> torch.Tensor:
    """(n_gamma, max multiplicity) table of flat (dom·nG + slot) indices of
    the valid local slots that map to each Γ node, in ascending order;
    missing entries point at ndom·nG, one past the end, where `gamma_sum`
    keeps a zero. Built once a plan, on the host."""
    flat_g = g2g.reshape(-1).cpu().numpy()
    valid = gmask.reshape(-1).cpu().numpy() > 0
    src = np.nonzero(valid)[0]
    tgt = flat_g[src]
    order = np.argsort(tgt, kind="stable")
    src, tgt = src[order], tgt[order]
    cnt = np.bincount(tgt, minlength=n_gamma)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    table = np.full((n_gamma, max(1, int(cnt.max()) if cnt.size else 1)),
                    flat_g.shape[0], dtype=np.int64)
    table[tgt, np.arange(src.shape[0]) - start[tgt]] = src
    return torch.as_tensor(table, device=g2g.device)


def gamma_sum(table: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Σ_d scatter_d of the local values vals (..., ndom, nG) into Γ
    (..., n_gamma), in the table's fixed order."""
    flat = F.pad(vals.reshape(*vals.shape[:-2], -1), (0, 1))
    return flat[..., table].sum(dim=-1)


def _mv(Mat, v):
    """(..., i, j) · (..., j) -> (..., i)."""
    return (Mat @ v[..., None])[..., 0]


def _mtv(Mat, v):
    """(..., i, j)ᵀ · (..., i) -> (..., j)."""
    return (Mat.transpose(-1, -2) @ v[..., None])[..., 0]


@dataclasses.dataclass
class SchurOperator:
    """Matrix-free S with factored interiors."""
    A_II_L: torch.Tensor          # (ndom, nI, nI) Cholesky factors
    A_IG: torch.Tensor            # (ndom, nI, nG)
    A_GGd: torch.Tensor           # (ndom, nG, nG)
    gammad_to_gamma: torch.Tensor  # (ndom, nG) Γ index per local slot (0 pad)
    gmask: torch.Tensor           # (ndom, nG) 1.0 valid
    gamma_cnt: torch.Tensor       # (n_gamma,)
    n_gamma: int
    gamma_gather: torch.Tensor | None = None   # see gamma_gather_table

    def __post_init__(self):
        if self.gamma_gather is None:
            self.gamma_gather = gamma_gather_table(
                self.gammad_to_gamma, self.gmask, self.n_gamma)

    def matvec(self, x):
        return schur_matvec(self, x)

    def __call__(self, x):
        return schur_matvec(self, x)

    def as_partial_op(self):
        return partial(schur_matvec, self)

    def interior_apply_inv(self, rhs):
        return interior_solve(self.A_II_L, rhs)

    @property
    def shape(self):
        return (self.n_gamma, self.n_gamma)


@dataclasses.dataclass
class SchurOperatorBT:
    """Schur operator whose subdomain interiors are factored BLOCK-
    TRIDIAGONALLY (grid-ordered interiors of structured-mesh tiles,
    fem/dd_stencil.py): the dense (nI, nI) interior matrix and its O(nI³)
    Cholesky never exist; the factors are 2·hM blocks of (wM, wM) per dom.
    Same call surface as SchurOperator."""
    Linv: torch.Tensor            # (ndom, hM, wM, wM) inverted diag factors
    G: torch.Tensor               # (ndom, hM, wM, wM) coupling factors
    A_IG: torch.Tensor            # (ndom, nI, nG)
    A_GGd: torch.Tensor           # (ndom, nG, nG)
    gammad_to_gamma: torch.Tensor
    gmask: torch.Tensor
    gamma_cnt: torch.Tensor
    n_gamma: int
    gamma_gather: torch.Tensor | None = None

    __post_init__ = SchurOperator.__post_init__
    matvec = SchurOperator.matvec
    __call__ = SchurOperator.__call__
    as_partial_op = SchurOperator.as_partial_op
    shape = SchurOperator.shape

    def interior_apply_inv(self, rhs):
        return bt_interior_solve(self.Linv, self.G, rhs)


def _cholesky_nan(A):
    """Batched lower Cholesky factor that, like the JAX package's, fails
    with NaNs (which the solvers report as `SolveResult.failed`) rather than
    by raising: `torch.linalg.cholesky` reads `info` back on the host, one
    synchronise a call; `cholesky_ex` does not, and `info` never leaves the
    device."""
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill((info > 0)[..., None, None], float("nan"))


@f32_exact
def bt_factor_batched(D, E):
    """Batched block-tridiagonal Cholesky over the dom axis: D, E
    (..., nb, m, m) -> (Linv, G) with Linv[..., i] = L_i⁻¹. The JAX
    package's `lax.scan` over the nb grid rows is a host loop of nb batched
    dense (m, m) steps here."""
    nb, m = D.shape[-3], D.shape[-1]
    eye = torch.eye(m, dtype=D.dtype, device=D.device).expand(
        *D.shape[:-3], m, m)
    Linv, G = torch.empty_like(D), torch.empty_like(E)
    C = torch.zeros_like(D[..., 0, :, :])
    for i in range(nb):
        L = _cholesky_nan(D[..., i, :, :] - C)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        Gi = Li @ E[..., i, :, :]
        Linv[..., i, :, :] = Li
        G[..., i, :, :] = Gi
        C = Gi.transpose(-1, -2) @ Gi
    return Linv, G


@f32_exact
def bt_interior_solve(Linv, G, rhs):
    """x = A_II⁻¹ rhs through the batched block factors; rhs (..., nI) or
    (..., nI, k) with nI = nb·m grid-ordered and the leading axes of Linv."""
    squeeze = rhs.ndim == Linv.ndim - 2
    if squeeze:
        rhs = rhs[..., None]
    nb, m = Linv.shape[-3], Linv.shape[-1]
    lead, k = rhs.shape[:-2], rhs.shape[-1]
    b = rhs.reshape(*lead, nb, m, k)
    y = torch.empty_like(b)
    prev = None
    for i in range(nb):                      # forward sweep
        t = b[..., i, :, :]
        if i:
            t = t - G[..., i - 1, :, :].transpose(-1, -2) @ prev
        prev = Linv[..., i, :, :] @ t
        y[..., i, :, :] = prev
    x = torch.empty_like(b)
    nxt = None
    for i in reversed(range(nb)):            # backward sweep
        t = y[..., i, :, :]
        if i < nb - 1:
            t = t - G[..., i, :, :] @ nxt
        nxt = Linv[..., i, :, :].transpose(-1, -2) @ t
        x[..., i, :, :] = nxt
    x = x.reshape(*lead, nb * m, k)
    return x[..., 0] if squeeze else x


@f32_exact
def factorize_interiors(A_II, imask):
    """Batched Cholesky of padded interiors; padding rows become identity.

    The JAX package's `donate=` (hand the A_II buffer to the factorization)
    has gone: it exists there to cap XLA's transient copies, and eager
    PyTorch makes one masked copy and one factor whatever the caller does
    with A_II afterwards."""
    A = A_II * imask[..., :, None] * imask[..., None, :]
    A.diagonal(dim1=-2, dim2=-1).add_(1.0 - imask)
    return _cholesky_nan(A)


@f32_exact
def interior_solve(L, rhs):
    """Batched A_II⁻¹ rhs via the Cholesky factors; rhs (..., nI) or
    (..., nI, k) with the leading axes of L."""
    if rhs.ndim == L.ndim - 1:
        return torch.cholesky_solve(rhs[..., None], L)[..., 0]
    return torch.cholesky_solve(rhs, L)


def _partition_tables(part: DDPartition, like: torch.Tensor) -> dict:
    """The partition's Γ tables as tensors on the device of `like`, made
    once a partition, device and dtype."""
    cache = part.__dict__.setdefault("_tables", {})
    key = (str(like.device), like.dtype)
    if key not in cache:
        g2g = torch.as_tensor(
            np.maximum(part.gammad_to_gamma, 0).astype(np.int64),
            device=like.device)
        gmask = torch.as_tensor(part.gammad_to_gamma >= 0, device=like.device)
        cache[key] = dict(
            g2g=g2g, gather=gamma_gather_table(g2g, gmask, part.n_gamma),
            cnt=torch.as_tensor(part.gamma_cnt, device=like.device
                                ).to(like.dtype))
    return cache[key]


def prepare_schur_operator(plan: DDAssemblyPlan, part: DDPartition, A_II,
                           A_IG, A_GGd) -> SchurOperator:
    t = _partition_tables(part, A_II)
    return SchurOperator(
        A_II_L=factorize_interiors(A_II, plan.imask),
        A_IG=A_IG * plan.imask[:, :, None] * plan.gmask[:, None, :],
        A_GGd=A_GGd * plan.gmask[:, :, None] * plan.gmask[:, None, :],
        gammad_to_gamma=t["g2g"], gmask=plan.gmask, gamma_cnt=t["cnt"],
        n_gamma=part.n_gamma, gamma_gather=t["gather"])


@f32_exact
def schur_matvec(S, x):
    """S x = Σ_d scatter_d( A_ΓΓd x_d − A_IΓdᵀ A_IId⁻¹ A_IΓd x_d )."""
    xd = x[..., S.gammad_to_gamma] * S.gmask                # (ndom, nG)
    t1 = _mv(S.A_GGd, xd)
    w = S.interior_apply_inv(_mv(S.A_IG, xd))               # A_II⁻¹ A_IΓ x_d
    t2 = _mtv(S.A_IG, w)
    return gamma_sum(S.gamma_gather, (t1 - t2) * S.gmask)


@f32_exact
def get_schur_rhs(S, b_I, b_G):
    """b_schur = b_Γ − Σ_d scatter_d(A_IΓdᵀ A_IId⁻¹ b_Id)  (reference :835)."""
    w = _mtv(S.A_IG, S.interior_apply_inv(b_I)) * S.gmask
    return b_G - gamma_sum(S.gamma_gather, w)


@f32_exact
def assemble_local_schurs(S):
    """Explicit Sd = A_ΓΓd − A_IΓᵀ A_IId⁻¹ A_IΓ, batched dense (reference
    :667-695 applies the map to identity columns with inner CGs)."""
    Wm = S.interior_apply_inv(S.A_IG)                       # (ndom, nI, nG)
    Sd = S.A_GGd - S.A_IG.transpose(-1, -2) @ Wm
    return Sd * S.gmask[..., :, None] * S.gmask[..., None, :]


@f32_exact
def _schur_matvec_assembled(Sd, g2g, gmask, gather, x):
    """The assembled apply, x (n_gamma,) with Sd (ndom, nG, nG), or a batch
    x (B, n_gamma) with Sd (B, ndom, nG, nG)."""
    xd = x[..., g2g] * gmask
    return gamma_sum(gather, _mv(Sd, xd) * gmask)


def assembled_schur_operator(S, Sd=None):
    """Linear-operator callable applying the pre-assembled Sd blocks
    (apply_local_schurs assembled flavor, reference :761). One batched
    (ndom, nG, nG) product per matvec and no per-iteration interior solves,
    which is why the chain solvers ride this path."""
    if Sd is None:
        Sd = assemble_local_schurs(S)
    return partial(_schur_matvec_assembled, Sd, S.gammad_to_gamma, S.gmask,
                   S.gamma_gather)


@f32_exact
def get_subdomain_solutions(S, u_gamma, b_I):
    """u_Id = A_IId⁻¹ (b_Id − A_IΓd u_Γ|_d)  (reference :1014)."""
    ud = u_gamma[..., S.gammad_to_gamma] * S.gmask
    return S.interior_apply_inv(b_I - _mv(S.A_IG, ud))


def merge_subdomain_solutions(part: DDPartition, maps, points, u_exact,
                              u_gamma, u_I):
    """Global nodal solution (numpy) from (u_Γ, u_Id) + Dirichlet values
    (reference :1040)."""
    to_np = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)  # noqa: E731
                       else np.asarray(a))
    nnode = part.node_owner.shape[0]
    u = np.zeros(nnode)
    u[part.gamma_l2g] = to_np(u_gamma)
    # pad slots may interleave (grid-ordered layouts): route by validity mask
    valid = part.interior_l2g >= 0
    u[part.interior_l2g[valid]] = to_np(u_I)[valid]
    dl = maps.dir_l2g
    u[dl] = u_exact(points[dl, 0], points[dl, 1])
    return u


def do_condensed_assembly(plan: DDAssemblyPlan, part: DDPartition,
                          coeff_nodes, assembled: bool = True):
    """One-call Schur condensation for a coefficient realization: refill the
    DD blocks, factorize interiors, condense the RHS, and return
    (operator, b_schur, S, b_I): `do_condensed_isotropic_elliptic_assembly`
    (reference :887-1010). With assembled=True the local Schur matrices are
    formed explicitly (the reference's Example07 default)."""
    coeff = torch.as_tensor(coeff_nodes, dtype=plan.kflat.dtype,
                            device=plan.kflat.device)
    A_II, A_IG, A_GGd, b_I, b_G = assemble_dd_values(plan, coeff)
    S = prepare_schur_operator(plan, part, A_II, A_IG, A_GGd)
    b_s = get_schur_rhs(S, b_I, b_G)
    op = assembled_schur_operator(S) if assembled else S
    return op, b_s, S, b_I


# ---------------------------------------------------------------------------
# Neumann-Neumann preconditioner (reference :1111-1403)
# ---------------------------------------------------------------------------

@f32_exact
def _masked_pinv(Sd, gmask, return_kept: bool = False):
    """Batched pseudo-inverse with rtol = √eps·σmax (reference :1181).

    The local Schur complements are symmetric PSD, so the pinv runs on a
    batched eigendecomposition (σ = |λ|). The eigenvectors differ from
    another LAPACK's in sign and by rotations inside clusters; the pinv
    does not. `return_kept` also gives the number of eigenvalues kept per
    block (the null space of a floating subdomain is the constants: one
    dropped, beside the zero rows of the pad slots)."""
    lam, Q = torch.linalg.eigh(Sd)
    eps = torch.finfo(Sd.dtype).eps
    tol = eps ** 0.5 * lam.abs().amax(dim=-1, keepdim=True)
    keep = lam > tol
    linv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
    P = (Q * linv[..., None, :]) @ Q.transpose(-1, -2)
    P = P * gmask[..., :, None] * gmask[..., None, :]
    return (P, keep.sum(dim=-1)) if return_kept else P


@f32_exact
def _nn_apply(PiSd, g2g, gmask, gather, cnt_inv, r):
    """Multiplicity-weighted local pinv applies, r (n_gamma,) or, with
    PiSd (B, ndom, nG, nG), a batch r (B, n_gamma)."""
    rd = (r * cnt_inv)[..., g2g] * gmask
    return gamma_sum(gather, _mv(PiSd, rd) * gmask) * cnt_inv


def prepare_neumann_neumann_schur_precond(S, Sd=None):
    """Batched pinv of the (singular) local Schur complements; apply =
    multiplicity-weighted scatter → ΠSd product → weighted gather
    (reference :1361-1383). Pass precomputed local Schur blocks via ``Sd``
    to share the condensation with the assembled operator."""
    if Sd is None:
        Sd = assemble_local_schurs(S)
    PiSd = _masked_pinv(Sd, S.gmask)
    return partial(_nn_apply, PiSd, S.gammad_to_gamma, S.gmask,
                   S.gamma_gather, 1.0 / S.gamma_cnt)
