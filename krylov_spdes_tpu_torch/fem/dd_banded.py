"""RCM-banded block-tridiagonal subdomain interiors: the DD path for
unstructured meshes.

Port of `krylov_spdes_tpu/fem/dd_banded.py` (the reference's counterpart is
the per-subdomain CHOLMOD factorization,
EllipticPdeDomainDecomposition.jl:1518-1537). The general DD pipeline
(fem/dd.py + fem/schur.py) factors each padded interior densely: an
(ndom, nI, nI) Cholesky, O(ndom·nI²) factor storage. Here:

- host: reverse Cuthill-McKee over each subdomain's interior adjacency
  (scipy.csgraph), one shared block size m = max_d bandwidth_d, so the
  (nb, m, m) block grid is the same for every subdomain (pad slots and the
  nb·m − nI tail are identity rows, inert under the factorization);
- device: the interior batch permuted into banded order and sliced into
  block-tridiagonal (D, E) (`_banded_blocks_from_dense`), or refilled
  straight into (D, E) with no dense interior at all
  (`assemble_dd_values_banded`), then factored by the port's
  `fem/schur.py::bt_factor_batched` and solved by `bt_interior_solve`.

Factor storage drops from O(nI²) to O(nI·m) a subdomain. The operator
(`SchurOperatorBandedInt`) has the call surface of `SchurOperator`, so
`schur_matvec`, `get_schur_rhs`, the Neumann-Neumann preconditioner and
`solvers/refine.py::refined_dd_pcg` take it unchanged; its sums into Γ go
through `gamma_sum` in a fixed order, and the direct refill's scatters
through `OrderedScatter`, so an apply and a refill repeat bit for bit.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..solvers.base import f32_exact
from .dd import DDAssemblyPlan, DDPartition, OrderedScatter, refill_rest
from .schur import (_partition_tables, bt_factor_batched, bt_interior_solve,
                    gamma_gather_table, schur_matvec)


@dataclasses.dataclass
class BandedInteriorTables:
    """Host-built per-partition tables (constant across realizations)."""
    perm: np.ndarray     # (ndom, nI) banded position -> original local slot
    iperm: np.ndarray    # (ndom, nI) original local slot -> banded position
    nb: int              # number of (m, m) blocks per interior
    m: int               # shared block size (>= max per-dom RCM bandwidth)
    bw: np.ndarray       # (ndom,) per-dom bandwidths (diagnostics)


def prepare_banded_interiors(cells, part: DDPartition,
                             plan: DDAssemblyPlan,
                             block: int | None = None
                             ) -> BandedInteriorTables:
    """Per-subdomain RCM over the interior node adjacency.

    Pad slots (imask == 0) come after the RCM-ordered valid slots, so the
    permuted interior matrix is [banded | identity] and the shared (nb, m)
    block grid covers every subdomain."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    cells = np.asarray(cells)
    nnode = int(part.node_owner.shape[0])
    # global symmetric node adjacency from the triangulation
    r = np.concatenate([cells[:, 0], cells[:, 1], cells[:, 2],
                        cells[:, 1], cells[:, 2], cells[:, 0]])
    c = np.concatenate([cells[:, 1], cells[:, 2], cells[:, 0],
                        cells[:, 0], cells[:, 1], cells[:, 2]])
    adj = sp.csr_matrix((np.ones_like(r, dtype=np.int8), (r, c)),
                        shape=(nnode, nnode))

    ndom, nI = part.interior_l2g.shape
    perm = np.zeros((ndom, nI), dtype=np.int32)
    bw = np.zeros(ndom, dtype=np.int64)
    for d in range(ndom):
        valid = np.flatnonzero(part.interior_l2g[d] >= 0)
        nodes = part.interior_l2g[d, valid]
        sub = adj[nodes][:, nodes]
        p = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=True))
        coo = sub[p][:, p].tocoo()
        bw[d] = int(np.abs(coo.row - coo.col).max()) if coo.nnz else 1
        pads = np.setdiff1d(np.arange(nI), valid, assume_unique=False)
        perm[d] = np.concatenate([valid[p], pads])
    if block is not None and block < int(bw.max()):
        # a block narrower than the RCM bandwidth would drop out-of-band
        # entries when slicing D/E (a wrong factorization)
        raise ValueError(
            f"block={block} < max RCM bandwidth {int(bw.max())}; the "
            f"block-tridiagonal factorization needs block >= bandwidth")
    m = int(block or max(int(bw.max()), 1))
    nb = -(-nI // m)
    iperm = np.zeros_like(perm)
    np.put_along_axis(iperm, perm, np.arange(nI, dtype=np.int32)[None, :],
                      axis=1)
    return BandedInteriorTables(perm=perm, iperm=iperm, nb=nb, m=m, bw=bw)


@dataclasses.dataclass
class SchurOperatorBandedInt:
    """Schur operator with RCM-banded block-tridiagonal interior factors.
    Same call surface as SchurOperator (fem/schur.py): an interior solve
    permutes into banded order, runs the batched block solve and permutes
    back (two (ndom, nI) gathers an apply)."""
    Linv: torch.Tensor            # (ndom, nb, m, m)
    G: torch.Tensor               # (ndom, nb, m, m)
    perm: torch.Tensor            # (ndom, nI)
    iperm: torch.Tensor           # (ndom, nI)
    A_IG: torch.Tensor
    A_GGd: torch.Tensor
    gammad_to_gamma: torch.Tensor
    gmask: torch.Tensor
    gamma_cnt: torch.Tensor
    n_gamma: int
    nI: int
    gamma_gather: torch.Tensor | None = None   # see gamma_gather_table
    psum: Callable | None = None               # as in SchurOperator
    doms: slice | None = None

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
        """A_II⁻¹ rhs for rhs (ndom, nI) or (ndom, nI, k)."""
        squeeze = rhs.ndim == self.perm.ndim
        if squeeze:
            rhs = rhs[..., None]
        npad = self.Linv.shape[-3] * self.Linv.shape[-1]
        rp = torch.take_along_dim(rhs, self.perm[..., None], dim=-2)
        rp = F.pad(rp, (0, 0, 0, npad - self.nI))
        x = bt_interior_solve(self.Linv, self.G, rp)[..., :self.nI, :]
        x = torch.take_along_dim(x, self.iperm[..., None], dim=-2)
        return x[..., 0] if squeeze else x

    @property
    def shape(self):
        return (self.n_gamma, self.n_gamma)


@f32_exact
def _banded_blocks_from_dense(A_II, imask, perm, nb: int, m: int):
    """Permute the masked dense interior batch into banded order and slice
    the block-tridiagonal (D, E). Pad slots and tail rows become identity."""
    ndom, nI, _ = A_II.shape
    Am = A_II * imask[:, :, None] * imask[:, None, :]
    Am.diagonal(dim1=-2, dim2=-1).add_(1.0 - imask)
    Ap = torch.take_along_dim(Am, perm[:, :, None], dim=1)
    Ap = torch.take_along_dim(Ap, perm[:, None, :], dim=2)
    pad = nb * m - nI
    Ap = F.pad(Ap, (0, pad, 0, pad))
    Ap.diagonal(dim1=-2, dim2=-1)[:, nI:] = 1.0
    Apb = Ap.reshape(ndom, nb, m, nb, m)
    D = Apb.diagonal(0, 1, 3).permute(0, 3, 1, 2)
    E = F.pad(Apb.diagonal(1, 1, 3).permute(0, 3, 1, 2), (0, 0, 0, 0, 0, 1))
    return D.contiguous(), E.contiguous()


def _operator(plan: DDAssemblyPlan, part: DDPartition, D, E, A_IG, A_GGd,
              tables: BandedInteriorTables) -> SchurOperatorBandedInt:
    Linv, G = bt_factor_batched(D, E)
    t = _partition_tables(part, D)
    idx = lambda a: torch.as_tensor(a.astype(np.int64),  # noqa: E731
                                    device=D.device)
    return SchurOperatorBandedInt(
        Linv=Linv, G=G, perm=idx(tables.perm), iperm=idx(tables.iperm),
        A_IG=A_IG * plan.imask[:, :, None] * plan.gmask[:, None, :],
        A_GGd=A_GGd * plan.gmask[:, :, None] * plan.gmask[:, None, :],
        gammad_to_gamma=t["g2g"], gmask=plan.gmask, gamma_cnt=t["cnt"],
        n_gamma=part.n_gamma, nI=int(part.interior_l2g.shape[1]),
        gamma_gather=t["gather"])


def prepare_schur_operator_banded(plan: DDAssemblyPlan, part: DDPartition,
                                  A_II, A_IG, A_GGd,
                                  tables: BandedInteriorTables
                                  ) -> SchurOperatorBandedInt:
    """Banded-interior counterpart of fem/schur.py::prepare_schur_operator:
    the same masking, a block-tridiagonal factorization in place of the
    dense (ndom, nI, nI) Cholesky."""
    perm = torch.as_tensor(tables.perm.astype(np.int64), device=A_II.device)
    D, E = _banded_blocks_from_dense(A_II, plan.imask, perm, tables.nb,
                                     tables.m)
    return _operator(plan, part, D, E, A_IG, A_GGd, tables)


@dataclasses.dataclass
class BandedRefillPlan:
    """Host-built routing of the direct banded-interior refill: element
    contributions land straight in the block-tridiagonal (D, E) layout, and
    the dense (ndom, nI, nI) A_II never exists (peak memory O(ndom·nI·m)
    for the interiors). `scatters` holds the fixed-order form of the two
    scatter-adds, derived from the fields."""
    idx_D: torch.Tensor     # flat scatter targets into D (ndom, nb, m, m)
    idx_E: torch.Tensor     # flat scatter targets into E
    sel_D: torch.Tensor     # positions into the plan's ii segment
    sel_E: torch.Tensor
    D_base: torch.Tensor    # (ndom, nb, m, m) identity at pad/tail slots
    nb: int
    m: int
    scatters: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        size = self.D_base.numel()
        self.scatters = {"D": OrderedScatter.of(self.idx_D, size),
                         "E": OrderedScatter.of(self.idx_E, size)}


def prepare_banded_dd_refill(plan: DDAssemblyPlan, part: DDPartition,
                             tables: BandedInteriorTables
                             ) -> BandedRefillPlan:
    """Re-route the ii segment of the DD scatter plan ((tgt_dom,
    tgt_loc)[:n_ii] encodes (d, li, lj)) through the RCM permutation into
    block-tridiagonal coordinates. An entry at banded positions (p_i, p_j)
    with |p_i − p_j| ≤ bandwidth ≤ m lies in block (bi, bj) with
    bj − bi ∈ {−1, 0, +1}; the symmetric scatter carries both (i, j) and
    (j, i), so D keeps the bi == bj entries and E the bj == bi + 1 ones,
    and the subdiagonal duplicates are dropped (bt_factor_batched assumes
    symmetry)."""
    nI = plan.nI
    m, nb = tables.m, tables.nb
    ndom = plan.ndom
    d = plan.tgt_dom[:plan.n_ii].cpu().numpy().astype(np.int64)
    loc = plan.tgt_loc[:plan.n_ii].cpu().numpy().astype(np.int64)
    li = loc // nI
    lj = loc % nI
    p_i = tables.iperm[d, li].astype(np.int64)
    p_j = tables.iperm[d, lj].astype(np.int64)
    bi, ri = np.divmod(p_i, m)
    bj, rj = np.divmod(p_j, m)
    on_D = bi == bj
    on_E = bj == bi + 1
    stray = ~(on_D | on_E | (bj == bi - 1))
    if stray.any():
        raise AssertionError(
            f"{int(stray.sum())} contributions fall outside the "
            "block-tridiagonal band — RCM bandwidth exceeded m")
    flat = d * (nb * m * m) + bi * (m * m) + ri * m + rj
    sel_D = np.flatnonzero(on_D)
    sel_E = np.flatnonzero(on_E)

    # identity rows for pad slots (perm positions >= n_interior_d) and the
    # nb·m − nI tail, the inert rows of the dense path
    D_base = np.zeros((ndom, nb, m, m))
    n_int = np.asarray(part.n_interior)
    for dd in range(ndom):
        p = np.arange(int(n_int[dd]), nb * m)
        D_base[dd, p // m, p % m, p % m] = 1.0
    dev = plan.kflat.device
    idx = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)  # noqa: E731
    return BandedRefillPlan(
        idx_D=idx(flat[sel_D]), idx_E=idx(flat[sel_E]), sel_D=idx(sel_D),
        sel_E=idx(sel_E),
        D_base=torch.as_tensor(D_base, dtype=plan.kflat.dtype, device=dev),
        nb=nb, m=m)


def assemble_dd_values_banded(plan: DDAssemblyPlan, bplan: BandedRefillPlan,
                              coeff_nodes):
    """Per-realization DD refill without the dense interior batch: returns
    (D, E, A_IG, A_GGd, b_I, b_G), (D, E) the block-tridiagonal interior
    bands in RCM order, ready for bt_factor_batched. Peak memory
    O(ndom·(nI·m + nI·nG + nG²)) against assemble_dd_values'
    O(ndom·nI²)."""
    shape = bplan.D_base.shape
    coeff_e = torch.mean(coeff_nodes[plan.cells], dim=-1)
    vals_ii = coeff_e[plan.eflat[:plan.n_ii]] * plan.kflat[:plan.n_ii]
    D = bplan.D_base + bplan.scatters["D"].sum(
        vals_ii[bplan.sel_D]).reshape(shape)
    E = bplan.scatters["E"].sum(vals_ii[bplan.sel_E]).reshape(shape)
    return (D, E) + refill_rest(plan, coeff_e)


def prepare_schur_operator_banded_refill(
        plan: DDAssemblyPlan, part: DDPartition, D, E, A_IG, A_GGd,
        tables: BandedInteriorTables) -> SchurOperatorBandedInt:
    """Factor directly from the banded refill's (D, E): the whole path from
    assembly to operator with no dense interior anywhere."""
    return _operator(plan, part, D, E, A_IG, A_GGd, tables)
