"""P1 FEM assembly with fixed symbolic structure and on-device value refill.

Port of `krylov_spdes_tpu/fem/assembly.py` (reference: Fem/EllipticPde.jl:
60-466). Every mesh-dependent quantity (geometry factors, scatter slots,
Dirichlet RHS corrections, fixed source term) is computed once on the host
into an `AssemblyPlan`; the per-realization refill is a gather, an
elementwise product and two segment sums over contributions sorted by
their target. The segment sums add each target's contributions one by one
in that order (as the JAX package's sorted `segment_sum` does), with no
atomics, so the assembled values repeat bit for bit from run to run on
the card.

Weak form: A[i,j] = ∫ a ∇φi·∇φj, with a interpolated at nodes and averaged
per element (EllipticPde.jl:209-214); b[i] = ∫ f φi via the exact P1 rule
(2f_i + f_j + f_k)·Area/12 plus the Dirichlet lift -u_exact(x_i)·K_ij
(EllipticPde.jl:249-251).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve
from ..ops.sparse import SparseOp, build_sparse_op
from .bc import DirichletMaps
from .mesh import element_geometry


@dataclasses.dataclass
class AssemblyPlan:
    """Precomputed scatter plan for stiffness + RHS assembly on free dofs.

    cells:        (nel, 3)    node ids
    kgeo:         (n_a,)      geometry factor of each kept A-contribution,
                              sorted by canonical nnz slot
    count_a:      (nnz,)      number of A-contributions per nnz slot
    perm_a:       (n_a,)      element id of each A-contribution (post-sort)
    b_fixed:      (n_free,)   source term ∫ f φi (mesh-fixed)
    bcorr_factor: (n_bc,)     -u_exact(x_i) * kgeo for Dirichlet-lift entries,
                              sorted by free dof
    count_b:      (n_free,)   number of lift entries per free dof
    elem_of_contrib: (n_bc,)  element id of each lift entry
    (The JAX package stores the sorted slots, slot_a and bcorr_slot; the
    counts are the same information in the form a segment sum takes.)
    """
    cells: torch.Tensor
    kgeo: torch.Tensor
    count_a: torch.Tensor
    perm_a: torch.Tensor
    b_fixed: torch.Tensor
    bcorr_factor: torch.Tensor
    count_b: torch.Tensor
    elem_of_contrib: torch.Tensor
    n_free: int
    nnz: int
    n_bcorr: int


@dataclasses.dataclass
class EllipticAssembly:
    """Bundle of the symbolic operator and its refill plan."""
    op: SparseOp          # stiffness on free dofs, CSR/ELL symbolic structure
    plan: AssemblyPlan
    maps: DirichletMaps


def prepare_elliptic_assembly(cells: np.ndarray, points: np.ndarray,
                              maps: DirichletMaps, f, u_exact,
                              dtype=None, device=None) -> EllipticAssembly:
    """Host-side symbolic setup. f, u_exact: vectorized (x, y) -> value."""
    device, dtype = resolve(device, dtype)
    nel = cells.shape[0]
    dx, dy, area = element_geometry(cells, points)

    # Local geometry factors: K_ij^e = (dy_i dy_j + dx_i dx_j) / (4 area_e).
    kg = (dy[:, :, None] * dy[:, None, :] + dx[:, :, None] * dx[:, None, :]) \
        / (4.0 * area[:, None, None])                       # (nel, 3, 3)

    gi = cells[:, :, None].repeat(3, axis=2)                # global row node
    gj = cells[:, None, :].repeat(3, axis=1)                # global col node
    free_i = maps.free_g2l[gi]                              # (nel,3,3), -1 if dir
    free_j = maps.free_g2l[gj]
    both_free = (free_i >= 0) & (free_j >= 0)
    lift = (free_i < 0) & (free_j >= 0)                     # i Dirichlet, j free
    eids = np.broadcast_to(np.arange(nel)[:, None, None], gi.shape)

    # --- A contributions (both free) -------------------------------------
    op, slot = build_sparse_op(free_i[both_free], free_j[both_free],
                               maps.n_free, maps.n_free, dtype=dtype,
                               device=device)
    order = np.argsort(slot, kind="stable")
    slot_a = slot[order]
    kg_a = kg[both_free][order]
    e_a = eids[both_free][order]

    # --- Dirichlet lift: b[fj] -= u_exact(x_i, y_i) * coeff_e * kgeo ------
    gi_l = gi[lift]
    fj_l = free_j[lift]
    u_dir = u_exact(points[gi_l, 0], points[gi_l, 1])
    bfac = -u_dir * kg[lift]
    order_b = np.argsort(fj_l, kind="stable")
    fj_l, bfac, e_l = fj_l[order_b], bfac[order_b], eids[lift][order_b]

    # --- fixed source term: b[fi] += (2 f_i + f_j + f_k) * area/12 --------
    fvals = f(points[:, 0], points[:, 1])[cells]            # (nel, 3)
    fsum = fvals.sum(axis=1, keepdims=True)
    contrib = (fvals + fsum) * area[:, None] / 12.0         # 2f_i+f_j+f_k
    b_fixed = np.zeros(maps.n_free, dtype=np.float64)
    fi_all = maps.free_g2l[cells]
    sel = fi_all >= 0
    np.add.at(b_fixed, fi_all[sel], contrib[sel])

    idx = lambda a: torch.as_tensor(a.astype(np.int64), device=device)  # noqa: E731
    val = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    plan = AssemblyPlan(
        cells=idx(cells), kgeo=val(kg_a),
        count_a=idx(np.bincount(slot_a, minlength=op.nnz)),
        perm_a=idx(e_a), b_fixed=val(b_fixed), bcorr_factor=val(bfac),
        count_b=idx(np.bincount(fj_l, minlength=maps.n_free)),
        elem_of_contrib=idx(e_l),
        n_free=maps.n_free, nnz=op.nnz, n_bcorr=int(fj_l.shape[0]))
    return EllipticAssembly(op=op, plan=plan, maps=maps)


def assemble_values(plan: AssemblyPlan, coeff_nodes: torch.Tensor):
    """Per-realization refill: nodal coefficient -> (A values, b), the
    on-device analogue of `update_isotropic_elliptic_assembly!`
    (EllipticPde.jl:291-350): same fixed sparsity, only values rewritten."""
    coeff_e = torch.mean(coeff_nodes[plan.cells], dim=1)    # (nel,)
    vals = coeff_e[plan.perm_a] * plan.kgeo
    a_data = torch.segment_reduce(vals, "sum", lengths=plan.count_a,
                                  unsafe=True)
    bvals = coeff_e[plan.elem_of_contrib] * plan.bcorr_factor
    b = plan.b_fixed + torch.segment_reduce(bvals, "sum",
                                            lengths=plan.count_b, unsafe=True)
    return a_data, b


def do_isotropic_elliptic_assembly(asm: EllipticAssembly, coeff_nodes):
    """Full assembly returning (A: SparseOp, b). coeff_nodes is the coefficient
    at ALL mesh nodes (the reference's Vector overload, EllipticPde.jl:176)."""
    data = asm.op.data
    coeff = torch.as_tensor(coeff_nodes, dtype=data.dtype, device=data.device)
    a_data, b = assemble_values(asm.plan, coeff)
    return asm.op.with_data(a_data), b


def get_mass_matrix(cells: np.ndarray, points: np.ndarray, dtype=None,
                    device=None) -> SparseOp:
    """Consistent P1 mass matrix over ALL nodes (Fem/EllipticPde.jl:412-466):
    M_ij^e = area/6 if i==j else area/12."""
    device, dtype = resolve(device, dtype)
    nnode = int(cells.max()) + 1
    _, _, area = element_geometry(cells, points)
    local = (np.ones((3, 3)) + np.eye(3)) / 12.0            # 1/6 diag, 1/12 off
    vals = area[:, None, None] * local                      # (nel,3,3)
    gi = cells[:, :, None].repeat(3, axis=2)
    gj = cells[:, None, :].repeat(3, axis=1)
    op, slot = build_sparse_op(gi.ravel(), gj.ravel(), nnode, nnode,
                               dtype=dtype, device=device)
    data = np.zeros(op.nnz)
    np.add.at(data, slot, vals.ravel())
    return op.with_data(torch.as_tensor(data, dtype=dtype, device=device))
