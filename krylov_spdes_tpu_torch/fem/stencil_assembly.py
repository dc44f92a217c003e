"""Dense, gather/scatter-free per-realization assembly for stencil operators.

Port of `krylov_spdes_tpu/fem/stencil_assembly.py`. On structured-topology
meshes the map coefficient -> stiffness values is itself a local stencil
computation:

  coeff planes (H, W)
    -> element-mean planes (2, H-1, W-1)        3-point averages
    -> stiffness planes (9, H, W)               <=22 multiply-adds with
                                                precomputed geometry-factor
                                                planes
    -> Dirichlet-lift RHS correction planes     same machinery

Everything is elementwise on 2D planes: no indices. The result equals the
scatter path's (same sums, reordered). Reference: `update_isotropic_elliptic_
assembly!` (Fem/EllipticPde.jl:291-350) on the structured topology.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve
from ..ops.stencil import OFFSETS, StencilOp
from .bc import DirichletMaps
from .mesh import element_geometry


@dataclasses.dataclass
class StencilAssemblyPlan:
    """factors:  (n_terms, H, W) geometry-factor planes; term k contributes
                 factors[k] * coeffE[t_k] shifted by (dci_k, dcj_k) into
                 stiffness plane o_k.
    bfactors: (n_bterms, H, W) factor planes for the Dirichlet-lift RHS.
    b_fixed:  (H, W) fixed source term on the grid (zeros on Dirichlet).
    dir_diag: (H, W) identity diagonal on Dirichlet rows.
    free_mask:(H, W) 1.0 on free nodes.
    terms:    tuple of (plane_id, tri_type, dci, dcj)
    bterms:   tuple of (tri_type, dci, dcj)
    """
    factors: torch.Tensor
    bfactors: torch.Tensor
    b_fixed: torch.Tensor
    dir_diag: torch.Tensor
    free_mask: torch.Tensor
    H: int
    W: int
    terms: tuple
    bterms: tuple


def prepare_stencil_assembly(mesh, maps: DirichletMaps, f, u_exact,
                             dtype=None, device=None) -> StencilAssemblyPlan:
    """Host-side: route every element stiffness contribution into
    (offset-plane, element-relative-position) factor planes."""
    device, dtype = resolve(device, dtype)
    cells, points = mesh.cells, mesh.points
    nnode = mesh.nnode
    H = W = int(round(np.sqrt(nnode)))
    if H * W != nnode:
        raise ValueError("stencil assembly needs the structured grid")
    m = H - 1
    nel = cells.shape[0]
    dx, dy, area = element_geometry(cells, points)
    kg = (dy[:, :, None] * dy[:, None, :] + dx[:, :, None] * dx[:, None, :]) \
        / (4.0 * area[:, None, None])        # (nel, 3, 3)

    # element grid coordinates: elements come in pairs per cell, row-major
    eci = (np.arange(nel) // 2) // m
    ecj = (np.arange(nel) // 2) % m
    et = np.arange(nel) % 2                  # triangle type within cell

    is_dir = maps.is_dirichlet
    pi_all, pj_all = cells // W, cells % W

    # for each (a, b) local pair, bucket contributions by (offset-plane,
    # triangle type, element-relative position): at most ~72 distinct keys,
    # each handled with one np.add.at
    fac = {}
    bfac = {}
    for a in range(3):
        for bnd in range(3):
            gi = cells[:, a]
            gj = cells[:, bnd]
            kij = kg[:, a, bnd]
            pi, pj = pi_all[:, a], pj_all[:, a]
            qi, qj = pi_all[:, bnd], pj_all[:, bnd]
            oi, oj = qi - pi, qj - pj
            o_id = np.full(nel, -1, dtype=np.int64)
            for k, (dx_, dy_) in enumerate(OFFSETS):
                o_id[(oi == dx_) & (oj == dy_)] = k
            dci = eci - pi
            dcj = ecj - pj
            i_dir = is_dir[gi]
            j_dir = is_dir[gj]
            both_free = (~i_dir) & (~j_dir)
            lift = i_dir & (~j_dir)

            key_code = (((o_id * 2 + et) * 3 + (dci + 1)) * 3 + (dcj + 1))
            for code in np.unique(key_code[both_free]):
                sel = both_free & (key_code == code)
                o_k = int(code // 18)
                t_k = int((code // 9) % 2)
                dci_k = int((code // 3) % 3) - 1
                dcj_k = int(code % 3) - 1
                P = fac.setdefault((o_k, t_k, dci_k, dcj_k), np.zeros((H, W)))
                np.add.at(P, (pi[sel], pj[sel]), kij[sel])

            if lift.any():
                ue = u_exact(points[gi, 0], points[gi, 1])
                bkey = ((et * 3 + (eci - qi + 1)) * 3 + (ecj - qj + 1))
                for code in np.unique(bkey[lift]):
                    sel = lift & (bkey == code)
                    t_k = int(code // 9)
                    dci_k = int((code // 3) % 3) - 1
                    dcj_k = int(code % 3) - 1
                    P = bfac.setdefault((t_k, dci_k, dcj_k), np.zeros((H, W)))
                    np.add.at(P, (qi[sel], qj[sel]), -ue[sel] * kij[sel])

    terms = tuple(sorted(fac))
    bterms = tuple(sorted(bfac))
    factors = np.stack([fac[k] for k in terms]) if terms else np.zeros((0, H, W))
    bfactors = (np.stack([bfac[k] for k in bterms]) if bterms
                else np.zeros((0, H, W)))

    # fixed source term on the grid
    fvals = f(points[:, 0], points[:, 1])[cells]
    fsum = fvals.sum(axis=1, keepdims=True)
    contrib = (fvals + fsum) * area[:, None] / 12.0
    b_fixed = np.zeros(nnode)
    sel = ~is_dir[cells]
    np.add.at(b_fixed, cells[sel], contrib[sel])

    dir_diag = np.zeros((H, W))
    dg = maps.dir_l2g
    dir_diag[dg // W, dg % W] = 1.0

    val = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return StencilAssemblyPlan(
        factors=val(factors), bfactors=val(bfactors),
        b_fixed=val(b_fixed.reshape(H, W)), dir_diag=val(dir_diag),
        free_mask=val(1.0 - dir_diag), H=H, W=W, terms=terms, bterms=bterms)


def _coeff_element_planes(plan: StencilAssemblyPlan, coeff: torch.Tensor):
    """Element-mean coefficient planes (2, m, m) from nodal coeff (H, W).
    Union-jack triangulation (mesh.py get_mesh): cell (ci, cj) has nodes
    p00=(ci,cj), p10=(ci,cj+1), p01=(ci+1,cj), p11=(ci+1,cj+1);
    even cells: t0 = (p00, p10, p11), t1 = (p00, p11, p01);
    odd  cells: t0 = (p00, p10, p01), t1 = (p10, p11, p01)."""
    H, W = plan.H, plan.W
    c2 = coeff.reshape(H, W)
    c00 = c2[:-1, :-1]
    c01 = c2[:-1, 1:]
    c10 = c2[1:, :-1]
    c11 = c2[1:, 1:]
    m = H - 1
    ar = torch.arange(m, device=coeff.device)
    even = (ar[:, None] + ar[None, :]) % 2 == 0
    t0 = torch.where(even, c00 + c01 + c11, c00 + c01 + c10) / 3.0
    t1 = torch.where(even, c00 + c11 + c10, c01 + c11 + c10) / 3.0
    return torch.stack([t0, t1])


def stencil_assemble(plan: StencilAssemblyPlan, coeff: torch.Tensor):
    """coeff (nnode,) -> (planes (9,H,W), b (nnode,)), fully dense."""
    H, W = plan.H, plan.W
    ce = _coeff_element_planes(plan, coeff)      # (2, m, m)
    cep = F.pad(ce, (1, 1, 1, 1))                # (2, H+1, W+1)

    # dci, dcj are in {-1, 0} (a node is the top-left or another corner of
    # its element), so every window below lies inside cep
    planes = [coeff.new_zeros((H, W)) for _ in range(9)]
    for k, (o, t, dci, dcj) in enumerate(plan.terms):
        shifted = cep[t, 1 + dci:1 + dci + H, 1 + dcj:1 + dcj + W]
        planes[o] = planes[o] + plan.factors[k] * shifted

    b = plan.b_fixed
    for k, (t, dci, dcj) in enumerate(plan.bterms):
        shifted = cep[t, 1 + dci:1 + dci + H, 1 + dcj:1 + dcj + W]
        b = b + plan.bfactors[k] * shifted
    return torch.stack(planes), b.reshape(-1)


def make_stencil_operator(plan: StencilAssemblyPlan, coeff):
    """One-call realization update: coefficient field -> (operator, b)."""
    coeff = torch.as_tensor(coeff, dtype=plan.factors.dtype,
                            device=plan.factors.device)
    planes, b = stencil_assemble(plan, coeff)
    op = StencilOp(planes=planes, dir_diag=plan.dir_diag,
                   slot=torch.zeros(0, dtype=torch.int64, device=coeff.device),
                   H=plan.H, W=plan.W)
    return op, b
