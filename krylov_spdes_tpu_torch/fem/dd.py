"""Non-overlapping domain decomposition: index structures + batched block
assembly.

Port of `krylov_spdes_tpu/fem/dd.py` (reference:
Fem/EllipticPdeDomainDecomposition.jl:86-582):

- `set_subdomains` (reference :86-193) builds Dict-based index maps; here
  `DDPartition` holds dense padded integer arrays on the host: per-subdomain
  interior/interface node tables padded to (ndom, nI_max) / (ndom, nG_max)
  with masks. The "dom" axis is the batch axis of every block on the device.
- Interface detection is NODE-based (a non-Dirichlet node touching elements
  of >= 2 subdomains is on Γ) rather than the reference's edge-based rule
  (:148-173): a strict superset that can never orphan a node.
- `prepare_local_schurs` / `prepare_global_schur` (:212-582) become ONE
  precomputed routing plan whose per-realization refill writes batched DENSE
  blocks A_II (ndom, nI, nI), A_IΓ (ndom, nI, nG), A_ΓΓd (ndom, nG, nG) on
  the device.

The refill sums in a fixed order. `index_add_` on a CUDA tensor adds with
float atomics, whose order (and so the last bits of the blocks) changes from
run to run; here every scatter-add is an `OrderedScatter`: the contributions
are sorted by target once, on the plan, and each realization sums them with
`torch.segment_reduce` and writes each distinct target once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve
from .bc import DirichletMaps
from .mesh import element_geometry


@dataclasses.dataclass
class DDPartition:
    """Dense index structures for an ndom-way edge/node partition (host)."""
    ndom: int
    n_gamma: int                # number of (non-Dirichlet) interface nodes
    nI_max: int
    nG_max: int
    node_owner: np.ndarray      # (nnode,) -2 Dirichlet, -1 Γ, d interior
    gamma_l2g: np.ndarray       # (n_gamma,) global node of each Γ index
    gamma_g2l: np.ndarray       # (nnode,) Γ index or -1
    interior_l2g: np.ndarray    # (ndom, nI_max) global node, padded -1
    interior_g2l: np.ndarray    # (nnode,) local interior index or -1
    n_interior: np.ndarray      # (ndom,)
    gammad_to_gamma: np.ndarray  # (ndom, nG_max) Γ index of local Γd slot, pad -1
    gamma_to_gammad: np.ndarray  # (ndom, n_gamma) local Γd slot or -1
    n_gammad: np.ndarray        # (ndom,)
    gamma_cnt: np.ndarray       # (n_gamma,) number of owning subdomains


def set_subdomains(cells: np.ndarray, epart: np.ndarray,
                   maps: DirichletMaps, ndom: int | None = None) -> DDPartition:
    """Build DD index structures (reference set_subdomains analogue)."""
    nnode = maps.free_g2l.shape[0]
    if ndom is None:
        ndom = int(epart.max()) + 1
    if ndom < 2:
        raise ValueError("domain decomposition needs ndom >= 2 "
                         "(a single subdomain has no interface)")
    is_dir = maps.is_dirichlet

    # parts touching each node
    tmat = np.zeros((ndom, nnode), dtype=bool)
    tmat[epart.repeat(3), cells.ravel()] = True
    ntouch = tmat.sum(axis=0)

    node_owner = np.full(nnode, -3, dtype=np.int32)
    node_owner[is_dir] = -2
    on_gamma = (~is_dir) & (ntouch >= 2)
    node_owner[on_gamma] = -1
    interior = (~is_dir) & (ntouch == 1)
    # owner of interior node = the single touching part
    owner_of = tmat.argmax(axis=0)
    node_owner[interior] = owner_of[interior]

    gamma_l2g = np.nonzero(on_gamma)[0].astype(np.int32)
    n_gamma = gamma_l2g.shape[0]
    gamma_g2l = -np.ones(nnode, dtype=np.int32)
    gamma_g2l[gamma_l2g] = np.arange(n_gamma, dtype=np.int32)

    n_interior = np.zeros(ndom, dtype=np.int64)
    interior_lists = []
    for d in range(ndom):
        nodes = np.nonzero(interior & (owner_of == d))[0]
        interior_lists.append(nodes)
        n_interior[d] = nodes.shape[0]
    nI_max = max(1, int(n_interior.max()))
    interior_l2g = -np.ones((ndom, nI_max), dtype=np.int32)
    interior_g2l = -np.ones(nnode, dtype=np.int32)
    for d, nodes in enumerate(interior_lists):
        interior_l2g[d, :len(nodes)] = nodes
        interior_g2l[nodes] = np.arange(len(nodes), dtype=np.int32)

    # local interfaces: Γ nodes touching part d
    n_gammad = np.zeros(ndom, dtype=np.int64)
    gd_lists = []
    for d in range(ndom):
        nodes = np.nonzero(on_gamma & tmat[d])[0]
        gd_lists.append(gamma_g2l[nodes])
        n_gammad[d] = nodes.shape[0]
    nG_max = max(1, int(n_gammad.max()))
    gammad_to_gamma = -np.ones((ndom, nG_max), dtype=np.int32)
    gamma_to_gammad = -np.ones((ndom, n_gamma), dtype=np.int32)
    for d, gl in enumerate(gd_lists):
        gammad_to_gamma[d, :len(gl)] = gl
        gamma_to_gammad[d, gl] = np.arange(len(gl), dtype=np.int32)

    gamma_cnt = tmat[:, gamma_l2g].sum(axis=0).astype(np.int32)

    return DDPartition(
        ndom=ndom, n_gamma=n_gamma, nI_max=nI_max, nG_max=nG_max,
        node_owner=node_owner, gamma_l2g=gamma_l2g, gamma_g2l=gamma_g2l,
        interior_l2g=interior_l2g, interior_g2l=interior_g2l,
        n_interior=n_interior, gammad_to_gamma=gammad_to_gamma,
        gamma_to_gammad=gamma_to_gammad, n_gammad=n_gammad,
        gamma_cnt=gamma_cnt)


@dataclasses.dataclass
class OrderedScatter:
    """A scatter-add into `size` slots with a fixed order of summation.

    perm:    (n,) the contributions stably sorted by target slot
    lengths: (n_slots,) contributions of each distinct target
    slots:   (n_slots,) the distinct targets, ascending
    """
    perm: torch.Tensor
    lengths: torch.Tensor
    slots: torch.Tensor
    size: int

    @classmethod
    def of(cls, index: torch.Tensor, size: int) -> "OrderedScatter":
        perm = torch.argsort(index, stable=True)
        slots, lengths = torch.unique_consecutive(index[perm],
                                                  return_counts=True)
        return cls(perm=perm, lengths=lengths, slots=slots, size=int(size))

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """out[slot] = Σ of the values routed to it, vals (n,) or (B, n);
        returns (size,) or (B, size)."""
        if vals.ndim > 1:
            return torch.stack([self.sum(v) for v in vals])
        out = vals.new_zeros(self.size)
        if self.perm.numel():
            out[self.slots] = torch.segment_reduce(
                vals[self.perm], "sum", lengths=self.lengths, unsafe=True)
        return out


@dataclasses.dataclass
class DDAssemblyPlan:
    """Routing plan for the batched dense DD block refill.

    Destination indices are stored as (tgt_dom, tgt_loc) PAIRS, tgt_dom the
    subdomain and tgt_loc the within-block flat index, segmented by target
    block:
      [0, n_ii)           -> A_II  (loc = i*nI + j)
      [n_ii, n_ii+n_ig)   -> A_IΓ  (loc = i*nG + g)
      [.., +n_gg)         -> A_ΓΓd (loc = gi*nG + gj)
    The JAX package keeps pairs because it indexes with int32 and one
    combined index overflows past nI ≈ 11.5k. torch indexes with int64 and
    never narrows silently, so the pairs are combined here (`scatters`);
    they are kept as fields so that a plan of the JAX package carries
    across field by field (convert.dd_assembly_plan). kflat/eflat: geometry
    factor and element id per contribution.

    `scatters` holds the fixed-order form of the five scatter-adds (A_II,
    A_IΓ, A_ΓΓd, b_I, b_Γ), derived from the fields above.
    """
    cells: torch.Tensor
    kflat: torch.Tensor
    eflat: torch.Tensor
    tgt_dom: torch.Tensor
    tgt_loc: torch.Tensor
    bI_fac: torch.Tensor
    bI_slot: torch.Tensor
    bI_elem: torch.Tensor
    bG_fac: torch.Tensor
    bG_slot: torch.Tensor
    bG_elem: torch.Tensor
    bI_fixed: torch.Tensor    # (ndom, nI)
    bG_fixed: torch.Tensor    # (n_gamma,)
    imask: torch.Tensor       # (ndom, nI) 1.0 where valid
    gmask: torch.Tensor       # (ndom, nG)
    sizes_I: torch.Tensor     # (ndom,)
    sizes_G: torch.Tensor     # (ndom,)
    ndom: int
    nI: int
    nG: int
    n_gamma: int
    n_ii: int
    n_ig: int
    n_gg: int
    scatters: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        ndom, nI, nG = self.ndom, self.nI, self.nG
        s1, s2 = self.n_ii, self.n_ii + self.n_ig
        dom, loc = self.tgt_dom, self.tgt_loc
        self.scatters = {
            "ii": OrderedScatter.of(dom[:s1] * (nI * nI) + loc[:s1],
                                    ndom * nI * nI),
            "ig": OrderedScatter.of(dom[s1:s2] * (nI * nG) + loc[s1:s2],
                                    ndom * nI * nG),
            "gg": OrderedScatter.of(dom[s2:] * (nG * nG) + loc[s2:],
                                    ndom * nG * nG),
            "bI": OrderedScatter.of(self.bI_slot, ndom * nI),
            "bG": OrderedScatter.of(self.bG_slot, self.n_gamma),
        }


def prepare_dd_assembly(cells, points, epart, part: DDPartition,
                        maps: DirichletMaps, f, u_exact, dtype=None,
                        device=None) -> DDAssemblyPlan:
    """Host-side symbolic routing of element contributions into DD blocks
    (prepare_local_schurs analogue, values refilled on the device)."""
    device, dtype = resolve(device, dtype)
    nel = cells.shape[0]
    ndom, nI, nG = part.ndom, part.nI_max, part.nG_max
    dx, dy, area = element_geometry(cells, points)
    kg = (dy[:, :, None] * dy[:, None, :] + dx[:, :, None] * dx[:, None, :]) \
        / (4.0 * area[:, None, None])

    gi = cells[:, :, None].repeat(3, axis=2).ravel()
    gj = cells[:, None, :].repeat(3, axis=1).ravel()
    eid = np.broadcast_to(np.arange(nel)[:, None, None], (nel, 3, 3)).ravel()
    kgf = kg.reshape(-1)
    dom = epart[eid]
    own_i = part.node_owner[gi]
    own_j = part.node_owner[gj]

    ii = (own_i >= 0) & (own_j >= 0)                 # both interior (same dom)
    ig = (own_i >= 0) & (own_j == -1)                # interior-row, Γ-col
    gg = (own_i == -1) & (own_j == -1)               # both Γ
    lift_i = (own_i == -2) & (own_j >= 0)            # Dirichlet-row → b_I
    lift_g = (own_i == -2) & (own_j == -1)           # Dirichlet-row → b_Γ

    li = part.interior_g2l[gi].astype(np.int64)
    lj = part.interior_g2l[gj].astype(np.int64)
    lgj = part.gamma_to_gammad[
        dom, np.where(own_j == -1, part.gamma_g2l[gj], 0)].astype(np.int64)
    lgi = part.gamma_to_gammad[
        dom, np.where(own_i == -1, part.gamma_g2l[gi], 0)].astype(np.int64)

    loc_ii = (li * nI + lj)[ii]
    loc_ig = (li * nG + lgj)[ig]
    loc_gg = (lgi * nG + lgj)[gg]

    sel = np.concatenate([np.nonzero(ii)[0], np.nonzero(ig)[0],
                          np.nonzero(gg)[0]])
    tgt_dom = dom[sel]
    tgt_loc = np.concatenate([loc_ii, loc_ig, loc_gg])
    kflat = kgf[sel]
    eflat = eid[sel]

    px, py = points[:, 0], points[:, 1]
    uex = u_exact(px[gi], py[gi])
    # b_I lift: b_I[dom, lj] -= uexact_i * coeff * kgeo
    bI_slot = (dom * nI + lj)[lift_i]
    bI_fac = (-uex * kgf)[lift_i]
    bI_elem = eid[lift_i]
    # b_Γ lift (GLOBAL Γ index, shared across doms)
    bG_slot = part.gamma_g2l[gj][lift_g]
    bG_fac = (-uex * kgf)[lift_g]
    bG_elem = eid[lift_g]

    # fixed source terms
    fvals = f(px, py)[cells]
    fsum = fvals.sum(axis=1, keepdims=True)
    contrib = (fvals + fsum) * area[:, None] / 12.0
    bI_fixed = np.zeros((ndom, nI))
    bG_fixed = np.zeros(part.n_gamma)
    own_c = part.node_owner[cells]
    m_int = own_c >= 0
    np.add.at(bI_fixed, (own_c[m_int], part.interior_g2l[cells][m_int]),
              contrib[m_int])
    m_g = own_c == -1
    np.add.at(bG_fixed, part.gamma_g2l[cells][m_g], contrib[m_g])

    imask = (np.arange(nI)[None, :] < part.n_interior[:, None])
    gmask = (np.arange(nG)[None, :] < part.n_gammad[:, None])

    idx = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),  # noqa: E731
                                    device=device)
    val = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),  # noqa: E731
                                    dtype=dtype, device=device)
    return DDAssemblyPlan(
        cells=idx(cells), kflat=val(kflat), eflat=idx(eflat),
        tgt_dom=idx(tgt_dom), tgt_loc=idx(tgt_loc),
        bI_fac=val(bI_fac), bI_slot=idx(bI_slot), bI_elem=idx(bI_elem),
        bG_fac=val(bG_fac), bG_slot=idx(bG_slot), bG_elem=idx(bG_elem),
        bI_fixed=val(bI_fixed), bG_fixed=val(bG_fixed),
        imask=val(imask), gmask=val(gmask),
        sizes_I=idx(part.n_interior), sizes_G=idx(part.n_gammad),
        ndom=ndom, nI=nI, nG=nG, n_gamma=part.n_gamma,
        n_ii=int(loc_ii.shape[0]), n_ig=int(loc_ig.shape[0]),
        n_gg=int(loc_gg.shape[0]))


def domain_decompose_rhs(part: DDPartition, maps: DirichletMaps, b_free):
    """Split a free-dof RHS into (b_I (ndom, nI), b_G (n_gamma,)): reference
    `domain_decompose_rhs!` (EllipticPdeDomainDecomposition.jl:545-582).
    A tensor gives tensors on its device; an array gives arrays."""
    as_tensor = torch.is_tensor(b_free)
    b = b_free.detach().cpu().numpy() if as_tensor else np.asarray(b_free)
    b_I = np.zeros((part.ndom, part.nI_max), dtype=b.dtype)
    valid = part.interior_l2g >= 0
    b_I[valid] = b[maps.free_g2l[part.interior_l2g[valid]]]
    b_G = b[maps.free_g2l[part.gamma_l2g]]
    if as_tensor:
        return (torch.as_tensor(b_I, device=b_free.device),
                torch.as_tensor(b_G, device=b_free.device))
    return b_I, b_G


def get_partition(cells, points, cell_neighbors, maps: DirichletMaps,
                  ndom: int, use_native: bool = True):
    """Partition + DD index structures in one call (reference `get_partition`,
    Fem/Mesh.jl:265-293)."""
    from .partition import mesh_partition
    epart, npart = mesh_partition(cells, points, ndom, cell_neighbors,
                                  use_native=use_native)
    part = set_subdomains(cells, epart, maps, ndom)
    return epart, npart, part


def assemble_dd_values(plan: DDAssemblyPlan, coeff_nodes: torch.Tensor):
    """Per-realization refill of the batched DD blocks, on the plan's device.

    coeff_nodes (nnode,) gives (A_II (ndom,nI,nI), A_IG (ndom,nI,nG), A_GGd
    (ndom,nG,nG), b_I (ndom,nI), b_G (n_gamma,)); a batch of fields
    (B, nnode) gives every block a leading B axis."""
    ndom, nI, nG = plan.ndom, plan.nI, plan.nG
    lead = coeff_nodes.shape[:-1]
    coeff_e = torch.mean(coeff_nodes[..., plan.cells], dim=-1)
    vals = coeff_e[..., plan.eflat] * plan.kflat
    s1, s2 = plan.n_ii, plan.n_ii + plan.n_ig
    sc = plan.scatters
    A_II = sc["ii"].sum(vals[..., :s1]).reshape(*lead, ndom, nI, nI)
    A_IG = sc["ig"].sum(vals[..., s1:s2]).reshape(*lead, ndom, nI, nG)
    A_GGd = sc["gg"].sum(vals[..., s2:]).reshape(*lead, ndom, nG, nG)
    b_I = plan.bI_fixed + sc["bI"].sum(
        coeff_e[..., plan.bI_elem] * plan.bI_fac).reshape(*lead, ndom, nI)
    b_G = plan.bG_fixed + sc["bG"].sum(
        coeff_e[..., plan.bG_elem] * plan.bG_fac)
    return A_II, A_IG, A_GGd, b_I, b_G
