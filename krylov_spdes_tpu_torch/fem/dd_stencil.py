"""DD block refill for structured-topology meshes from the 9-plane stencil
assembly.

Port of `krylov_spdes_tpu/fem/dd_stencil.py`. The general DD refill (fem/dd.py
`assemble_dd_values`) routes ~9·nel element contributions into the batched
dense blocks. On structured-topology meshes (every `get_mesh` output,
jittered or not) the same blocks are recoverable from the index-free 9-plane
stencil assembly (fem/stencil_assembly.py):

1. The mesh is partitioned into a py×px grid of cell tiles
   (`grid_partition`: contiguous and balanced like the reference's
   `mpmetis -contig`, Fem/Mesh.jl:185). Subdomain interiors are node
   rectangles; the interface Γ is the internal grid lines; each tile's local
   interface Γd is the boundary ring of its interior rectangle.
2. Every interior-row block entry is a GLOBAL stencil entry (an interior
   node's elements all belong to its own tile), so A_II and A_IΓ come from
   the assembled planes: per-tile sub-planes → band vectors → one
   band-to-dense pad/reshape (the strided-flatten trick: entry (i, i+o) of an
   (nE, nE) matrix sits at flat i·(nE+1)+o, so padding a (nE, 2wE+3) band
   table to row length nE+1 and re-slicing the flat buffer lays every band
   onto its diagonal) → submatrix extraction by slicing the
   (hE, wE, hE, wE) view.
3. Only A_ΓΓd (Γ-Γ couplings split by owning tile) and the Dirichlet-lift
   RHS need per-element routing: a scatter ~25× smaller than the general
   one (ring-ring contributions only), summed in a fixed order
   (fem/dd.py `OrderedScatter`).

The JAX package stacks ndom static `lax.slice`s per tile and vmaps
`dynamic_slice`s by per-tile height and width: free under `jit`, ndom small
launches each in eager PyTorch. Here each of them is ONE gather through an
index precomputed on the plan (`tables`), and the band fills are writes
through `torch.diagonal` views.

Produces the same (A_II, A_IΓ, A_ΓΓd, b_I, b_Γ) batched blocks as
`prepare_local_schurs` + `domain_decompose_rhs!`
(Fem/EllipticPdeDomainDecomposition.jl:389-582) up to the subdomain-local
index ordering, which is grid row-major here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve
from ..ops.stencil import OFFSETS
from .bc import DirichletMaps
from .dd import DDPartition, OrderedScatter
from .mesh import element_geometry
from .schur import (SchurOperatorBT, bt_factor_batched, gamma_gather_table,
                    get_schur_rhs)
from .stencil_assembly import (StencilAssemblyPlan, _coeff_element_planes,
                               prepare_stencil_assembly, stencil_assemble)


def _split_bounds(m: int, k: int) -> np.ndarray:
    """k contiguous bands of m cells, sizes m//k (+1 for the first m%k)."""
    q, r = divmod(m, k)
    sizes = np.full(k, q, dtype=np.int64)
    sizes[:r] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def tile_dims(ndom: int) -> tuple[int, int]:
    """Near-square (py, px) factorization with py·px = ndom, py <= px."""
    best = (1, ndom)
    for py in range(1, int(np.sqrt(ndom)) + 1):
        if ndom % py == 0:
            best = (py, ndom // py)
    return best


def grid_partition(mesh, ndom: int):
    """py×px cell-tile partition of a structured-topology mesh. Returns
    (epart, tile geometry dict). Contiguous + balanced by construction."""
    H = int(round(np.sqrt(mesh.nnode)))
    assert H * H == mesh.nnode, "grid_partition needs the structured grid"
    m = H - 1
    py, px = tile_dims(ndom)
    assert py <= m and px <= m, (ndom, m)
    rb = _split_bounds(m, py)
    cb = _split_bounds(m, px)
    nel = mesh.cells.shape[0]
    eci = (np.arange(nel) // 2) // m
    ecj = (np.arange(nel) // 2) % m
    band_r = np.searchsorted(rb, eci, side="right") - 1
    band_c = np.searchsorted(cb, ecj, side="right") - 1
    epart = (band_r * px + band_c).astype(np.int32)
    return epart, dict(H=H, m=m, py=py, px=px, rb=rb, cb=cb)


@dataclasses.dataclass
class DDStencilPlan:
    """Stencil-derived DD refill plan.

    splan:     the shared 9-plane stencil assembly plan
    edge_mask: (9, hE, wE) zero where the offset wraps the extended tile
    h_arr/w_arr: (ndom,) interior heights/widths
    imask/gmask: validity masks (ndom, nI) / (ndom, nG)
    gg_*:      the small Γ-Γ contribution scatter (tgt into (ndom,nG,nG) flat,
               geometry factor, element-plane index into the (2,m,m) coeff
               planes)
    gamma_idx: (n_gamma,) global node id per Γ index (for the b_Γ gather)
    ig_src/ig_tgt: A_IΓ routing, flat index into the padded planes → flat
               index into (ndom·nI·nG); every target occurs once
    gamma_cnt_f: (n_gamma,) multiplicity (float, for NN)
    g2g:       (ndom, nG) Γ index per ring slot (0 at pads)
    r0s/c0s:   per-dom extended-rect origin (tile corner)
    band_cols: column of each OFFSETS plane in the band table
    tables:    gather indices and the fixed-order scatter derived from the
               fields above (see `__post_init__`)
    """
    splan: StencilAssemblyPlan
    edge_mask: torch.Tensor
    h_arr: torch.Tensor
    w_arr: torch.Tensor
    imask: torch.Tensor
    gmask: torch.Tensor
    gg_tgt: torch.Tensor
    gg_fac: torch.Tensor
    gg_ceidx: torch.Tensor
    gamma_idx: torch.Tensor
    ig_src: torch.Tensor
    ig_tgt: torch.Tensor
    gamma_cnt_f: torch.Tensor
    g2g: torch.Tensor
    ndom: int
    nI: int
    nG: int
    n_gamma: int
    hM: int
    wM: int
    hE: int
    wE: int
    r0s: tuple
    c0s: tuple
    band_cols: tuple
    tables: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = self.gg_tgt.device
        H = self.splan.H
        hM, wM, hE, wE = self.hM, self.wM, self.hE, self.wE
        Hp, Wp = H + hE, H + wE                  # the zero-extended planes
        ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
        r0 = torch.as_tensor(self.r0s, device=dev)
        c0 = torch.as_tensor(self.c0s, device=dev)
        # per-tile extended sub-planes out of the flat (9, Hp, Wp) planes
        sub = ((ar(9) * (Hp * Wp))[None, :, None, None]
               + ((r0[:, None] + ar(hE)[None, :]) * Wp)[:, None, :, None]
               + (c0[:, None] + ar(wE)[None, :])[:, None, None, :])
        # per-tile interior rectangles out of the flat (Hp, Wp) right-hand side
        b_int = (((r0[:, None] + 1 + ar(hM)[None, :]) * Wp)[:, :, None]
                 + (c0[:, None] + 1 + ar(wM)[None, :])[:, None, :])
        h = self.h_arr.to(torch.int64)
        w = self.w_arr.to(torch.int64)
        assert self.ig_tgt.unique().numel() == self.ig_tgt.numel()
        self.tables = dict(
            sub=sub, b_int=b_int.reshape(self.ndom, self.nI),
            # the ring's bottom row (h+1) and right column (w+1) of each tile
            bottom=((h + 1) * wE)[:, None] + ar(wE)[None, :],
            right=(w + 1)[:, None].expand(self.ndom, hM).contiguous(),
            band_cols=torch.as_tensor(self.band_cols, device=dev),
            gg=OrderedScatter.of(self.gg_tgt,
                                 self.ndom * self.nG * self.nG),
            gather=gamma_gather_table(self.g2g, self.gmask, self.n_gamma))

    @property
    def kflat(self):
        """dtype/device handle, mirrors DDAssemblyPlan.kflat for callers that
        only inspect the plan's dtype (dd_chains.effective_rtol)."""
        return self.splan.factors


def prepare_dd_stencil_assembly(mesh, maps: DirichletMaps, f, u_exact,
                                ndom: int, dtype=None, device=None):
    """Tiling partition + DD index structures + stencil refill plan.

    Returns (epart, DDPartition, DDStencilPlan). The DDPartition is fully
    compatible with fem/schur.py; interior local indices are grid row-major
    within each tile's padded (hM, wM) rectangle (pad slots interleave,
    marked -1 in interior_l2g / 0.0 in imask)."""
    device, dtype = resolve(device, dtype)
    epart, tg = grid_partition(mesh, ndom)
    H, m, px = tg["H"], tg["m"], tg["px"]
    rb, cb = tg["rb"], tg["cb"]
    nnode = mesh.nnode

    r0s = tuple(int(rb[t // px]) for t in range(ndom))
    r1s = tuple(int(rb[t // px + 1]) for t in range(ndom))
    c0s = tuple(int(cb[t % px]) for t in range(ndom))
    c1s = tuple(int(cb[t % px + 1]) for t in range(ndom))
    h_arr = np.array([r1 - r0 - 1 for r0, r1 in zip(r0s, r1s)], np.int32)
    w_arr = np.array([c1 - c0 - 1 for c0, c1 in zip(c0s, c1s)], np.int32)
    hM, wM = int(h_arr.max()), int(w_arr.max())
    hE, wE = hM + 2, wM + 2
    nI = hM * wM
    nG = 2 * wE + 2 * hM

    # --- global Γ ----------------------------------------------------------
    a_grid = np.arange(nnode) // H
    b_grid = np.arange(nnode) % H
    is_dir = maps.is_dirichlet
    int_rows = np.zeros(m + 1, bool)
    int_rows[rb[1:-1]] = True
    int_cols = np.zeros(m + 1, bool)
    int_cols[cb[1:-1]] = True
    on_gamma = (~is_dir) & (int_rows[a_grid] | int_cols[b_grid])
    gamma_l2g = np.nonzero(on_gamma)[0].astype(np.int32)
    n_gamma = int(gamma_l2g.shape[0])
    gamma_g2l = -np.ones(nnode, np.int32)
    gamma_g2l[gamma_l2g] = np.arange(n_gamma, dtype=np.int32)

    # --- per-dom tables -----------------------------------------------------
    rloc = np.arange(hM)[:, None]
    cloc = np.arange(wM)[None, :]
    imask = ((rloc < h_arr[:, None, None]) &
             (cloc < w_arr[:, None, None])).reshape(ndom, nI)

    interior_l2g = -np.ones((ndom, nI), np.int32)
    interior_g2l = -np.ones(nnode, np.int32)
    gammad_to_gamma = -np.ones((ndom, nG), np.int32)
    gamma_to_gammad = -np.ones((ndom, n_gamma), np.int32)
    ring_slot = -np.ones((ndom, nnode), np.int32)
    for d in range(ndom):
        r0, r1, c0, c1 = r0s[d], r1s[d], c0s[d], c1s[d]
        h, w = int(h_arr[d]), int(w_arr[d])
        rr = np.arange(hM)[:, None]
        cc = np.arange(wM)[None, :]
        node = (r0 + 1 + rr) * H + (c0 + 1 + cc)
        valid = (rr < h) & (cc < w)
        interior_l2g[d] = np.where(valid, node, -1).reshape(-1)
        li = (rr * wM + cc)
        interior_g2l[node[valid]] = li[valid]
        # ring slots: [top(wE) | bottom(wE) | left(hM) | right(hM)]
        j = np.arange(wE)
        top = np.where(j <= w + 1, r0 * H + (c0 + j), -1)
        bot = np.where(j <= w + 1, r1 * H + (c0 + j), -1)
        i = np.arange(hM)
        left = np.where(i < h, (r0 + 1 + i) * H + c0, -1)
        right = np.where(i < h, (r0 + 1 + i) * H + c1, -1)
        ring = np.concatenate([top, bot, left, right])
        ok = ring >= 0
        gl = np.where(ok, gamma_g2l[np.maximum(ring, 0)], -1)
        gammad_to_gamma[d] = gl
        sl = np.nonzero(gl >= 0)[0]
        gamma_to_gammad[d, gl[sl]] = sl
        ring_slot[d, ring[sl]] = sl
    gmask = gammad_to_gamma >= 0
    gamma_cnt = np.zeros(n_gamma, np.int32)
    np.add.at(gamma_cnt, gammad_to_gamma[gmask], 1)

    n_interior = imask.sum(axis=1).astype(np.int64)
    part = DDPartition(
        ndom=ndom, n_gamma=n_gamma, nI_max=nI, nG_max=nG,
        node_owner=_node_owner(nnode, is_dir, on_gamma, interior_l2g),
        gamma_l2g=gamma_l2g, gamma_g2l=gamma_g2l,
        interior_l2g=interior_l2g, interior_g2l=interior_g2l,
        n_interior=n_interior, gammad_to_gamma=gammad_to_gamma,
        gamma_to_gammad=gamma_to_gammad,
        n_gammad=gmask.sum(axis=1).astype(np.int64),
        gamma_cnt=gamma_cnt.astype(np.int32))

    # --- Γ-Γ contribution scatter (the only per-element routing left) -------
    cells = mesh.cells
    nel = cells.shape[0]
    dx, dy, area = element_geometry(cells, mesh.points)
    kg = (dy[:, :, None] * dy[:, None, :] + dx[:, :, None] * dx[:, None, :]) \
        / (4.0 * area[:, None, None])
    gi = cells[:, :, None].repeat(3, axis=2).ravel()
    gj = cells[:, None, :].repeat(3, axis=1).ravel()
    eid = np.broadcast_to(np.arange(nel)[:, None, None], (nel, 3, 3)).ravel()
    gg = on_gamma[gi] & on_gamma[gj]
    dom = epart[eid[gg]]
    si = ring_slot[dom, gi[gg]]
    sj = ring_slot[dom, gj[gg]]
    assert (si >= 0).all() and (sj >= 0).all()
    gg_tgt = dom.astype(np.int64) * nG * nG + si * nG + sj
    gg_fac = kg.reshape(-1)[gg]
    e = eid[gg]
    gg_ceidx = (e % 2) * m * m + (e // 2)

    # --- A_IΓ gather/scatter tables (ring-adjacent couplings only) ----------
    Hp, Wp = H + hM + 2, H + wM + 2
    ig_src_l, ig_tgt_l = [], []
    for d in range(ndom):
        r0, r1, c0, c1 = r0s[d], r1s[d], c0s[d], c1s[d]
        h, w = int(h_arr[d]), int(w_arr[d])
        rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        a = r0 + 1 + rr
        bc = c0 + 1 + cc
        iloc = rr * wM + cc
        for k, (di, dj) in enumerate(OFFSETS):
            na, nb_ = a + di, bc + dj
            slot = np.full(na.shape, -1, np.int64)
            slot = np.where(na == r0, nb_ - c0, slot)
            slot = np.where(na == r1, (nb_ - c0) + wE, slot)
            side = (na > r0) & (na < r1)
            slot = np.where(side & (nb_ == c0), 2 * wE + na - r0 - 1, slot)
            slot = np.where(side & (nb_ == c1),
                            2 * wE + hM + na - r0 - 1, slot)
            sel = slot >= 0
            ig_src_l.append((k * Hp * Wp + a * Wp + bc)[sel])
            ig_tgt_l.append((d * nI * nG + iloc * nG + slot)[sel])
    ig_src = np.concatenate(ig_src_l)
    ig_tgt = np.concatenate(ig_tgt_l)

    # --- band geometry ------------------------------------------------------
    band_cols = tuple(di * wE + dj + (wE + 1) for di, dj in OFFSETS)
    rE = np.arange(hE)[:, None]
    cE = np.arange(wE)[None, :]
    edge_mask = np.stack([((rE + di >= 0) & (rE + di < hE) &
                           (cE + dj >= 0) & (cE + dj < wE))
                          for di, dj in OFFSETS]).astype(np.float64)

    idx = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),  # noqa: E731
                                    device=device)
    val = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),  # noqa: E731
                                    dtype=dtype, device=device)
    splan = prepare_stencil_assembly(mesh, maps, f, u_exact, dtype=dtype,
                                     device=device)
    plan = DDStencilPlan(
        splan=splan, edge_mask=val(edge_mask),
        h_arr=idx(h_arr), w_arr=idx(w_arr),
        imask=val(imask), gmask=val(gmask),
        gg_tgt=idx(gg_tgt), gg_fac=val(gg_fac), gg_ceidx=idx(gg_ceidx),
        gamma_idx=idx(gamma_l2g), ig_src=idx(ig_src), ig_tgt=idx(ig_tgt),
        gamma_cnt_f=val(gamma_cnt),
        g2g=idx(np.maximum(gammad_to_gamma, 0)),
        ndom=ndom, nI=nI, nG=nG, n_gamma=n_gamma, hM=hM, wM=wM, hE=hE,
        wE=wE, r0s=r0s, c0s=c0s, band_cols=band_cols)
    return epart, part, plan


def _node_owner(nnode, is_dir, on_gamma, interior_l2g):
    owner = np.full(nnode, -3, np.int32)
    owner[is_dir] = -2
    owner[on_gamma] = -1
    for d in range(interior_l2g.shape[0]):
        nodes = interior_l2g[d]
        owner[nodes[nodes >= 0]] = d
    return owner


def _assemble_planes(plan: DDStencilPlan, coeff_nodes):
    """Stencil planes (..., 9, H, W), right-hand side (..., n) and element
    coefficient planes (..., 2·m·m) of one field (nnode,) or a batch of
    fields (B, nnode)."""
    if coeff_nodes.ndim == 2:
        out = [_assemble_planes(plan, c) for c in coeff_nodes]
        return tuple(torch.stack(t) for t in zip(*out))
    planes, b = stencil_assemble(plan.splan, coeff_nodes)
    ce = _coeff_element_planes(plan.splan, coeff_nodes).reshape(-1)
    return planes, b, ce


def _tile_inputs(plan: DDStencilPlan, coeff_nodes):
    """What both refills start from: the flat zero-extended planes
    (..., 9·Hp·Wp), the per-tile extended sub-planes (..., ndom, 9, hE, wE),
    A_ΓΓd (..., ndom, nG, nG), b_I (..., ndom, nI) and b_Γ (..., n_gamma)."""
    ndom, nG = plan.ndom, plan.nG
    H, t = plan.splan.H, plan.tables
    planes, b, ce = _assemble_planes(plan, coeff_nodes)
    lead = planes.shape[:-3]
    Pf = F.pad(planes, (0, plan.wE, 0, plan.hE)).reshape(*lead, -1)
    subs = Pf[..., t["sub"]]
    # Γ-Γ blocks: per-element routing (the only scatter; ~ring-sized)
    A_GGd = t["gg"].sum(ce[..., plan.gg_ceidx] * plan.gg_fac).reshape(
        *lead, ndom, nG, nG)
    # RHS: the interior rectangles of the assembled b grid
    b2 = F.pad(b.reshape(*lead, H, H), (0, plan.wE, 0, plan.hE))
    b_I = b2.reshape(*lead, -1)[..., t["b_int"]] * plan.imask
    b_G = b[..., plan.gamma_idx]
    return Pf, subs, A_GGd, b_I, b_G


def assemble_dd_values_stencil(plan: DDStencilPlan, coeff_nodes):
    """Per-realization refill of the batched DENSE DD blocks from the
    stencil planes. Same contract as fem.dd.assemble_dd_values."""
    ndom, nI = plan.ndom, plan.nI
    hM, wM, hE, wE = plan.hM, plan.wM, plan.hE, plan.wE
    nE = hE * wE
    t = plan.tables
    _, subs, A_GGd, b_I, b_G = _tile_inputs(plan, coeff_nodes)
    lead = subs.shape[:-4]
    v = (subs * plan.edge_mask).reshape(*lead, ndom, 9, nE)

    # band table -> dense extended operator via the strided-flatten trick
    Bt = v.new_zeros((*lead, ndom, nE, nE + 1))
    Bt[..., t["band_cols"]] = v.transpose(-1, -2)
    flat = Bt.reshape(*lead, ndom, nE * (nE + 1))
    A4 = flat[..., wE + 1:wE + 1 + nE * nE].reshape(*lead, ndom, hE, wE, hE, wE)

    Aq = A4[..., 1:1 + hM, 1:1 + wM, :, :]            # (ndom,hM,wM,hE,wE)
    A_II = Aq[..., 1:1 + hM, 1:1 + wM].reshape(*lead, ndom, nI, nI)
    top = Aq[..., 0, :].reshape(*lead, ndom, nI, wE)
    left = Aq[..., 1:1 + hM, 0].reshape(*lead, ndom, nI, hM)
    Aqf = Aq.reshape(*lead, ndom, nI, nE)
    bottom = torch.gather(Aqf, -1, t["bottom"][:, None, :].expand(
        *lead, ndom, nI, wE))
    Aqr = Aq[..., 1:1 + hM, :].reshape(*lead, ndom, nI, hM, wE)
    right = torch.gather(Aqr, -1, t["right"][:, None, :, None].expand(
        *lead, ndom, nI, hM, 1))[..., 0]
    A_IG = torch.cat([top, bottom, left, right], dim=-1)
    return A_II, A_IG, A_GGd, b_I, b_G


def _interior_blocks(plan: DDStencilPlan, subs):
    """The block-tridiagonal interiors of the tiles from their extended
    sub-planes: D (within a grid row) and E (row -> row + 1), each
    (..., ndom, hM, wM, wM), pad rows as identity. Plane order
    ops/stencil.OFFSETS: self, E, W, N, S, NE, SW, SE, NW."""
    ndom, hM, wM = plan.ndom, plan.hM, plan.wM
    lead = subs.shape[:-4]
    vi = subs[..., 1:1 + hM, 1:1 + wM]                    # interior bands
    m2 = plan.imask.reshape(ndom, hM, wM)

    def banded(mid, upper, lower):
        M = vi.new_zeros((*lead, ndom, hM, wM, wM))
        diag = lambda o: M.diagonal(offset=o, dim1=-2, dim2=-1)  # noqa: E731
        diag(0).copy_(vi[..., mid, :, :])
        diag(1).copy_(vi[..., upper, :, :-1])
        diag(-1).copy_(vi[..., lower, :, 1:])
        return M

    D = banded(0, 1, 2) * (m2[:, :, :, None] * m2[:, :, None, :])
    D.diagonal(dim1=-2, dim2=-1).add_(1.0 - m2)           # identity padding
    m2n = torch.cat([m2[:, 1:], torch.zeros_like(m2[:, :1])], dim=1)
    E = banded(3, 5, 7) * (m2[:, :, :, None] * m2n[:, :, None, :])
    return D, E


def condense_dd_stencil(plan: DDStencilPlan, coeff_nodes):
    """One-shot realization condensation on the block-tridiagonal fast path:
    coefficient field -> (SchurOperatorBT, b_schur, b_I). The dense
    (ndom, nI, nI) interior blocks and their O(nI³) batched Cholesky never
    exist: interiors in grid order are block-tridiagonal (wM×wM blocks over
    hM grid rows), factored by hM batched steps
    (fem.schur.bt_factor_batched). A_IΓ is a ring-sized gather + write
    (~6(hM+wM) entries per dom vs the general path's ~9·nel routing).
    A batch of fields (B, nnode) gives every block a leading B axis."""
    ndom, nI, nG = plan.ndom, plan.nI, plan.nG
    coeff_nodes = torch.as_tensor(coeff_nodes, dtype=plan.kflat.dtype,
                                  device=plan.kflat.device)
    Pf, subs, A_GGd, b_I, b_G = _tile_inputs(plan, coeff_nodes)
    lead = subs.shape[:-4]
    Linv, G = bt_factor_batched(*_interior_blocks(plan, subs))

    # A_IΓ: ring-adjacent couplings only (each target written once)
    A_IG = Pf.new_zeros((*lead, ndom * nI * nG))
    A_IG[..., plan.ig_tgt] = Pf[..., plan.ig_src]
    A_IG = A_IG.reshape(*lead, ndom, nI, nG) * plan.gmask[:, None, :]
    A_GGd = A_GGd * plan.gmask[:, :, None] * plan.gmask[:, None, :]

    S = SchurOperatorBT(
        Linv=Linv, G=G, A_IG=A_IG, A_GGd=A_GGd, gammad_to_gamma=plan.g2g,
        gmask=plan.gmask, gamma_cnt=plan.gamma_cnt_f, n_gamma=plan.n_gamma,
        gamma_gather=plan.tables["gather"])
    return S, get_schur_rhs(S, b_I, b_G), b_I
