"""Two-level (domain-decomposed) Karhunen-Loève expansion, batched.

Port of `krylov_spdes_tpu/kl/dd.py` (reference:
Fem/KarhunenLoeveDomainDecomposition.jl:40-845, Lindgren-style two-level
KL):

- The reference loops subdomains serially: local dense covariance assembly
  (:120-293), ARPACK local eigensolves (:679), then a reduced global problem
  K[αβ] = Φdᵀ C Φd' assembled pairwise with center-distance `forget`
  screening (:499-501), dense `eigen(Symmetric(K))`, and projection back to
  mesh nodes with multiplicity averaging (:920-983).
- As in kl/single.py, the reference's quadrature makes every covariance
  block C_{dd'} = M_d Ĉ_{dd'} M_{d'}, so with ρ_d = M_d Φ_d the reduced
  blocks are K_{dd'} = ρ_dᵀ Ĉ_{dd'} ρ_{d'}: batched dense products over
  (pair, n_max, n_max) tiles.
- Subdomains are padded to a common n_max/m_max with masks; the local
  generalized eigensolves are one batched Cholesky + batched eigh; the
  per-domain truncation zeroes trailing mode columns.

The index tables, the truncation loops, the reduced eigensolve (`eigh` or
scipy's `eigsh`) and the projection's `np.add.at` run on the host, as in
the JAX package; the covariance blocks and the local eigensolves on the
device of the subdomains' mass matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve
from ..fem.mesh import element_geometry
from ..parallel.sharding import all_gather_cat
from .synthesis import trim_and_order


@dataclasses.dataclass
class KLSubdomains:
    """Padded per-subdomain node/element structures (set_subdomain analogue,
    reference :40-80; a subdomain's node set = all nodes of its elements)."""
    ndom: int
    n_max: int
    nodes: np.ndarray        # (ndom, n_max) global node ids, -1 pad
    node_mask: np.ndarray    # (ndom, n_max) bool
    n_nodes: np.ndarray      # (ndom,)
    centers: np.ndarray      # (ndom, 2)
    areas: np.ndarray        # (ndom,)
    M_local: torch.Tensor    # (ndom, n_max, n_max) local mass matrices
    cnt: np.ndarray          # (nnode,) #subdomains containing each node


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def set_kl_subdomains(cells, points, epart, ndom, dtype=None,
                      device=None) -> KLSubdomains:
    device, dtype = resolve(device, dtype)
    nnode = points.shape[0]
    _, _, area = element_geometry(cells, points)

    node_lists = []
    centers = np.zeros((ndom, 2))
    areas = np.zeros(ndom)
    for d in range(ndom):
        els = np.nonzero(epart == d)[0]
        nodes = np.unique(cells[els].ravel())
        node_lists.append(nodes)
        centers[d] = points[nodes].mean(axis=0)
        areas[d] = area[els].sum()
    n_nodes = np.array([len(x) for x in node_lists])
    n_max = int(n_nodes.max())
    nodes_pad = -np.ones((ndom, n_max), dtype=np.int64)
    g2l = -np.ones((ndom, nnode), dtype=np.int64)
    for d, nl in enumerate(node_lists):
        nodes_pad[d, :len(nl)] = nl
        g2l[d, nl] = np.arange(len(nl))
    mask = nodes_pad >= 0
    cnt = np.zeros(nnode, dtype=np.int64)
    for nl in node_lists:
        cnt[nl] += 1

    # batched local mass matrices (do_local_mass_assembly, reference
    # :236-293)
    M = np.zeros((ndom, n_max, n_max))
    local = (np.ones((3, 3)) + np.eye(3)) / 12.0
    for d in range(ndom):
        els = np.nonzero(epart == d)[0]
        li = g2l[d][cells[els]]                      # (nel_d, 3)
        vals = area[els][:, None, None] * local
        np.add.at(M[d], (li[:, :, None].repeat(3, 2),
                         li[:, None, :].repeat(3, 1)), vals)
    return KLSubdomains(ndom=ndom, n_max=n_max, nodes=nodes_pad,
                        node_mask=mask, n_nodes=n_nodes, centers=centers,
                        areas=areas,
                        M_local=torch.as_tensor(M, dtype=dtype, device=device),
                        cnt=cnt)


def _local_generalized_eigh(C, M, maskf):
    """Batched C φ = λ M φ, descending; masked coords get M = I, C = 0."""
    pad = torch.diag_embed(1.0 - maskf)
    m2 = maskf[:, :, None] * maskf[:, None, :]
    L = torch.linalg.cholesky(M * m2 + pad)
    Y = torch.linalg.solve_triangular(L, C * m2, upper=False)
    B = torch.linalg.solve_triangular(L, Y.transpose(1, 2), upper=False)
    w, U = torch.linalg.eigh((B + B.transpose(1, 2)) / 2)
    phi = torch.linalg.solve_triangular(L.transpose(1, 2), U.flip(2),
                                        upper=True)
    return w.flip(1), phi


def _padded_coords(sub_or_tables, points, dtype, device):
    """(ndom, n_max, 2) node coordinates (padding at node 0) and the
    (ndom, n_max) float mask."""
    nodes = np.maximum(sub_or_tables.nodes, 0)
    coords = torch.as_tensor(np.asarray(points)[nodes], dtype=dtype,
                             device=device)
    maskf = torch.as_tensor(sub_or_tables.node_mask, dtype=dtype,
                            device=device)
    return coords, maskf


def _local_covariance(cov, Mloc, coords, maskf):
    """C = M Ĉ Mᵀ of a batch of subdomains, Ĉ masked to the real nodes."""
    Chat = cov(coords[:, :, None, :], coords[:, None, :, :])
    Chat = Chat * maskf[:, :, None] * maskf[:, None, :]
    return Mloc @ Chat @ Mloc.transpose(1, 2)


def solve_local_kls(sub: KLSubdomains, points, cov, nev: int,
                    relative: float = 0.99, verbose: bool = False,
                    dom_chunk: int | None = None, mesh=None):
    """Batched local KL eigensolves + per-domain energy truncation
    (solve_local_kl, reference :657-738). Returns (lam_d (ndom, m_max),
    phi_d (ndom, n_max, m_max), m_d (ndom,)) as numpy with zero-padded
    trailing modes, and the total expected energy Σ_d area_d·cov(c_d,c_d).

    `dom_chunk` processes subdomains in chunks of that size: the covariance
    blocks are O(ndom · n_max²). With `mesh` (parallel.Mesh), each rank
    along its 'dom' axis solves a contiguous share of the subdomains, and
    the eigenpairs are all-gathered."""
    dtype, device = sub.M_local.dtype, sub.M_local.device
    coords_all, maskf_all = _padded_coords(sub, points, dtype, device)

    lo, hi = 0, sub.ndom
    if mesh is not None:
        per = -(-sub.ndom // mesh.axis_size("dom"))
        lo = min(sub.ndom, mesh.index("dom") * per)
        hi = min(sub.ndom, lo + per)
    k = min(nev, sub.n_max)
    ws = [torch.zeros((0, k), dtype=dtype, device=device)]
    phis = [torch.zeros((0, sub.n_max, k), dtype=dtype, device=device)]
    step = dom_chunk or max(hi - lo, 1)
    for s in range(lo, hi, step):
        e = min(s + step, hi)
        Mloc = sub.M_local[s:e]
        C = _local_covariance(cov, Mloc, coords_all[s:e], maskf_all[s:e])
        w_c, phi_c = _local_generalized_eigh(C, Mloc, maskf_all[s:e])
        ws.append(w_c[:, :nev])
        phis.append(phi_c[:, :, :nev])
    w, phi = torch.cat(ws), torch.cat(phis)
    if mesh is not None:
        pad = lambda t: torch.cat([t, t.new_zeros(  # noqa: E731
            (per - t.shape[0],) + t.shape[1:])])
        w = all_gather_cat(pad(w), mesh, "dom")[:sub.ndom]
        phi = all_gather_cat(pad(phi), mesh, "dom")[:sub.ndom]
    w, phi = _host(w), _host(phi)

    # per-domain truncation (energy rule, reference :705-718)
    c = torch.as_tensor(sub.centers, dtype=dtype, device=device)
    var0 = _host(cov(c[:, None, :], c[:, None, :]))[:, 0]
    energy_expected = relative * sub.areas * var0
    m_d = np.zeros(sub.ndom, dtype=np.int64)
    for d in range(sub.ndom):
        e = 0.0
        for k in range(nev):
            if w[d, k] <= 0:
                break
            m_d[d] += 1
            e += w[d, k]
            if e >= energy_expected[d]:
                break
        if verbose:
            print(f"idom = {d}, {m_d[d]}/{nev} vectors kept")
    m_max = int(m_d.max())
    lam_d = w[:, :m_max].copy()
    phi_d = phi[:, :, :m_max].copy()
    # M-renormalize kept modes; zero dropped columns
    Mloc = _host(sub.M_local)
    for d in range(sub.ndom):
        for k in range(m_max):
            if k < m_d[d]:
                nrm = np.sqrt(phi_d[d, :, k] @ Mloc[d] @ phi_d[d, :, k])
                phi_d[d, :, k] /= nrm
            else:
                lam_d[d, k] = 0.0
                phi_d[d, :, k] = 0.0
        phi_d[d] *= sub.node_mask[d][:, None]
    total_energy = float((sub.areas * var0).sum())
    return lam_d, phi_d, m_d, total_energy


def assemble_reduced_covariance(sub: KLSubdomains, points, cov, phi_d,
                                forget: float = -1.0, pair_chunk: int = 64):
    """Reduced K over retained local modes with `forget` screening
    (do_global_mass_covariance_reduced_assembly, reference :465-614).
    K_{dd'} = ρ_dᵀ Ĉ_{dd'} ρ_{d'} with ρ_d = M_d φ_d, batched over the
    screened pair list in chunks. Returns the (ndom·m_max)² K as numpy."""
    dtype, device = sub.M_local.dtype, sub.M_local.device
    ndom, n_max, m_max = phi_d.shape
    rho = sub.M_local @ torch.as_tensor(np.asarray(phi_d), dtype=dtype,
                                        device=device)
    coords, maskf = _padded_coords(sub, points, dtype, device)
    coords = coords * maskf[..., None]

    # screened pair list (upper triangle incl. diagonal)
    c = torch.as_tensor(sub.centers, dtype=dtype, device=device)
    cc = _host(cov(c[:, None, :], c[None, :, :]))
    pairs = np.asarray([(i, j) for i in range(ndom) for j in range(i, ndom)
                        if cc[i, j] > forget], dtype=np.int64)

    K = np.zeros((ndom, ndom, m_max, m_max))
    for s in range(0, len(pairs), pair_chunk):
        chunk = pairs[s:s + pair_chunk]
        pi = torch.as_tensor(chunk[:, 0], device=device)
        pj = torch.as_tensor(chunk[:, 1], device=device)
        Ch = cov(coords[pi][:, :, None, :], coords[pj][:, None, :, :])
        Ch = Ch * maskf[pi][:, :, None] * maskf[pj][:, None, :]
        Kb = _host(rho[pi].transpose(1, 2) @ Ch @ rho[pj])
        for (i, j), kb in zip(chunk, Kb):
            K[i, j] = kb
            if i != j:
                K[j, i] = kb.T
    # flatten ragged (only the first m_d[d] modes are meaningful; dropped
    # modes are zero rows/cols and vanish in the final trim)
    return K.transpose(0, 2, 1, 3).reshape(ndom * m_max, ndom * m_max)


def solve_global_reduced_kl(nnode, K, energy_expected, sub: KLSubdomains,
                            phi_d, relative: float = 0.99,
                            verbose: bool = False,
                            return_reduced: bool = False,
                            max_modes: int | None = None):
    """Dense reduced eigensolve + truncation + projection to mesh nodes
    (reference :783-845, project_on_mesh :920-983), on the host.

    max_modes caps the kept modes; when the reduced dimension is much
    larger than the cap, a Lanczos partial eigensolve (scipy's eigsh)
    replaces the full O(nred³) eigh."""
    K = _host(K)
    nred = K.shape[0]
    if max_modes is not None and nred > max(4 * max_modes, 500):
        from scipy.sparse.linalg import eigsh
        w, V = eigsh((K + K.T) / 2, k=max_modes, which="LA")
        w, V = trim_and_order(w, V)
    else:
        w, V = np.linalg.eigh((K + K.T) / 2)
        w, V = trim_and_order(w, V)
        if max_modes is not None:
            w, V = w[:max_modes], V[:, :max_modes]
    target = relative * energy_expected
    energy, nvec = 0.0, 0
    for lam in w:
        energy += lam
        nvec += 1
        if energy >= target:
            break
    lam = w[:nvec]
    Vr = V[:, :nvec]
    if verbose:
        print(f"{nvec}/{len(w)} vectors kept")

    # project: Ψ[node] = Σ_d Φd · V_d block, multiplicity-averaged
    phi_d = _host(phi_d)
    ndom, n_max, m_max = phi_d.shape
    Vr = Vr.reshape(ndom, m_max, nvec)
    contrib = np.einsum("dnm,dmk->dnk", phi_d, Vr)
    psi = np.zeros((nnode, nvec))
    np.add.at(psi, np.maximum(sub.nodes, 0),
              contrib * sub.node_mask[:, :, None])
    psi /= np.maximum(sub.cnt, 1)[:, None]
    if return_reduced:
        return lam, psi, Vr
    return lam, psi


def draw_dd(sub: KLSubdomains, lam, V_red, phi_d,
            generator: torch.Generator | None = None, xi=None):
    """Field realization synthesized directly in the two-level basis:
    g = avg_d Σ_α φ_d,α (V_red √Λ ξ)_dα, the reference's `pll_draw`
    (KarhunenLoevePllDomainDecomposition.jl:661-693) / DD `draw`
    (:849-881), as batched products + one multiplicity-averaged scatter.
    V_red is the reduced eigvec block (ndom, m_max, nmode). ξ is `xi` when
    given, else drawn from `generator` (the JAX package draws it from a
    key). Returns (ξ, g) on the device of the subdomains."""
    dtype, device = sub.M_local.dtype, sub.M_local.device
    as_t = lambda a: torch.tensor(_host(a), dtype=dtype,  # noqa: E731
                                  device=device)
    lam = as_t(lam)
    if xi is None:
        xi = torch.randn(lam.shape[0], generator=generator, dtype=dtype,
                         device=device)
    else:
        xi = as_t(xi)
    coef = as_t(V_red) @ (torch.sqrt(lam) * xi)              # (ndom, m_max)
    contrib = torch.einsum("dnm,dm->dn", as_t(phi_d), coef)
    contrib = contrib * torch.as_tensor(sub.node_mask, dtype=dtype,
                                        device=device)
    nnode = sub.cnt.shape[0]
    idx = torch.as_tensor(np.maximum(sub.nodes, 0).reshape(-1), device=device)
    g = contrib.new_zeros(nnode).index_add_(0, idx, contrib.reshape(-1))
    return xi, g / as_t(np.maximum(sub.cnt, 1))


def compute_dd_kl(cells, points, epart, ndom, cov, nev: int,
                  relative_local: float = 0.99, relative_global: float = 0.99,
                  forget: float = -1.0, verbose: bool = False,
                  device_mesh=None, dom_chunk: int | None = None,
                  dtype=None, device=None):
    """End-to-end two-level KL (the reference pipeline of Example04). With
    `device_mesh` (a parallel.Mesh), the batched local eigensolves, the
    dominant stage, split over its 'dom' ranks: the `pll_compute_kl` of
    Example05 (C15), a static split in place of the reference's dynamic
    master-worker scheduler. Every rank returns the whole result."""
    sub = set_kl_subdomains(cells, points, epart, ndom, dtype=dtype,
                            device=device)
    lam_d, phi_d, m_d, energy = solve_local_kls(sub, points, cov, nev,
                                                relative=relative_local,
                                                verbose=verbose,
                                                dom_chunk=dom_chunk,
                                                mesh=device_mesh)
    K = assemble_reduced_covariance(sub, points, cov, phi_d, forget=forget)
    return solve_global_reduced_kl(points.shape[0], K, energy, sub, phi_d,
                                   relative=relative_global, verbose=verbose)
