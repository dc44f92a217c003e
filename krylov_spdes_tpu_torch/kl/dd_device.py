"""Device-resident two-level KL: the `pll_compute_kl` of the reference.

Port of `krylov_spdes_tpu/kl/dd_device.py`. After a light host pass that
builds integer tables, every numeric stage runs on the device with no host
round trips between stages:

  reference (Fem/KarhunenLoevePllDomainDecomposition.jl):
    - per-subdomain local eigensolve tasks on workers   (:245-323)
    - per-subdomain row blocks of the reduced covariance,
      dynamic_mapreduce!(+, K) on the master             (:56-201, :513-537)
  here:
    - stage A: a loop over dom chunks; each chunk builds its local mass
      matrices on the device (a scatter from padded element tables), forms
      C = M Ĉ M, runs the batched generalized eigensolve, truncates by the
      energy rule and M-renormalizes with masks, and keeps only
      (λ_d, φ_d, ρ_d = M φ_d): the O(n_max²) mass and covariance blocks live
      only inside one chunk.
    - stage B: the screened pair list in chunks, each computing the tiles
      K_{dd'} = ρ_dᵀ Ĉ_{dd'} ρ_{d'} and writing them into K. With a mesh
      (`mesh=`, parallel.Mesh) the pair list is split over all its ranks
      and the partial K's merge with ONE psum: the reference's
      dynamic_mapreduce!(+, K).

Truncation semantics match the reference: local modes are kept while the
running energy is below relative_local·area_d·cov(c_d,c_d) (:705-718), the
crossing mode included; kept modes are M-renormalized.

`local_eig="auto"` resolves as the JAX package does off a TPU: the dense
batched eigh. The randomized local eigensolver stays reachable as
`local_eig="randomized"`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import resolve
from ..fem.mesh import element_geometry
from ..parallel.sharding import AXES, psum
from ..solvers.base import f32_exact
from .dd import (KLSubdomains, _local_covariance, _local_generalized_eigh,
                 _padded_coords, solve_global_reduced_kl)


@dataclasses.dataclass
class KLDomTables:
    """Light integer/geometry tables (host-built once per mesh/partition).
    Unlike KLSubdomains this does not hold the (ndom, n_max, n_max) mass
    matrices: they are rebuilt per chunk on the device."""
    ndom: int
    n_max: int
    nel_max: int
    nodes: np.ndarray      # (ndom, n_max) global node ids, -1 pad
    node_mask: np.ndarray  # (ndom, n_max)
    li: np.ndarray         # (ndom, nel_max, 3) local node ids, n_max pad slot
    el_area: np.ndarray    # (ndom, nel_max) element areas, 0 pad
    centers: np.ndarray    # (ndom, 2)
    areas: np.ndarray      # (ndom,)
    cnt: np.ndarray        # (nnode,)


def build_kl_tables(cells, points, epart, ndom) -> KLDomTables:
    """set_subdomain analogue (KarhunenLoeveDomainDecomposition.jl:40-80):
    per-subdomain padded node lists + local element connectivity."""
    nnode = points.shape[0]
    _, _, area = element_geometry(cells, points)
    area = np.asarray(area)
    order = np.argsort(epart, kind="stable")
    bounds = np.searchsorted(epart[order], np.arange(ndom + 1))
    node_lists, el_lists = [], []
    for d in range(ndom):
        els = order[bounds[d]:bounds[d + 1]]
        el_lists.append(els)
        node_lists.append(np.unique(cells[els].ravel()))
    n_nodes = np.array([len(x) for x in node_lists])
    nels = np.array([len(e) for e in el_lists])
    n_max, nel_max = int(n_nodes.max()), int(nels.max())

    nodes = -np.ones((ndom, n_max), dtype=np.int64)
    li = np.full((ndom, nel_max, 3), n_max, dtype=np.int32)  # pad: slot n_max
    el_area = np.zeros((ndom, nel_max))
    centers = np.zeros((ndom, 2))
    areas = np.zeros(ndom)
    cnt = np.zeros(nnode, dtype=np.int64)
    g2l = np.empty(nnode, dtype=np.int64)
    for d in range(ndom):
        nl, els = node_lists[d], el_lists[d]
        nodes[d, :len(nl)] = nl
        g2l[nl] = np.arange(len(nl))
        li[d, :len(els)] = g2l[cells[els]]
        el_area[d, :len(els)] = area[els]
        centers[d] = points[nl].mean(axis=0)
        areas[d] = area[els].sum()
        cnt[nl] += 1
    return KLDomTables(ndom=ndom, n_max=n_max, nel_max=nel_max, nodes=nodes,
                       node_mask=nodes >= 0, li=li, el_area=el_area,
                       centers=centers, areas=areas, cnt=cnt)


_MASS_LOCAL = (np.ones((3, 3)) + np.eye(3)) / 12.0


def _build_mass_chunk(li, el_area, n_max: int):
    """Batched local P1 mass matrices from padded element tables
    (do_local_mass_assembly, reference :236-293). One scatter-add a chunk;
    padded elements target the extra slot n_max and are sliced off."""
    B = li.shape[0]
    vals = el_area[:, :, None, None] * torch.as_tensor(
        _MASS_LOCAL, dtype=el_area.dtype, device=el_area.device)
    rows = li[:, :, :, None].expand(li.shape + (3,))
    cols = li[:, :, None, :].expand(li.shape + (3,))
    flat = rows * (n_max + 1) + cols                     # (B, nel, 3, 3)
    M = el_area.new_zeros((B, (n_max + 1) * (n_max + 1)))
    M.scatter_add_(1, flat.reshape(B, -1), vals.reshape(B, -1))
    return M.reshape(B, n_max + 1, n_max + 1)[:, :n_max, :n_max]


def _truncate_renorm(w, phi, M, energy_target, nev: int):
    """Masked energy-rule truncation + M-renormalization (reference
    :705-718, :183-185). w descending. Keeps modes while the exclusive
    running energy is below target (so the crossing mode is included)."""
    w = w[:, :nev]
    phi = phi[:, :, :nev]
    prefix = torch.cumsum(w, dim=1) - w                  # exclusive cumsum
    keep = (w > 0) & (prefix < energy_target[:, None])
    nrm2 = torch.sum(phi * (M @ phi), dim=1)
    tiny = torch.finfo(w.dtype).tiny
    inv = torch.where(keep, 1.0 / torch.sqrt(torch.clamp(nrm2, min=tiny)),
                      torch.zeros_like(nrm2))
    return w * keep.to(w.dtype), phi * inv[:, None, :], keep.sum(dim=1)


def _chol_qr2(Y):
    """Batched CholeskyQR2 orthonormalization of (B, n, q) tall-skinny Y:
    two rounds of G = YᵀY, Y ← Y chol(G)⁻ᵀ. Only products, a q×q Cholesky
    and a triangular solve; one repeat fixes single-pass CholQR's κ²
    instability to working precision."""
    for _ in range(2):
        G = Y.transpose(-1, -2) @ Y
        eps = torch.finfo(Y.dtype).eps
        tr = G.diagonal(dim1=-2, dim2=-1).sum(-1)
        G = G + torch.eye(G.shape[-1], dtype=Y.dtype, device=Y.device) * (
            eps * tr[..., None, None])
        R = torch.linalg.cholesky(G)
        Y = torch.linalg.solve_triangular(R, Y.transpose(-1, -2),
                                          upper=False).transpose(-1, -2)
    return Y


def _local_generalized_eig_randomized(C, M, maskf, nev: int, Y0,
                                      oversample: int = 16, iters: int = 4):
    """Top-q generalized eigenpairs of C φ = λ M φ (q = nev + oversample),
    batched: subspace iteration on M⁻¹C from the start block Y0
    (B, n, q). The KL covariance spectrum decays fast (SExp:
    super-exponentially), so a few power iterations with modest
    oversampling resolve the kept modes. Per iteration: Z = C Y, Y = M⁻¹ Z
    (two triangular solves off one Cholesky), CholeskyQR2. Rayleigh–Ritz on
    the final basis solves a q×q generalized problem. Returns w descending
    (B, q), phi (B, n, q), like `_local_generalized_eigh` with q modes.

    The JAX package takes this path on a TPU, whose dense batched eigh
    faults at the reference's large validation points
    (KarhunenLoeveDomainDecompositionHelper.jl:12-33)."""
    n = C.shape[1]
    q = min(n, nev + oversample)
    pad = torch.diag_embed(1.0 - maskf)
    m2 = maskf[:, :, None] * maskf[:, None, :]
    Mm = M * m2 + pad
    Cm = C * m2
    L = torch.linalg.cholesky(Mm)

    def minv(Z):
        Y = torch.linalg.solve_triangular(L, Z, upper=False)
        return torch.linalg.solve_triangular(L.transpose(1, 2), Y, upper=True)

    Y = Y0[..., :q] * maskf[:, :, None]
    for _ in range(iters):
        Y = _chol_qr2(minv(Cm @ Y))
    # Rayleigh–Ritz in span(Y): (YᵀCY) v = w (YᵀMY) v, q×q
    Yt = Y.transpose(1, 2)
    Lr = torch.linalg.cholesky(Yt @ Mm @ Y)
    Br = torch.linalg.solve_triangular(Lr, Yt @ Cm @ Y, upper=False)
    Br = torch.linalg.solve_triangular(Lr, Br.transpose(1, 2), upper=False)
    w, U = torch.linalg.eigh((Br + Br.transpose(1, 2)) / 2)
    V = torch.linalg.solve_triangular(Lr.transpose(1, 2), U.flip(2),
                                      upper=True)
    return w.flip(1), Y @ V


@f32_exact
def local_kls_device(tables: KLDomTables, points, cov, nev: int,
                     relative: float = 0.99, dom_chunk: int | None = None,
                     dtype=None, local_eig: str = "auto", device=None,
                     Y0=None, generator=None):
    """Stage A over dom chunks. Returns device tensors (lam_d (ndom, nev),
    phi_d (ndom, n_max, nev), rho_d (ndom, n_max, nev), m_d (ndom,),
    total_energy (scalar)), with no host read-back.

    local_eig: "eigh" (dense batched generalized eigh), "randomized"
    (subspace iteration from the start block Y0 (chunk, n_max, ≥ nev + 16),
    else one drawn from `generator`; every dom chunk starts from the same
    block, as every chunk of the JAX package's scan draws from
    PRNGKey(0)), or "auto", which is "eigh" here (the JAX package picks
    the randomized path only on a TPU)."""
    device, dtype = resolve(device, dtype)
    ndom, n_max = tables.ndom, tables.n_max
    chunk = dom_chunk or ndom
    npad = -(-ndom // chunk) * chunk
    if local_eig == "auto":
        local_eig = "eigh"
    if local_eig == "randomized" and Y0 is None:
        Y0 = torch.randn(chunk, n_max, nev + 16, generator=generator,
                         dtype=dtype, device=device)
    if Y0 is not None:
        Y0 = (Y0 if isinstance(Y0, torch.Tensor) else torch.tensor(Y0)).to(
            dtype=dtype, device=device)

    def pad(x, fill=0):
        p = np.full((npad,) + x.shape[1:], fill, dtype=x.dtype)
        p[:ndom] = x
        return p

    li = torch.as_tensor(pad(tables.li, n_max).astype(np.int64),
                         device=device)
    el_area = torch.as_tensor(pad(tables.el_area), dtype=dtype, device=device)
    coords = torch.as_tensor(pad(np.asarray(points)[np.maximum(
        tables.nodes, 0)]), dtype=dtype, device=device)
    maskf = torch.as_tensor(pad(tables.node_mask.astype(np.float64)),
                            dtype=dtype, device=device)
    c = torch.as_tensor(tables.centers, dtype=dtype, device=device)
    var0 = cov(c, c)                                     # (ndom,)
    areas = torch.as_tensor(tables.areas, dtype=dtype, device=device)
    energy_target = relative * torch.cat([areas * var0,
                                          var0.new_zeros(npad - ndom)])
    total_energy = torch.sum(areas * var0)

    outs = []
    for s in range(0, npad, chunk):
        sl = slice(s, s + chunk)
        M = _build_mass_chunk(li[sl], el_area[sl], n_max)
        C = _local_covariance(cov, M, coords[sl], maskf[sl])
        if local_eig == "randomized":
            w, phi = _local_generalized_eig_randomized(C, M, maskf[sl], nev,
                                                       Y0)
        elif local_eig == "eigh":
            w, phi = _local_generalized_eigh(C, M, maskf[sl])
        else:
            raise ValueError(f"unknown local_eig {local_eig!r}")
        lam, phi, m_d = _truncate_renorm(w, phi, M, energy_target[sl], nev)
        phi = phi * maskf[sl][:, :, None]
        outs.append((lam, phi, M @ phi, m_d))
    lam, phi, rho, m_d = (torch.cat(o)[:ndom] for o in zip(*outs))
    return lam, phi, rho, m_d, total_energy


def screened_pairs(tables: KLDomTables, cov, forget: float = -1.0):
    """Upper-triangle pair list with the center-distance `forget` screening
    (reference :499-501), on the host."""
    c = torch.as_tensor(tables.centers, dtype=torch.float64)
    cc = cov(c[:, None, :], c[None, :, :]).numpy()
    iu, ju = np.triu_indices(tables.ndom)
    keep = cc[iu, ju] > forget
    return np.stack([iu[keep], ju[keep]], axis=1).astype(np.int64)


@f32_exact
def reduced_covariance_device(tables: KLDomTables, points, rho, cov,
                              forget: float = -1.0, pair_chunk: int = 64,
                              mesh=None, dtype=None):
    """Stage B: K_{dd'} = ρ_dᵀ Ĉ_{dd'} ρ_{d'} over the screened pair list,
    in chunks of pair_chunk pairs, written into K on the device. The real
    pairs name distinct blocks, so each tile (and, off the diagonal, its
    transpose) is written by assignment; the JAX package's padding pairs,
    which all add zeros to block (0, 0), are not formed.

    With `mesh` (parallel.Mesh) the pairs split over all its ranks as in
    the JAX package (shard s takes pairs [s·per, (s+1)·per), per a whole
    number of chunks), each rank writes its tiles into a zero K, and ONE
    psum merges them: the reference's dynamic_mapreduce!(+, K)
    (KarhunenLoevePllDomainDecomposition.jl:513-537). Returns the
    (ndom·m, ndom·m) K, on every rank."""
    dtype = dtype or rho.dtype
    device = rho.device
    ndom, n_max, m_max = rho.shape
    rho = rho.to(dtype)
    pairs = torch.as_tensor(screened_pairs(tables, cov, forget),
                            device=device)
    if mesh is not None:
        nshard = mesh.axis_size(AXES)
        per = -(-pairs.shape[0] // (pair_chunk * nshard)) * pair_chunk
        s = mesh.index(AXES)
        pairs = pairs[s * per:(s + 1) * per]
    coords, maskf = _padded_coords(tables, points, dtype, device)

    K = rho.new_zeros((ndom, ndom, m_max, m_max))
    for s in range(0, pairs.shape[0], pair_chunk):
        pi, pj = pairs[s:s + pair_chunk].T
        Ch = cov(coords[pi][:, :, None, :], coords[pj][:, None, :, :])
        Ch = Ch * maskf[pi][:, :, None] * maskf[pj][:, None, :]
        Kb = rho[pi].transpose(1, 2) @ Ch @ rho[pj]
        K[pi, pj] = Kb
        off = pi != pj
        K[pj[off], pi[off]] = Kb[off].transpose(1, 2)
    if mesh is not None:
        K = psum(K, mesh, AXES)
    return K.permute(0, 2, 1, 3).reshape(ndom * m_max, ndom * m_max)


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def compute_dd_kl_device(cells, points, epart, ndom, cov, nev: int,
                         relative_local: float = 0.99,
                         relative_global: float = 0.99,
                         forget: float = -1.0, dom_chunk: int | None = None,
                         pair_chunk: int = 64, mesh=None, verbose=False,
                         max_modes: int | None = None,
                         local_eig: str = "auto", dtype=None, device=None,
                         Y0=None, generator=None):
    """End-to-end device-resident two-level KL (pll_compute_kl analogue,
    reference :457-614). Returns (Λ, Ψ) as numpy. With `mesh` the reduced
    covariance (stage B) splits over its ranks, as in the JAX package, and
    every rank returns the whole result.

    With verbose=True prints a per-stage wall-clock breakdown (tables /
    local eigensolves / reduced covariance / reduced eigensolve +
    projection), each stage's device work finished before its clock
    stops."""
    device, dtype = resolve(device, dtype)
    t0 = time.perf_counter()
    tables = build_kl_tables(cells, points, epart, ndom)
    t_tab = time.perf_counter() - t0

    t0 = time.perf_counter()
    lam_d, phi_d, rho, m_d, energy = local_kls_device(
        tables, points, cov, nev, relative=relative_local,
        dom_chunk=dom_chunk, dtype=dtype, local_eig=local_eig, device=device,
        Y0=Y0, generator=generator)
    _sync(rho)
    t_a = time.perf_counter() - t0

    t0 = time.perf_counter()
    K = reduced_covariance_device(tables, points, rho, cov, forget=forget,
                                  pair_chunk=pair_chunk, mesh=mesh)
    _sync(K)
    t_b = time.perf_counter() - t0

    t0 = time.perf_counter()
    # the reduced eigensolve and the projection on the host (shared with the
    # serial path)
    lam, psi = solve_global_reduced_kl(
        points.shape[0], K.cpu().numpy(), float(energy),
        _tables_as_subdomains(tables), phi_d.cpu().numpy(),
        relative=relative_global, verbose=verbose, max_modes=max_modes)
    t_c = time.perf_counter() - t0
    if verbose:
        print(f"[kl-dd-device] stages: tables {t_tab:.1f}s | local eigh "
              f"(A) {t_a:.1f}s | reduced cov (B) {t_b:.1f}s | reduced "
              f"eigensolve+projection {t_c:.1f}s "
              f"(n_max={tables.n_max}, kept modes/dom mean "
              f"{float(m_d.double().mean()):.1f}, K {K.shape[0]})",
              flush=True)
    return lam, psi


def _tables_as_subdomains(tables: KLDomTables) -> KLSubdomains:
    """Adapter for solve_global_reduced_kl (which only uses nodes, mask and
    cnt)."""
    return KLSubdomains(
        ndom=tables.ndom, n_max=tables.n_max, nodes=tables.nodes,
        node_mask=tables.node_mask,
        n_nodes=tables.node_mask.sum(axis=1), centers=tables.centers,
        areas=tables.areas, M_local=torch.zeros(()), cnt=tables.cnt)
