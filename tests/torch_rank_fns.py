"""Rank-side halves of the port's multi-rank tests
(tests/test_torch_parallel.py, tests/test_torch_sharded_chains.py).

Each function runs on every rank spawned by
`krylov_spdes_tpu_torch.parallel.launch`, in float64 on the CPU over gloo,
and returns numpy arrays for the pytest process to compare. This module
imports the port only, never JAX: the ranks are fresh interpreters, and
the JAX side of a comparison runs in the pytest process, whose inputs
reach the ranks as numpy arrays.
"""

from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from krylov_spdes_tpu_torch import chains as tch
from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch import dd_chains as tdc
from krylov_spdes_tpu_torch import fem as tfem
from krylov_spdes_tpu_torch import kl as tkl
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.kl import dd_device as tdev
from krylov_spdes_tpu_torch.parallel import multihost, sharding
from krylov_spdes_tpu_torch.parallel.schur_sharded import (
    sharded_schur_matvec, sharded_schur_rhs)
from krylov_spdes_tpu_torch.solvers import cg, pcg

CPU64 = dict(device="cpu", dtype=torch.float64)
T = partial(torch.as_tensor, dtype=torch.float64)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_zero(x, y):
    return 0.0 * x


def sine_basis(points, kmax=3, decay=0.3):
    """tests/test_sharded.py's 3 x 3 sine modes in place of a KL basis."""
    xs, ys = points[:, 0], points[:, 1]
    modes, lams = [], []
    for a in range(1, kmax + 1):
        for b in range(1, kmax + 1):
            modes.append(np.sin(np.pi * a * xs) * np.sin(np.pi * b * ys) * 2)
            lams.append(np.exp(-decay * (a * a + b * b)))
    return np.asarray(lams), np.stack(modes, 1)


def _np(t):
    return t.detach().cpu().numpy()


# --- parallel/: the mesh, psum and the sharded Schur operator --------------

def init_rank(coordinator):
    """init_distributed again (a no-op once up), is_coordinator,
    global_mesh, psum and all_gather_cat on two ranks."""
    multihost.init_distributed(coordinator, 2, dist.get_rank(),
                               backend="gloo", device="cpu")
    rank = dist.get_rank()
    mesh = multihost.global_mesh(n_dom=2, n_chain=1)
    x = torch.arange(3, dtype=torch.float64) + 10.0 * rank
    return dict(world=dist.get_world_size(), rank=rank,
                coordinator=multihost.is_coordinator(),
                shape=mesh.shape, dom=mesh.index("dom"),
                chain=mesh.index("chain"),
                psum=_np(sharding.psum(x, mesh, "dom")),
                psum_calls=mesh.psum_calls, psum_bytes=mesh.psum_bytes,
                gathered=_np(sharding.all_gather_cat(x[None], mesh, "dom")))


def failing_rank():
    """Rank 1 raises while rank 0 waits in a barrier it never leaves."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def schur_rank(S_fields, b_I, b_G, x, n_dom):
    """(a) the sharded matvec, rhs and CG; (b) Example 08's NN-PCG through
    shard_schur_operator, each beside the unsharded operator."""
    mesh = sharding.make_mesh(n_dom, 1)
    S = convert.schur_operator(**S_fields, **CPU64)
    b_I, b_G, x = T(b_I), T(b_G), T(x)
    op = sharded_schur_matvec(mesh, S)
    bs = sharded_schur_rhs(mesh, S, b_I, b_G)
    r = cg(op, bs)
    Ssh = sharding.shard_schur_operator(S, mesh)
    bs8 = tschur.get_schur_rhs(Ssh, b_I, b_G)
    r8 = pcg(Ssh, bs8, M=tschur.prepare_neumann_neumann_schur_precond(Ssh))
    bs_ref = tschur.get_schur_rhs(S, b_I, b_G)
    r8_ref = pcg(S, bs_ref,
                 M=tschur.prepare_neumann_neumann_schur_precond(S))
    return dict(y=_np(op(x)), bs=_np(bs), cg_it=int(r.it), cg_x=_np(r.x),
                local_doms=Ssh.A_IG.shape[0], ex08_it=int(r8.it),
                ex08_x=_np(r8.x), ex08_it_ref=int(r8_ref.it),
                ex08_x_ref=_np(r8_ref.x))


def condense_rank(splan_fields, coeff, x, n_shards):
    """(d) the shard's _local_condense: A x, M x and b_schur."""
    mesh = sharding.make_mesh(n_shards, 1)
    sp = convert.sharded_dd_plan(**splan_fields, **CPU64)
    sh = tdc.DDShard.of(sp, mesh.index("dom"))
    A, M, b_s = tdc._local_condense(
        sh, T(coeff), partial(sharding.psum, mesh=mesh, axis="dom"))
    return dict(Ax=_np(A(T(x))), Mx=_np(M(T(x))), b_s=_np(b_s))


def kl_rank(cells, points, epart, ndom, nev, L, tables_problem, rho,
            pair_chunk, n_dom):
    """(g) compute_dd_kl(device_mesh=), reduced_covariance_device(mesh=)
    on the JAX package's ρ, and compute_dd_kl_device(mesh=)."""
    mesh = sharding.make_mesh(n_dom, 1)
    cov = tkl.make_cov("sexp", 1.0, L)
    lam, _ = tkl.compute_dd_kl(cells, points, epart, ndom, cov, nev=nev,
                               device_mesh=mesh, **CPU64)
    cells2, points2, epart2, ndom2, L2 = tables_problem
    cov2 = tkl.make_cov("sexp", 1.0, L2)
    tables = tdev.build_kl_tables(cells2, points2, epart2, ndom2)
    K = tdev.reduced_covariance_device(tables, points2, T(rho), cov2,
                                       pair_chunk=pair_chunk, mesh=mesh)
    lam_dev, _ = tdev.compute_dd_kl_device(
        cells2, points2, epart2, ndom2, cov2, nev=10, dom_chunk=4,
        pair_chunk=pair_chunk, mesh=mesh, **CPU64)
    return dict(lam=lam, K=_np(K), lam_dev=lam_dev)


def kl_sign_rank(cells, points, epart, ndom, nev, L):
    """compute_dd_kl_device(mesh=) where each rank's local eigensolver
    returns its eigenvectors with signs of its own (the freedom the card's
    batched eigh takes from run to run): vector i of a batch flipped where
    i + rank is odd. Every tile of the reduced covariance must still come
    from one set of local bases."""
    import torch.distributed as dist
    rank = dist.get_rank()
    solve = tdev._local_generalized_eigh

    def signed(C, M, maskf):
        w, phi = solve(C, M, maskf)
        i = torch.arange(phi.shape[0])
        return w, phi * (1.0 - 2.0 * ((i + rank) % 2)).to(phi)[:, None, None]

    tdev._local_generalized_eigh = signed
    mesh = sharding.make_mesh(dist.get_world_size(), 1)
    lam, psi = tdev.compute_dd_kl_device(
        cells, points, epart, ndom, tkl.make_cov("sexp", 1.0, L), nev=nev,
        forget=1e-6, mesh=mesh, **CPU64)
    return dict(lam=np.asarray(lam), psi=np.asarray(psi))


# --- the sharded chain steps -------------------------------------------------

def stencil_chain_problem(nnode=900):
    """tests/test_sharded.py's chain problem in the port's names."""
    mesh = tfem.get_mesh(nnode, seed=0)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    plan = tfem.prepare_stencil_assembly(mesh, maps, f_src, u_zero, **CPU64)
    lam, psi = sine_basis(mesh.points)
    return plan, lam, psi


def chain_rank(W, nchains, seed, nvec, spdim, n_chain):
    """(e) two steps of make_sharded_chain_step from the seeded W."""
    mesh = sharding.make_mesh(1, n_chain)
    plan, lam, psi = stencil_chain_problem()
    states = tch.prepare_chain_states(lam, psi, nchains, base_key=seed,
                                      **CPU64)
    step = tch.make_sharded_chain_step(mesh, plan, nvec=nvec, spdim=spdim,
                                       maxit=500)
    out = {}
    W = T(W)
    for k in (1, 2):
        states, W, its, cnt = step(states, W)
        out.update({f"g{k}": _np(states.g), f"W{k}": _np(W),
                    f"it{k}": _np(its), f"cnt{k}": _np(cnt)})
    out["gen"] = np.stack([_np(g.get_state()) for g in states.gen])
    return out


def dd_chain_problem(nnode=420, ndom=8):
    """tests/test_dd_chains.py's problem in the port's names (the C++
    partitioner; the pytest process builds it before the ranks start)."""
    mesh = tfem.get_mesh(nnode, jitter=0.2, seed=3)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = tfem.mesh_partition(mesh.cells, mesh.points, ndom,
                                   mesh.cell_neighbors)
    part = tfem.set_subdomains(mesh.cells, epart, maps, ndom)
    plan = tfem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part,
                                    maps, f_src, u_zero, **CPU64)
    M = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    lam, psi = tkl.solve_kl(mesh.cells, mesh.points,
                            tkl.make_cov("sexp", 1.0, 0.3), 12, M,
                            relative=0.98, method="dense")
    return plan, part, lam, psi


def dd_chain_rank(nchains, nvec, spdim, opts):
    """(f) on a dom 2 x chain 2 mesh: the dom-sharded step's seed and two
    steps (base_key 5), and two steps of the chain-sharded step from
    per-chain eigPCG seeds (base_key 9)."""
    mesh = sharding.make_mesh(2, 2)
    plan, part, lam, psi = dd_chain_problem()
    out = {}
    states = tch.prepare_chain_states(lam, psi, nchains, base_key=5, **CPU64)
    step, seed = tdc.make_dom_sharded_dd_chain_step(
        mesh, plan, part, nvec=nvec, spdim=spdim, **opts)
    W, it0 = seed(states)
    out.update(dom_W0=_np(W), dom_it0=_np(it0))
    for k in (1, 2):
        states, W, its, cnt = step(states, W)
        out.update({f"dom_g{k}": _np(states.g), f"dom_W{k}": _np(W),
                    f"dom_it{k}": _np(its), f"dom_cnt{k}": _np(cnt)})
    out["dom_gen"] = np.stack([_np(g.get_state()) for g in states.gen])
    out["psum_calls"] = mesh.psum_calls

    states = tch.prepare_chain_states(lam, psi, nchains, base_key=9, **CPU64)
    W = torch.stack([tdc.seed_dd_chain(plan, part,
                                       tch.chain_state(states, c), nvec,
                                       spdim, **opts)[0]
                     for c in range(nchains)])
    out["chain_W0"] = _np(W)
    step = tdc.make_sharded_dd_chain_step(mesh, plan, part, nvec=nvec,
                                          spdim=spdim, axis="chain", **opts)
    for k in (1, 2):
        states, W, its, cnt = step(states, W)
        out.update({f"chain_g{k}": _np(states.g), f"chain_W{k}": _np(W),
                    f"chain_it{k}": _np(its), f"chain_cnt{k}": _np(cnt)})
    out["chain_gen"] = np.stack([_np(g.get_state()) for g in states.gen])
    return out
