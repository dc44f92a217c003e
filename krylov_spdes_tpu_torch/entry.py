"""Entry point of the flagship workload: one Schur-DD chain step.

The twin of the repo's `__graft_entry__.entry()`: one MCMC chain step =
RW-Metropolis KL draw -> exp(field) -> batched DD block refill -> batched
interior Cholesky -> Schur condensation -> Neumann-Neumann preconditioner ->
recycled eigDef-PCG on the interface system, on a small jittered mesh with
the general (partitioner + routing plan) DD refill and a dense KL basis.

`entry()` returns the single-chain step (dd_chains.make_dd_chain_step) and a
seeded deflation basis; it runs on the card unless a device is passed. The
multi-device dry run of the JAX package is not ported yet.
"""

from __future__ import annotations

from . import dd_chains, fem, kl
from .config import resolve
from .fem.dd import prepare_dd_assembly, set_subdomains
from .fem.partition import mesh_partition
from .samplers.samplers import prepare_mcmc_sampler


def _f_src(x, y):
    return -1.0 + 0.0 * x


def _u_zero(x, y):
    return 0.0 * x


def _build_problem(nnode=320, ndom=8, seed=0, nev=10, device=None, dtype=None):
    mesh = fem.get_mesh(nnode, jitter=0.15, seed=seed)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    part = set_subdomains(mesh.cells, epart, maps, ndom)
    plan = prepare_dd_assembly(mesh.cells, mesh.points, epart, part, maps,
                               _f_src, _u_zero, dtype=dtype, device=device)
    M = fem.get_mass_matrix(mesh.cells, mesh.points, dtype=dtype,
                            device=device)
    cov = kl.make_cov("sexp", 1.0, 0.3)
    lam, psi = kl.solve_kl(mesh.cells, mesh.points, cov, nev, M,
                           relative=0.95, method="dense")
    return mesh, maps, part, plan, lam, psi


def entry(device=None, dtype=None):
    """(fn, example_args): the flagship chain step with a seeded basis:
    `state, W', it, proposals = fn(*example_args)`."""
    device, dtype = resolve(device, dtype)
    nvec, spdim, maxit = 4, 12, 60
    mesh, maps, part, plan, lam, psi = _build_problem(device=device,
                                                      dtype=dtype)
    state = prepare_mcmc_sampler(lam, psi, key=0, device=device, dtype=dtype)
    W, _, _ = dd_chains.seed_dd_chain(plan, part, state, nvec, spdim,
                                      maxit=maxit)
    step = dd_chains.make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim,
                                        maxit=maxit)
    return step, (state, W)
