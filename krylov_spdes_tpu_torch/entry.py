"""Entry point of the flagship workload: one Schur-DD chain step.

The twin of the repo's `__graft_entry__.entry()`: one MCMC chain step =
RW-Metropolis KL draw -> exp(field) -> batched DD block refill -> batched
interior Cholesky -> Schur condensation -> Neumann-Neumann preconditioner ->
recycled eigDef-PCG on the interface system, on a small jittered mesh with
the general (partitioner + routing plan) DD refill and a dense KL basis.

`entry()` returns the single-chain step (dd_chains.make_dd_chain_step) and a
seeded deflation basis; it runs on the card unless a device is passed.

`dryrun_multichip(n)` spawns n ranks on this host, lays them out as an
(dom × chain) mesh and runs the full 2D-sharded step
(make_dom_sharded_dd_chain_step): chains over the `chain` axis, the batched
DD blocks AND the element-contribution assembly scatter over the `dom`
axis, every Γ-level reduction a psum over ranks: real Metropolis
accept/reject, real recycled solver, real collectives.
"""

from __future__ import annotations

import torch

from . import dd_chains, fem, kl
from .chains import prepare_chain_states
from .config import resolve
from .fem.dd import prepare_dd_assembly, set_subdomains
from .fem.native import load_native
from .fem.partition import mesh_partition
from .parallel.multihost import launch
from .parallel.sharding import make_mesh
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


def _dryrun_rank(n_devices: int, device: str) -> str:
    """One rank of dryrun_multichip: seed and two recycled steps of the
    2D-sharded chain; the JAX dry run's asserts."""
    n_chain = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_dom_shards = n_devices // n_chain
    mesh_dev = make_mesh(n_dom_shards, n_chain)
    ndom = max(8, 2 * n_dom_shards)
    ndom = ((ndom + n_dom_shards - 1) // n_dom_shards) * n_dom_shards
    nchains = 2 * n_chain
    nvec, spdim, maxit = 4, 12, 80

    fem_mesh, maps, part, plan, lam, psi = _build_problem(
        nnode=320, ndom=ndom, device=device)
    states = prepare_chain_states(lam, psi, nchains, base_key=0,
                                  device=device, dtype=plan.kflat.dtype)
    step, seed = dd_chains.make_dom_sharded_dd_chain_step(
        mesh_dev, plan, part, nvec=nvec, spdim=spdim, maxit=maxit)

    # eigPCG seeding of every chain's deflation basis (sharded)
    W, it0 = seed(states)
    assert bool((it0 >= 1).all()), it0
    # two recycled chain steps through the production path
    states, W, its1, cnts1 = step(states, W)
    states, W, its2, cnts2 = step(states, W)
    for a in (its1, its2, cnts1, cnts2):
        assert a.shape == (nchains,) and bool((a >= 1).all()), a
    assert bool(torch.isfinite(W).all())
    # recycled solves must not regress against the unrecycled seed solves
    # (at this toy size the NN preconditioner already converges in ~12
    # iterations, so the margin for recycling is small)
    assert its2.double().mean() <= it0.double().mean() + 1.0, (its2, it0)
    return (f"dryrun_multichip OK: {n_devices} devices, mesh "
            f"(dom={n_dom_shards}, chain={n_chain}), ndom={ndom}, "
            f"nchains={nchains}, seed its={it0.tolist()}, "
            f"recycled its={its2.tolist()}")


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device=None) -> str:
    """One full 2D-sharded flagship step on n_devices ranks spawned on this
    host, on `device` (the card unless given; on one card several ranks
    need backend="gloo", since NCCL takes one rank a GPU). Prints and
    returns rank 0's `dryrun_multichip OK: ...` line; a failed assert on
    any rank raises here."""
    device = resolve(device)[0]
    load_native()        # the partitioner, built before any rank loads it
    line = launch(_dryrun_rank, n_devices, args=(n_devices, str(device)),
                  backend=backend, device=device)[0]
    print(line, flush=True)
    return line
