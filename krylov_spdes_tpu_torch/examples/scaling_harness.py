"""Weak-scaling harness for the sharded Schur matvec.

Port of `examples/scaling_harness.py` (BASELINE.md north star: ≥80%
weak-scaling nnz/s efficiency). This harness keeps the per-rank subdomain
count constant and grows the rank count (1, 2, 4, 8, 16, up to --ranks:
a mesh over the first ranks of one launch, as the JAX harness takes the
first devices), timing the sharded matvec (local batched work + one Γ-sized
psum). When several ranks share one card the numbers measure the
collectives and the ranks' contention, not a split of the work: every line
says how many ranks shared how many cards.

  python -m krylov_spdes_tpu_torch.examples.scaling_harness --cpu \\
      --ranks 4 --doms-per-device 4 --nnode 4000
"""

from __future__ import annotations

import copy
import time
from functools import partial

import numpy as np

from .common import (add_ranks_flag, base_parser, build_dd, build_fem, host,
                     init_backend, run_ranks, sync)

RANK_COUNTS = (1, 2, 4, 8, 16)


def sharing(args, ndev: int) -> str:
    """Which hardware the ranks of a row ran on."""
    if args.device.type != "cuda":
        return f"{ndev} rank(s) on the CPU"
    import torch
    cards = torch.cuda.device_count()
    return (f"{ndev} rank(s) on {cards} card(s)" if ndev <= cards else
            f"{ndev} ranks share {cards} card(s)")


def scaled(args, ndev: int):
    """args for a row: a constant problem a rank (the mesh grows with the
    ranks)."""
    a = copy.copy(args)
    a.nnode = args.nnode * ndev
    a.ndom = ndev * args.doms_per_device
    return a


def rank_counts(ranks: int):
    return [d for d in RANK_COUNTS if d <= ranks]


def rows_over_ranks(args, row, *extra):
    """row(args, mesh, *extra) on a mesh over the first 1, 2, 4, ... ranks
    of the world, the others waiting; the rows of this rank."""
    import torch.distributed as dist
    from ..parallel import make_mesh
    rows = []
    for ndev in rank_counts(dist.get_world_size()):
        mesh = make_mesh(n_dom=ndev, n_chain=1, ranks=ndev)
        if mesh is not None:
            rows.append(row(scaled(args, ndev), mesh, *extra))
        dist.barrier()
    return rows


def kl_basis(a):
    """The --dd-chain arm's sampling basis on a row's mesh (SExp, σ² 1,
    L 0.3, 10 modes at 95% energy), computed once, before the ranks start,
    as the JAX harness's single controller computes it."""
    import torch
    from ..fem import get_mass_matrix
    from ..kl.covariance import make_cov
    from ..kl.single import solve_kl
    fmesh, maps, asm = build_fem(a)
    M = get_mass_matrix(fmesh.cells, fmesh.points, dtype=a.dtype,
                        device=a.device)
    lam, psi = solve_kl(fmesh.cells, fmesh.points, make_cov(a.model, 1.0,
                                                            0.3), 10, M,
                        relative=0.95, generator=torch.Generator(
                            device=a.device).manual_seed(0))
    return host(lam), host(psi)


def timeit(fn, args, reps):
    fn()
    sync(args)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(args)
    return (time.perf_counter() - t0) / reps


def dd_chain_row(a, mesh, bases):
    """One rank count of the --dd-chain arm: the dom-sharded DD chain step
    (P3+P5) with the condensation alone timed apart."""
    import torch
    from .. import dd_chains
    from ..chains import prepare_chain_states
    from ..parallel import psum
    ndev = mesh.n_dom
    fmesh, maps, asm = build_fem(a)
    epart, part, plan = build_dd(a, fmesh, maps)
    lam, psi = bases[ndev]
    t = partial(torch.as_tensor, dtype=a.dtype, device=a.device)
    states = prepare_chain_states(t(lam), t(psi), nchains=1, base_key=3,
                                  device=a.device, dtype=a.dtype)
    step, seed = dd_chains.make_dom_sharded_dd_chain_step(
        mesh, plan, part, nvec=6, spdim=16, maxit=400)
    # the condensation alone: the rank's shard of the assembly plan
    sh = dd_chains.DDShard.of(
        dd_chains.shard_dd_assembly_plan(plan, part, ndev), mesh.index("dom"))
    psum_dom = partial(psum, mesh=mesh, axis="dom")
    rng = np.random.default_rng(0)
    coeff = t(np.exp(0.3 * rng.normal(size=fmesh.nnode)))
    W, it0 = seed(states)
    t_cond = timeit(lambda: dd_chains._local_condense(sh, coeff, psum_dom),
                    a, 5)
    out = [None]

    def run_step():
        out[0] = step(states, W)

    t_step = timeit(run_step, a, 3)
    mesh.psum_sites.clear()            # the psum sites of one step
    run_step()
    calls = sum(mesh.psum_sites.values())
    n_sites = len(mesh.psum_sites)
    its = int(out[0][2][0])
    print(f"ranks={ndev:2d} ndom={a.ndom:3d} nnode={fmesh.nnode:7d} "
          f"condense+NN={t_cond * 1e3:8.1f} ms  full_step="
          f"{t_step * 1e3:8.1f} ms  solve≈{(t_step - t_cond) * 1e3:8.1f}"
          f" ms  its={its:3d}  psum sites/step={n_sites}  psum calls/step="
          f"{calls}  ({sharing(a, ndev)})", flush=True)
    return dict(ranks=ndev, ndom=a.ndom, nnode=fmesh.nnode,
                n_gamma=part.n_gamma, condense_ms=1e3 * t_cond,
                step_ms=1e3 * t_step, its=its, seed_its=int(it0[0]),
                psum_sites=n_sites, psum_calls=calls,
                sharing=sharing(a, ndev))


def dd_chain_rank(args, bases):
    """Weak scaling of the full dom-sharded DD chain step (P3+P5) with a
    per-stage breakdown and the psum sites a step (SURVEY.md §2.2,
    BASELINE.md weak-scaling north star)."""
    import os
    rows = rows_over_ranks(args, dd_chain_row, bases)
    if len(rows) > 1:
        ncore = os.cpu_count() or 1
        print(f"# NOTE: {rows[-1]['sharing']}, on a host of {ncore} cores: "
              f"wall-clock grows with the TOTAL work here, unlike ranks on "
              f"cards of their own. The scaling-relevant invariants this "
              f"run checks:")
        sites = sorted({r["psum_sites"] for r in rows})
        print(f"#  - collective count per step is CONSTANT across rank "
              f"counts: psum sites/step = {sites}")
        print(f"#  - every psum payload is Γ-sized (n_gamma ≈ "
              f"{rows[-1]['n_gamma']}), never volume-sized: the "
              f"payload/work ratio shrinks as ranks grow")
        print(f"#  - per-sample NN iterations grow with ndom (no coarse "
              f"space, as the reference's NN): {[r['its'] for r in rows]}")
        if len(sites) != 1:
            raise RuntimeError(f"psum sites a step differ across rank "
                               f"counts: {[r['psum_sites'] for r in rows]}")
    return rows


def matvec_row(a, mesh):
    """One rank count of the plain arm: reps sharded Schur applies, each
    normalised."""
    import torch
    from ..fem import assemble_dd_values
    from ..fem.schur import prepare_schur_operator
    from ..parallel import sharded_schur_matvec
    ndev = mesh.n_dom
    fmesh, maps, asm = build_fem(a)
    epart, part, plan = build_dd(a, fmesh, maps)
    rng = np.random.default_rng(a.seed)
    coeff = torch.as_tensor(np.exp(rng.normal(size=fmesh.nnode)),
                            dtype=a.dtype, device=a.device)
    blocks = assemble_dd_values(plan, coeff)
    S = prepare_schur_operator(plan, part, *blocks[:3])
    op = sharded_schur_matvec(mesh, S)

    def many(x):
        for _ in range(a.reps):
            y = op(x)
            x = y / torch.linalg.vector_norm(y)
        return x

    x = torch.as_tensor(rng.normal(size=part.n_gamma), dtype=a.dtype,
                        device=a.device)
    float(torch.sum(many(x)))            # warm + honest sync
    calls = mesh.psum_calls
    t0 = time.perf_counter()
    y = many(x)
    float(torch.sum(y))
    dt = (time.perf_counter() - t0) / a.reps
    psums = (mesh.psum_calls - calls) / a.reps
    # weak-scaling work: total interior flops grow with the ranks
    work = float(ndev * a.doms_per_device * part.nI_max ** 2)
    print(f"ranks={ndev:2d} ndom={a.ndom:3d} t/matvec={dt * 1e3:8.2f} ms"
          f"  rate={work / dt / 1e9:8.2f} Gflop-equiv/s  psum calls/matvec="
          f"{psums:g}  ({sharing(a, ndev)})", flush=True)
    return dict(ranks=ndev, ndom=a.ndom, nnode=fmesh.nnode,
                ms_per_matvec=1e3 * dt, rate=work / dt,
                psum_calls_per_matvec=psums, sharing=sharing(a, ndev))


def matvec_rank(args):
    rows = rows_over_ranks(args, matvec_row)
    if len(rows) > 1:
        base = rows[0]["rate"]
        for r in rows:
            r["efficiency"] = r["rate"] / (base * r["ranks"])
            print(f"ranks={r['ranks']:2d}: weak-scaling efficiency "
                  f"{r['efficiency'] * 100:6.1f}%  ({r['sharing']})")
    return rows


def main(argv=None):
    p = add_ranks_flag(base_parser(__doc__))
    p.add_argument("--doms-per-device", type=int, default=4)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--dd-chain", action="store_true",
                   help="weak-scale the FULL dom-sharded DD chain step with "
                        "a per-stage breakdown + psum sites a step")
    args = p.parse_args(argv)
    init_backend(args)
    if args.dd_chain:
        bases = {n: kl_basis(scaled(args, n)) for n in rank_counts(args.ranks)}
        return run_ranks(args, dd_chain_rank, bases)
    return run_ranks(args, matvec_rank)


if __name__ == "__main__":
    main()
