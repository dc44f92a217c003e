"""DD-flagship benchmark: time per MCMC realization of the Schur-DD
recycled chain (Example09 recycled chains composed with Example07 Schur
operators, reference Example09..._Functions.jl:139-509 x
Example07:86-424).

Port of the root `bench_dd_chain.py`. Prints one JSON line with the
median time of a full DD chain step (RW-Metropolis draw + batched DD block
refill + interior Cholesky + Schur condensation + NN preconditioner +
recycled eigDef-PCG on the interface system), after four warm-up steps,
plus a per-stage breakdown comment. BENCH_PLAN=stencil|scatter picks the
refill; BENCH_NCHAINS > 1 times the batched multi-chain step instead.

  BENCH_NNODE=65000 BENCH_NDOM=32 BENCH_NVEC=16 python3 krylov_spdes_tpu_torch/bench/bench_dd_chain.py
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench_chain import parse, sine_basis  # noqa: E402


def _timeit(fn, sync, n=3):
    fn()                       # warm
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2]


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.chains import chain_state, prepare_chain_states
    from krylov_spdes_tpu_torch.dd_chains import (dd_solve_operands,
                                                  make_batched_dd_chain_step,
                                                  make_dd_chain_step,
                                                  seed_dd_chain,
                                                  seed_dd_chains_batched)
    from krylov_spdes_tpu_torch.examples.common import sync as sync_args
    from krylov_spdes_tpu_torch.fem.schur import (
        assemble_local_schurs, prepare_neumann_neumann_schur_precond)
    args = parse(argv, __doc__)
    dev, dt = args.device, args.dtype
    sync = lambda: sync_args(args)  # noqa: E731
    nnode = int(os.environ.get("BENCH_NNODE", "65000"))
    ndom = int(os.environ.get("BENCH_NDOM", "32"))
    nvec = int(os.environ.get("BENCH_NVEC", "16"))
    spdim = max(3 * nvec, 2 * nvec + 1)
    maxit = int(os.environ.get("BENCH_MAXIT", "500"))
    kind = os.environ.get("BENCH_PLAN", "stencil")  # stencil | scatter

    mesh = fem.get_mesh(nnode, seed=0)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    fsrc = lambda x, y: -1.0 + 0.0 * x  # noqa: E731
    uex = lambda x, y: 0.0 * x  # noqa: E731
    if kind == "stencil":
        epart, part, plan = fem.prepare_dd_stencil_assembly(
            mesh, maps, fsrc, uex, ndom, dtype=dt, device=dev)
        assemble = fem.assemble_dd_values_stencil
    else:
        epart, _ = fem.mesh_partition(mesh.cells, mesh.points, ndom,
                                      mesh.cell_neighbors)
        part = fem.set_subdomains(mesh.cells, epart, maps, ndom)
        plan = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part,
                                       maps, fsrc, uex, dtype=dt, device=dev)
        assemble = fem.assemble_dd_values
    lam, psi = sine_basis(mesh.points)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    print(f"# ndom={ndom} nI={plan.nI} nG={plan.nG} n_gamma={plan.n_gamma} "
          f"contribs={plan.kflat.shape[0]}")

    # --- per-stage breakdown -------------------------------------------------
    states = prepare_chain_states(t(lam), t(psi), nchains=1, device=dev,
                                  dtype=dt)
    state = chain_state(states, 0)
    coeff = torch.exp(state.g)
    out = {}

    def refill():
        out["blk"] = assemble(plan, coeff)

    def condense():
        out["S"], out["bs"], _ = dd_solve_operands(plan, part, coeff)
        out["Sd"] = assemble_local_schurs(out["S"])

    def nn():
        out["M"] = prepare_neumann_neumann_schur_precond(out["S"],
                                                         Sd=out["Sd"])

    t_refill = _timeit(refill, sync)
    t_cond = _timeit(condense, sync)
    t_nn = _timeit(nn, sync)
    result = dict(nnode=mesh.nnode, ndom=ndom, plan=kind, nvec=nvec,
                  spdim=spdim, maxit=maxit, n_gamma=plan.n_gamma,
                  refill_ms=1e3 * t_refill, condense_ms=1e3 * t_cond,
                  nn_ms=1e3 * t_nn)

    # --- batched multi-chain layout (BENCH_NCHAINS > 1) ----------------------
    nchains = int(os.environ.get("BENCH_NCHAINS", "1"))
    if nchains > 1:
        states = prepare_chain_states(t(lam), t(psi), nchains=nchains,
                                      device=dev, dtype=dt)
        W, its0 = seed_dd_chains_batched(plan, part, states, nvec, spdim,
                                         maxit)
        step = make_batched_dd_chain_step(plan, part, nvec=nvec, spdim=spdim,
                                          maxit=maxit)
        warm_its = []
        for _ in range(4):
            states, W, its, cnt = step(states, W)
            warm_its.append(its.tolist())
        times, its_l = [], []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            states, W, its, cnt = step(states, W)
            its_l.append(its.tolist())
            sync()
            times.append(time.perf_counter() - t0)
        dt_step = sorted(times)[len(times) // 2] / nchains
        baseline = float(os.environ.get("BENCH_BASELINE", dt_step))
        line = {
            "metric": "dd_chain_time_per_realization",
            "value": round(dt_step * 1e3, 1),
            "unit": "ms",
            "vs_baseline": round(baseline / dt_step, 4),
        }
        print(json.dumps(line))
        print(f"# batched layout: {nchains} chains; iters/sample={its_l} "
              f"(warmup {warm_its}) seed_its={its0.tolist()}")
        return dict(result, line=line, nchains=nchains, iters=its_l,
                    warm_iters=warm_its, seed_its=its0.tolist(),
                    step_ms=[1e3 * s for s in times])

    # --- full chain step ------------------------------------------------------
    step = make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim, maxit=maxit)
    W, it0, _ = seed_dd_chain(plan, part, state, nvec, spdim, maxit)
    # the field of every solve (the seed's, the warm-up's, the timed ones)
    fields = [state.g.cpu()]
    # recycling warm-up: the deflation basis takes ~3-4 samples to capture
    # the Schur operator's low modes; steady state is what a chain of
    # thousands of samples runs at
    warm_its = []
    for _ in range(4):
        state, W, it, cnt = step(state, W)
        warm_its.append(int(it))
        fields.append(state.g.cpu())
    times, its = [], []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        state, W, it, cnt = step(state, W)
        its.append(int(it))
        sync()
        times.append(time.perf_counter() - t0)
        fields.append(state.g.cpu())
    dt_step = sorted(times)[len(times) // 2]
    baseline = float(os.environ.get("BENCH_BASELINE", dt_step))
    line = {
        "metric": "dd_chain_time_per_realization",
        "value": round(dt_step * 1e3, 1),
        "unit": "ms",
        "vs_baseline": round(baseline / dt_step, 4),
    }
    print(json.dumps(line))
    print(f"# breakdown: refill={t_refill * 1e3:.1f}ms "
          f"condense(incl refill+chol)={t_cond * 1e3:.1f}ms "
          f"nn_pinv={t_nn * 1e3:.1f}ms; iters/sample={its} "
          f"(warmup {warm_its}) seed_it={int(it0)}")
    return dict(result, line=line, nchains=1, iters=its, warm_iters=warm_its,
                seed_it=int(it0), step_ms=[1e3 * s for s in times],
                its_all=[int(it0)] + warm_its + its, fields=fields,
                plan=plan, part=part)


if __name__ == "__main__":
    main()
