"""Flagship-chain benchmark: time per MCMC realization.

Port of the root `bench_chain.py`. Prints one JSON line with the median
time of a full chain step (RW-Metropolis draw + stencil assembly + recycled
eigDef-PCG solve, its matvec kernel A) over three timed steps after one
warm step, and the steps' iteration counts.

  BENCH_NNODE=250000 BENCH_NVEC=16 python3 krylov_spdes_tpu_torch/bench/bench_chain.py
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def sine_basis(points):
    """KL-like spectral basis: 25 sine modes, λ = exp(−0.2(a² + b²)) (a
    single-domain dense KL is O(n²); the basis' provenance is irrelevant to
    the solver-side timing)."""
    xs, ys = points[:, 0], points[:, 1]
    modes, lams = [], []
    for a in range(1, 6):
        for b_ in range(1, 6):
            modes.append(np.sin(np.pi * a * xs) * np.sin(np.pi * b_ * ys) * 2)
            lams.append(np.exp(-0.2 * (a * a + b_ * b_)))
    return np.asarray(lams), np.stack(modes, 1)


def parse(argv, doc):
    """--cpu (float64 on the CPU; default the card in float32), with the
    device line first."""
    from krylov_spdes_tpu_torch.examples.common import init_backend
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU in float64 (default: the CUDA card "
                        "in float32)")
    args = p.parse_args(argv)
    init_backend(args)
    return args


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.chains import (chain_state, make_chain_step,
                                               prepare_chain_states,
                                               seed_chain)
    from krylov_spdes_tpu_torch.examples.common import sync
    args = parse(argv, __doc__)
    dev, dt = args.device, args.dtype
    nnode = int(os.environ.get("BENCH_NNODE", "250000"))
    nvec = int(os.environ.get("BENCH_NVEC", "16"))
    spdim = max(3 * nvec, 2 * nvec + 1)

    mesh = fem.get_mesh(nnode, seed=0)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    plan = fem.prepare_stencil_assembly(
        mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x,
        dtype=dt, device=dev)
    lam, psi = sine_basis(mesh.points)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    # a single chain, its state taken out of the batched one
    state = chain_state(prepare_chain_states(t(lam), t(psi), nchains=1,
                                             device=dev, dtype=dt), 0)
    step = make_chain_step(plan, nvec=nvec, spdim=spdim, maxit=5000)

    W, it0 = seed_chain(plan, state, nvec=nvec, spdim=spdim, maxit=5000)
    state, W, it, cnt = step(state, W)
    warm_it = int(it)
    times, its = [], []
    for _ in range(3):
        sync(args)
        t0 = time.perf_counter()
        state, W, it, cnt = step(state, W)
        its.append(int(it))
        sync(args)
        times.append(time.perf_counter() - t0)
    dt_step = sorted(times)[1]
    baseline = float(os.environ.get("BENCH_BASELINE", dt_step))
    line = {
        "metric": "chain_time_per_realization",
        "value": round(dt_step * 1e3, 1),
        "unit": "ms",
        "vs_baseline": round(baseline / dt_step, 4),
    }
    print(json.dumps(line))
    print(f"# nnode={nnode} nvec={nvec} spdim={spdim} "
          f"iters_per_sample={its}")
    return dict(line=line, nnode=mesh.nnode, nvec=nvec, spdim=spdim,
                seed_it=int(it0), warm_it=warm_it, iters=its,
                step_ms=[1e3 * s for s in times], maxit=5000)


if __name__ == "__main__":
    main()
