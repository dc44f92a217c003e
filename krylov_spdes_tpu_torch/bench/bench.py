"""Headline benchmark: SpMV throughput through whole CG solves, the
certified 1e-7 solve and the Schur-DD protocol step.

Port of the root `bench.py`. Prints one JSON line under its keys
(`bench.py:143-157`):

- `value` (Gnnz/s): nnz × Σ its / wall time over NSOLVE whole CG solves
  launched back to back, each one launch of kernel C (`ops/fused_cg.py`
  `whole_cg`, the whole-solve route `path` names "vmem" as the JAX file
  does) on the 500 × 500 bench system (`bench.py:43-64`: get_mesh(nnode),
  a = exp(0.3·N(0, 1)) from numpy seed 0, rtol 1e-6, maxit 2000). Solve k
  takes b·(s_k + 1e-30·Σx_{k-1}), s = linspace(1, 2, NSOLVE), and its
  tolerance rtol²·bₖᵀbₖ as a device tensor, so the NSOLVE solves run with
  no host read between them and one readback at the end: the JAX file's
  `lax.scan` (`bench.py:66-93`). One warm run, then the median of 3. A
  failure of kernel C raises: there is no second path.
- `certified_relres_1e-7`, `certified_iters`, `refine_sweeps`: the
  iteratively refined Jacobi-PCG certified at 1e-7 (inner rtol 1e-5,
  `bench.py:107-122`), in float32 only, as the JAX file (null, -1, -1 in
  float64). Its wall time is printed on the `# certified:` line before
  the JSON.
- `dd_chain_ms_per_real`: the median of 5 timed steps (after a seed and 4
  warm-up steps) of one Schur-DD recycled chain at the protocol
  configuration (`bench.py:124-139`, `:160-213`: get_mesh(32000, seed=0),
  30 tiles, the 25-mode sine basis, nvec 30, spdim max(3·ndom, 2·nvec +
  1), maxit 500). BENCH_SKIP_DD=1 skips it (null); otherwise a failure
  raises.

`vs_baseline` and `dd_chain_vs_baseline` divide by BENCH_BASELINE (nnz/s)
and BENCH_DD_BASELINE (ms), which default to this run's own values.

  python3 krylov_spdes_tpu_torch/bench/bench.py          # the card, float32
  BENCH_NNODE=2500 BENCH_SKIP_DD=1 python3 krylov_spdes_tpu_torch/bench/bench.py --cpu
"""

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench_chain import parse, sine_basis  # noqa: E402

MAXIT, RTOL = 2000, 1e-6


def bench_system(dev, dt, nnode):
    """bench.py:43-64's system, assembled on the host in dt and moved to
    dev: (StencilOp, full-grid b, the free-node matrix's nnz)."""
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.ops.stencil import (build_stencil_op,
                                                    to_full_vector)
    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = fem.prepare_elliptic_assembly(
        mesh.cells, mesh.points, maps, lambda x, y: -1.0 + 0.0 * x,
        lambda x, y: 0.0 * x, dtype=dt, device="cpu")
    coeff = np.exp(0.3 * np.random.default_rng(0).normal(size=mesh.nnode))
    A, b = fem.do_isotropic_elliptic_assembly(asm, coeff)
    m1 = int(round(np.sqrt(mesh.nnode)))
    St = build_stencil_op(A, maps, (m1, m1))
    b_full = to_full_vector(maps, b, mesh.nnode)
    St = dataclasses.replace(St, planes=St.planes.to(dev),
                             dir_diag=St.dir_diag.to(dev),
                             slot=St.slot.to(dev))
    return St, b_full.to(dev), A.nnz


def scaled_solves(ps, bp, scales, maxit, rtol):
    """bench.py:74-80's scan: solve k through kernel C on bp·(s_k + 1e-30·
    carry), carry the previous solve's Σx, tolerance rtol²·bₖᵀbₖ. Nothing
    is read back: returns (the last carry, its (nsolve,) int32, the xs,
    the bₖ), all on bp's device."""
    import torch
    from krylov_spdes_tpu_torch.ops import fused_cg
    carry = bp.new_zeros(())
    its, xs, bks = [], [], []
    for k in range(scales.shape[0]):
        bk = bp * (scales[k] + 1e-30 * carry)
        x, it, _ = fused_cg.whole_cg(ps, bk, maxit,
                                     rtol ** 2 * torch.sum(bk * bk))
        carry = torch.sum(x)
        its.append(it)
        xs.append(x)
        bks.append(bk)
    return carry, torch.stack(its), xs, bks


def certified(St, b_full, maxit=MAXIT):
    """bench.py:113-122's certified solve: refined Jacobi-PCG to 1e-7,
    inner rtol 1e-5 (kernel A under the inner PCG on the card)."""
    from krylov_spdes_tpu_torch.solvers.refine import refined_pcg
    dinv = 1.0 / St.diagonal()
    return refined_pcg(St, b_full, M=lambda r: dinv * r, rtol=1e-7,
                       inner_rtol=1e-5, inner_maxit=maxit)


def dd_sizes():
    """bench.py:168-172's BENCH_DD_* sizes: (nnode, ndom, nvec, spdim,
    maxit) and their `dd_chain_config` name."""
    nnode = int(os.environ.get("BENCH_DD_NNODE", "32000"))
    ndom = int(os.environ.get("BENCH_DD_NDOM", "30"))
    nvec = int(os.environ.get("BENCH_DD_NVEC", "30"))
    spdim = max(3 * ndom, 2 * nvec + 1)
    maxit = int(os.environ.get("BENCH_DD_MAXIT", "500"))
    return ((nnode, ndom, nvec, spdim, maxit),
            f"{nnode // 1000}k/ndom{ndom}/nvec{nvec}/spdim{spdim}")


def dd_protocol(args):
    """bench.py:160-213: one DD chain at the protocol configuration, a seed
    solve, 4 warm-up and 5 timed steps. Returns the median ms, the `it` of
    every solve, and the chain's last state, basis and step."""
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.chains import chain_state, prepare_chain_states
    from krylov_spdes_tpu_torch.dd_chains import (make_dd_chain_step,
                                                  seed_dd_chain)
    from krylov_spdes_tpu_torch.examples.common import sync
    dev, dt = args.device, args.dtype
    (nnode, ndom, nvec, spdim, maxit), config = dd_sizes()

    mesh = fem.get_mesh(nnode, seed=0)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    _, part, plan = fem.prepare_dd_stencil_assembly(
        mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x,
        ndom, dtype=dt, device=dev)
    lam, psi = sine_basis(mesh.points)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    state = chain_state(prepare_chain_states(t(lam), t(psi), nchains=1,
                                             device=dev, dtype=dt), 0)
    step = make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim, maxit=maxit)
    W, it0, _ = seed_dd_chain(plan, part, state, nvec, spdim, maxit)
    its = [int(it0)]
    for _ in range(4):          # recycling warm-up to steady state
        state, W, it, _ = step(state, W)
        its.append(int(it))
    times = []
    for _ in range(5):
        sync(args)
        t0 = time.perf_counter()
        state, W, it, _ = step(state, W)
        its.append(int(it))
        sync(args)
        times.append(time.perf_counter() - t0)
    return dict(ms=sorted(times)[len(times) // 2] * 1e3,
                step_ms=[1e3 * s for s in times], its=its, maxit=maxit,
                config=config, n_gamma=plan.n_gamma, state=state, W=W,
                step=step)


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch.examples.common import sync
    from krylov_spdes_tpu_torch.ops.fused_cg import (build_padded_stencil,
                                                     pad_vec)
    args = parse(argv, __doc__)
    dev, dt = args.device, args.dtype
    nnode = int(os.environ.get("BENCH_NNODE", "250000"))
    nsolve = int(os.environ.get("BENCH_NSOLVE", "8"))

    St, b_full, nnz = bench_system(dev, dt, nnode)
    ps = build_padded_stencil(St)
    bp = pad_vec(ps, b_full)
    scales = torch.linspace(1.0, 2.0, nsolve, dtype=dt, device=dev)
    last = scaled_solves(ps, bp, scales, MAXIT, RTOL)[0]     # warm
    float(last)
    times, enqueue = [], []
    for _ in range(3):
        sync(args)
        t0 = time.perf_counter()
        last, its, xs, bks = scaled_solves(ps, bp, scales, MAXIT, RTOL)
        enqueue.append(time.perf_counter() - t0)
        float(last)
        sync(args)
        times.append(time.perf_counter() - t0)
    dt_solves = sorted(times)[1]
    its = its.tolist()
    nnz_per_s = nnz * sum(its) / dt_solves
    print(f"# cg_spmv: nnode={St.n} nnz={nnz} K={ps.K} nsolve={nsolve} "
          f"its={its} ms={[round(1e3 * s, 3) for s in times]}")

    cert = cert_ms = cert_res = None
    if dt == torch.float32:
        sync(args)
        t0 = time.perf_counter()
        cert = certified(St, b_full)
        sync(args)
        cert_ms = 1e3 * (time.perf_counter() - t0)
        print(f"# certified: {cert_ms:.1f} ms / {int(cert.it)} its / "
              f"{cert.refines} sweeps")
        cert_res = float(cert.res_norm[0] / torch.linalg.vector_norm(b_full))

    dd, config = None, dd_sizes()[1]
    if os.environ.get("BENCH_SKIP_DD", "0") != "1":
        dd = dd_protocol(args)
        dd_base = float(os.environ.get("BENCH_DD_BASELINE", dd["ms"]))
        dd["vs"] = round(dd_base / dd["ms"], 4) if dd_base > 0 else 1.0
        print(f"# dd_chain: {config} n_gamma={dd['n_gamma']} "
              f"its={dd['its']} step_ms={[round(s, 1) for s in dd['step_ms']]}")

    baseline = float(os.environ.get("BENCH_BASELINE", nnz_per_s))
    line = {
        "metric": "cg_spmv_throughput",
        "value": round(nnz_per_s / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(nnz_per_s / baseline, 4),
        "certified_relres_1e-7": (round(cert_res, 10) if cert is not None
                                  else None),
        "certified_iters": int(cert.it) if cert is not None else -1,
        "refine_sweeps": cert.refines if cert is not None else -1,
        "path": "vmem",
        "dd_chain_ms_per_real": round(dd["ms"], 1) if dd else None,
        "dd_chain_config": config,
        "dd_chain_vs_baseline": dd["vs"] if dd else None,
    }
    print(json.dumps(line))
    return dict(line=line, nnz=nnz, nsolve=nsolve, maxit=MAXIT, rtol=RTOL,
                its=its, solve_ms=[1e3 * s for s in times],
                enqueue_ms=[1e3 * s for s in enqueue], St=St, b=b_full,
                ps=ps, bp=bp, xs=xs, bks=bks, cert=cert, cert_ms=cert_ms,
                dd=dd)


if __name__ == "__main__":
    main()
