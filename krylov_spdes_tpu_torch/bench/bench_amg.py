"""AMG-PCG benchmark on the Example01 workload (reference:
Example01_EllipticPde.jl:48-66, a 1M-DoF lognormal deterministic solve with
SA-AMG PCG).

Port of the root `bench_amg.py`. Measures, on the card:
  - the device SA-AMG setup time (the whole hierarchy built from the
    stiffness planes: precond/stencil_amg.py),
  - AMG-PCG solve wall-clock + iterations,
  - plain CG wall-clock + iterations on the same operator,
over BENCH_NSOLVE solves with scaled right-hand sides queued one after the
other with one synchronisation at the end (the JAX file's `lax.scan`); the
operator is the stencil SpMV, kernel A.

Prints one JSON line: ms/solve for AMG and CG and the speed-up.

  BENCH_NNODE=1000000 BENCH_NSOLVE=8 python3 krylov_spdes_tpu_torch/bench/bench_amg.py
"""

import json
import os
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench_chain import parse  # noqa: E402

AMG_MAXIT, CG_MAXIT = 400, 8000


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.examples.common import sync
    from krylov_spdes_tpu_torch.ops.stencil import (build_stencil_op,
                                                    to_full_vector)
    from krylov_spdes_tpu_torch.precond.stencil_amg import (_hier_shapes,
                                                            _vcycle,
                                                            stencil_amg_setup)
    from krylov_spdes_tpu_torch.solvers.cg import _cg_impl, _pcg_impl
    args = parse(argv, __doc__)
    dev, dt = args.device, args.dtype

    nnode = int(os.environ.get("BENCH_NNODE", "1000000"))
    nsolve = int(os.environ.get("BENCH_NSOLVE", "8"))
    rtol = float(os.environ.get("BENCH_RTOL", "1e-6"))

    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = fem.prepare_elliptic_assembly(
        mesh.cells, mesh.points, maps, lambda x, y: -1.0 + 0.0 * x,
        lambda x, y: 0.0 * x, dtype=dt, device=dev)
    rng = np.random.default_rng(0)
    coeff = np.exp(0.3 * rng.normal(size=mesh.nnode))
    A, b = fem.do_isotropic_elliptic_assembly(asm, coeff)
    m1 = int(round(np.sqrt(mesh.nnode)))
    St = build_stencil_op(A, maps, (m1, m1))
    b_full = to_full_vector(maps, b, mesh.nnode)
    nnz = A.nnz

    planes = St.planes.clone()
    planes[0] += St.dir_diag
    live = 1.0 - St.dir_diag
    hier = stencil_amg_setup(planes, live, St.H, St.W)     # warm
    sync(args)
    t0 = time.perf_counter()
    hier = stencil_amg_setup(planes, live, St.H, St.W)
    sync(args)
    t_setup = time.perf_counter() - t0

    shapes = _hier_shapes(St.H, St.W, len(hier["levels"]))
    M = partial(_vcycle, 1, 1, shapes, hier)
    scales = torch.linspace(1.0, 2.0, nsolve, dtype=dt, device=dev)
    x0 = torch.zeros_like(b_full)

    def run_amg():
        return [_pcg_impl(St.matvec, M, b_full * s, x0, AMG_MAXIT, rtol)
                for s in scales]

    def run_cg():
        return [_cg_impl(St.matvec, b_full * s, x0, CG_MAXIT, rtol)
                for s in scales]

    def timed(fn):
        fn()                                        # warm
        sync(args)
        t0 = time.perf_counter()
        out = fn()
        sync(args)
        return (time.perf_counter() - t0) / nsolve, out

    ms_amg, out_amg = timed(run_amg)
    ms_cg, out_cg = timed(run_cg)
    it_amg, it_cg = out_amg[-1][1], out_cg[-1][1]

    line = {
        "metric": "amg_pcg_1m",
        "nnode": nnode, "nnz": int(nnz), "rtol": rtol,
        "setup_ms": round(1e3 * t_setup, 2),
        "amg_ms_per_solve": round(1e3 * ms_amg, 2), "amg_iters": it_amg,
        "cg_ms_per_solve": round(1e3 * ms_cg, 2), "cg_iters": it_cg,
        "speedup_vs_cg": round(ms_cg / ms_amg, 2),
        "levels": len(hier["levels"]) + 1,
    }
    print(json.dumps(line))
    return dict(line=line, St=St, b=b_full, M=M, scale=scales[-1],
                rtol=rtol, amg_maxit=AMG_MAXIT, cg_maxit=CG_MAXIT,
                x_amg=out_amg[-1][0], x_cg=out_cg[-1][0],
                amg_its=[o[1] for o in out_amg], cg_its=[o[1] for o in out_cg])


if __name__ == "__main__":
    main()
