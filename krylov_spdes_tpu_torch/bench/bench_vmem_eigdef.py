"""Stretch-wise eigDef-PCG (kernel E) against its host-looped twin: µs an
iteration on the card.

Port of the root `bench_vmem_eigdef.py`: the same system (get_mesh at
BENCH_NNODE, a = exp(0.4·N(0,1)) from numpy seed 0), an eigPCG seed of W,
then the solve through `ops/vmem_eigdef.py::vmem_eigdefpcg` (one launch of
kernel E a restart-free stretch) and through `solvers/defcg.py::
_eigdef_impl` (a host loop, its matvec kernel A; the basis in the working
dtype for a like-for-like comparison), each timed as the median of three
after a warm run.

  BENCH_NNODE=65000 BENCH_NVEC=16 python3 krylov_spdes_tpu_torch/bench/bench_vmem_eigdef.py
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench_chain import parse  # noqa: E402

RTOL = 1e-5


def bench_system(args, nnode):
    """The JAX file's system on get_mesh(nnode): (St, b, mdiag_mat) with
    mdiag_mat the matrix diagonal (Dirichlet identity rows included)."""
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.ops.stencil import StencilOp
    mesh = fem.get_mesh(nnode, seed=0)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    plan = fem.prepare_stencil_assembly(
        mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x,
        dtype=args.dtype, device=args.device)
    rng = np.random.default_rng(0)
    g = 0.4 * rng.normal(size=mesh.nnode)
    planes, b = fem.stencil_assemble(plan, torch.exp(torch.as_tensor(
        g, dtype=args.dtype, device=args.device)))
    St = StencilOp(planes=planes, dir_diag=plan.dir_diag,
                   slot=torch.zeros(0, dtype=torch.int64, device=args.device),
                   H=plan.H, W=plan.W)
    return St, b, (planes[0] + plan.dir_diag).reshape(-1)


def seed_basis(St, b, mdiag, nvec, spdim, maxit):
    """W from an eigPCG first solve (the Jacobi M)."""
    import torch
    from krylov_spdes_tpu_torch.solvers.eigcg import _eigpcg_impl
    _, it0, _, W0 = _eigpcg_impl(St.matvec, lambda r: mdiag * r, b,
                                 torch.zeros_like(b), nvec, spdim, maxit,
                                 RTOL)
    return W0, it0


def twin(St, b, W0, mdiag, nvec, spdim, maxit):
    """The host-looped eigDef-PCG on kernel A (fused Jacobi path)."""
    import torch
    from krylov_spdes_tpu_torch.solvers.defcg import _eigdef_impl
    return _eigdef_impl(St.matvec, lambda r: mdiag * r, b,
                        torch.zeros_like(b), W0, nvec, spdim, maxit, RTOL,
                        True, True, mdiag, None)


def main(argv=None):
    from krylov_spdes_tpu_torch.examples.common import sync
    from krylov_spdes_tpu_torch.ops.fused_cg import build_padded_stencil
    from krylov_spdes_tpu_torch.ops.vmem_eigdef import vmem_eigdefpcg
    args = parse(argv, __doc__)
    nnode = int(os.environ.get("BENCH_NNODE", "65000"))
    nvec = int(os.environ.get("BENCH_NVEC", "16"))
    spdim = 3 * nvec
    maxit = int(os.environ.get("BENCH_MAXIT", "400"))

    St, b, mdiag_mat = bench_system(args, nnode)
    mdiag = 1.0 / mdiag_mat
    W0, it0 = seed_basis(St, b, mdiag, nvec, spdim, maxit)

    def timed(fn, label, n=3):
        out = fn()
        sync(args)
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            sync(args)
            its = int(out[1])
            ts.append(time.perf_counter() - t0)
        dt_s = sorted(ts)[n // 2]
        print(f"# {label}: {dt_s * 1e3:.2f} ms / {its} its = "
              f"{dt_s / its * 1e6:.1f} us/iter")
        return dt_s / its, out

    t_twin, out_twin = timed(
        lambda: twin(St, b, W0, mdiag, nvec, spdim, maxit),
        "host-looped eigDef-PCG")
    ps = build_padded_stencil(St)
    t_vmem, out_vmem = timed(
        lambda: vmem_eigdefpcg(ps, b, W0, mdiag_full=mdiag_mat, spdim=spdim,
                               maxit=maxit, rtol=RTOL),
        "stretch kernel E")

    baseline = float(os.environ.get("BENCH_BASELINE", t_twin))
    line = {
        "metric": "vmem_eigdef_us_per_iter",
        "value": round(t_vmem * 1e6, 1),
        "unit": "us",
        "vs_baseline": round(baseline / t_vmem, 3),
    }
    print(json.dumps(line))
    print(f"# speedup vs host-looped twin: {t_twin / t_vmem:.2f}x "
          f"(its twin={int(out_twin[1])} kernel E={int(out_vmem[1])})")
    return dict(line=line, nvec=nvec, spdim=spdim, maxit=maxit, rtol=RTOL,
                seed_it=int(it0), it_twin=int(out_twin[1]),
                it_vmem=int(out_vmem[1]), x_twin=out_twin[0],
                x_vmem=out_vmem[0], twin_us_per_iter=1e6 * t_twin,
                vmem_us_per_iter=1e6 * t_vmem, St=St, b=b, W0=W0,
                mdiag=mdiag)


if __name__ == "__main__":
    main()
