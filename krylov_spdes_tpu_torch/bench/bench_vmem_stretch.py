"""Isolate the per-stretch fixed cost of kernel E (the eigDef-PCG stretch).

Port of the root `bench_vmem_stretch.py`. Times `ops/vmem_eigdef.py::
stretch` standalone over an nsteps sweep (30 queued calls a point, each on
fresh copies of the same start operands, one read-back), then fits
    t(nsteps) = fixed + nsteps * per_iter.
If `fixed` dominates, the lever is a longer stretch (bigger spdim); the
probe cross-checks by timing the full solver at spdim = 3·nvec and 5·nvec
(both legal: spdim >= 2·nvec+1, defcg.jl:313-473 treats spdim as a free
parameter) beside the host-looped twin. The stretch operands are the
coefficient form kernel E reads (Ac, Bc from `stretch_operands`), not the
JAX kernel's A1 and B.

  BENCH_NNODE=65000 BENCH_NVEC=16 python3 krylov_spdes_tpu_torch/bench/bench_vmem_stretch.py
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench_chain import parse  # noqa: E402
from krylov_spdes_tpu_torch.bench.bench_vmem_eigdef import (  # noqa: E402
    RTOL, bench_system, seed_basis, twin)

NSTEPS = (1, 3, 7, 15, 31, 46)
NQ = 30          # queued calls a timed pass


def stretch_start(ps, minv, bp, Wp, spdim):
    """One stretch's operands as `_vmem_eigdef_impl` builds them, with V
    holding W and the first Lanczos column, and a tolerance never met (so
    every call runs all its nsteps)."""
    import torch
    from krylov_spdes_tpu_torch.ops.vmem_eigdef import stretch_operands
    nvec = Wp.shape[0]
    ops = stretch_operands(ps, minv, bp, Wp)
    V = bp.new_zeros((spdim, ps.R, ps.C))
    V[:nvec] = Wp
    V[nvec] = ops["z"] / torch.sqrt(ops["rTz"])
    tol2 = torch.tensor(1e-30, dtype=bp.dtype, device=bp.device)
    return ops, V, tol2


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch.examples.common import sync
    from krylov_spdes_tpu_torch.ops.fused_cg import (ROW0, _jacobi_minv,
                                                     _unblock_planes,
                                                     build_padded_stencil,
                                                     pad_vec)
    from krylov_spdes_tpu_torch.ops.vmem_eigdef import stretch, vmem_eigdefpcg
    args = parse(argv, __doc__)
    nnode = int(os.environ.get("BENCH_NNODE", "65000"))
    nvec = int(os.environ.get("BENCH_NVEC", "16"))
    spdim = 3 * nvec

    St, b, mdiag_mat = bench_system(args, nnode)
    mdiag = 1.0 / mdiag_mat
    W0, _ = seed_basis(St, b, mdiag, nvec, spdim, 400)

    # ---- one stretch's operands, as _vmem_eigdef_impl builds them ---------
    ps = build_padded_stencil(St)
    bp = pad_vec(ps, b)
    minv = _jacobi_minv(ps, _unblock_planes(ps), mdiag_mat).to(bp.dtype)
    Wp = bp.new_zeros((nvec, ps.R, ps.C))
    Wp[:, ROW0:ROW0 + ps.H, :ps.W] = W0.T.reshape(nvec, ps.H, ps.W)
    ops, V, tol2 = stretch_start(ps, minv, bp, Wp, spdim)
    start = (ops["x"], ops["r"], ops["p"], V)
    calls = [0]

    def call(x, r, p, Vc, nsteps):
        calls[0] += 1
        return stretch(ps, minv, ops["G"], ops["Ac"], ops["Bc"], x, r, p, Vc,
                       tol2, ops["rTz"], ops["rTr"], nsteps, 0)

    def time_stretch(nsteps):
        # the kernel updates x, r, p and V in place: every call gets fresh
        # copies of the same start, made before the clock starts
        out = call(*(a.clone() for a in start), nsteps)
        float(torch.sum(out[0]))                    # warm + force
        ts = []
        for _ in range(3):
            copies = [[a.clone() for a in start] for _ in range(NQ)]
            sync(args)
            t0 = time.perf_counter()
            for c in copies:
                last = call(*c, nsteps)
            float(torch.sum(last[0]))
            ts.append((time.perf_counter() - t0) / NQ)
            del copies
        return sorted(ts)[1], int(last[7])

    sweep = {}
    # a stretch from ivec 0 fills at most spdim - 1 columns of V (all six
    # points at the default nvec 16)
    for nsteps in [n for n in NSTEPS if n <= spdim - 1]:
        dt_s, cnt = time_stretch(nsteps)
        sweep[nsteps] = dt_s
        print(f"# stretch nsteps={nsteps:3d}: {dt_s * 1e6:9.1f} us/call "
              f"({dt_s / nsteps * 1e6:8.1f} us/iter, ran {cnt})")
    ns = np.array(sorted(sweep))
    tt = np.array([sweep[k] for k in ns])
    slope, fixed = np.polyfit(ns, tt, 1)
    print(f"# linear fit: fixed {fixed * 1e6:.1f} us/stretch + "
          f"{slope * 1e6:.2f} us/iter")

    # ---- full solver at two spdim values + the host-looped twin ------------
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

    results, solves = {}, {}
    for sp in (3 * nvec, 5 * nvec):
        results[f"vmem_sp{sp}"], solves[f"vmem_sp{sp}"] = timed(
            lambda sp=sp: vmem_eigdefpcg(ps, b, W0, mdiag_full=mdiag_mat,
                                         spdim=sp, maxit=400, rtol=RTOL),
            f"stretch kernel E solver spdim={sp}")
        results[f"twin_sp{sp}"], solves[f"twin_sp{sp}"] = timed(
            lambda sp=sp: twin(St, b, W0, mdiag, nvec, sp, 400),
            f"host-looped twin spdim={sp}")

    line = {
        "metric": "vmem_stretch_fixed_overhead_us",
        "value": round(float(fixed) * 1e6, 1),
        "unit": "us",
        "vs_baseline": round(float(slope) * 1e6, 2),
    }
    print(json.dumps(line))
    return dict(line=line, nvec=nvec, spdim=spdim, maxit=400, rtol=RTOL,
                sweep_us={k: 1e6 * v for k, v in sweep.items()},
                fixed_us=1e6 * float(fixed), per_iter_us=1e6 * float(slope),
                sweep_calls=calls[0], nq=NQ, nsteps=sorted(sweep),
                us_per_iter={k: 1e6 * v for k, v in results.items()},
                its={k: int(o[1]) for k, o in solves.items()},
                x={k: o[0] for k, o in solves.items()}, St=St, b=b, W0=W0,
                mdiag=mdiag)


if __name__ == "__main__":
    main()
