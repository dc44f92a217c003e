"""Unstructured-mesh CG matvec: ELL-gather path vs RCM-banded path.

Port of the root `bench_banded.py`: a Delaunay-mesh Jacobi-PCG solve timed
end to end through both operator paths (ops/sparse.py's ELL gather and
ops/banded.py's block-tridiagonal RCM band), reported as µs/iteration and
effective Gnnz/s; then the DD interiors' dense Cholesky against the
RCM-banded factorisation (fem/dd_banded.py) at BENCH_NDOM subdomains, and,
with BENCH_ENVELOPE=1, the whole no-dense-interior pipeline at
BENCH_ENV_NNODE nodes with the card's peak memory.

  BENCH_NNODE=32000 python3 krylov_spdes_tpu_torch/bench/bench_banded.py
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench_chain import parse  # noqa: E402

MAXIT, RTOL = 500, 1e-6


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.examples.common import sync
    from krylov_spdes_tpu_torch.fem.dd_banded import (
        assemble_dd_values_banded, prepare_banded_dd_refill,
        prepare_banded_interiors, prepare_schur_operator_banded,
        prepare_schur_operator_banded_refill)
    from krylov_spdes_tpu_torch.fem.schur import (assemble_local_schurs,
                                                  get_schur_rhs,
                                                  prepare_schur_operator)
    from krylov_spdes_tpu_torch.ops.banded import banded_system
    from krylov_spdes_tpu_torch.solvers.cg import pcg
    args = parse(argv, __doc__)
    dev, dt = args.device, args.dtype
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    fsrc = lambda x, y: -1.0 + 0.0 * x  # noqa: E731
    uex = lambda x, y: 0.0 * x  # noqa: E731

    nnode = int(os.environ.get("BENCH_NNODE", "32000"))
    mesh = fem.get_delaunay_mesh(nnode, seed=0)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, fsrc,
                                        uex, dtype=dt, device=dev)
    rng = np.random.default_rng(0)
    kappa = np.exp(0.4 * rng.normal(size=mesh.nnode))
    A, b = fem.do_isotropic_elliptic_assembly(asm, kappa)
    nnz = A.nnz
    dinv = 1.0 / np.asarray(A.to_scipy().diagonal())

    def timed(fn, label):
        res = fn()
        sync(args)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = fn()
            float(torch.sum(res.x))
            its = int(res.it)
            ts.append(time.perf_counter() - t0)
        dt_s = sorted(ts)[1]
        print(f"# {label}: {dt_s * 1e3:.1f} ms / {its} its = "
              f"{dt_s / its * 1e6:.1f} us/iter "
              f"({nnz * its / dt_s / 1e9:.2f} Gnnz/s effective)")
        return dt_s / its, res

    d_ell = t(dinv)
    t_ell, r_ell = timed(lambda: pcg(A, b, M=lambda r: d_ell * r,
                                     maxit=MAXIT, rtol=RTOL),
                         "ell-gather Jacobi-PCG")

    Aop, bp, unperm, op = banded_system(A, b)
    d_band = t(dinv[op.perm.cpu().numpy()])
    print(f"# banded: bw-block m={op.m}, nb={op.nb} "
          f"({2 * op.nb * op.m * op.m * 4 / 2**20:.0f} MB blocks)")
    t_band, r_band = timed(lambda: pcg(Aop, bp, M=lambda r: d_band * r,
                                       maxit=MAXIT, rtol=RTOL),
                           "rcm-banded Jacobi-PCG")

    baseline = float(os.environ.get("BENCH_BASELINE", t_ell))
    line = {
        "metric": "banded_vs_ell_speedup",
        "value": round(t_ell / t_band, 2),
        "unit": "x",
        "vs_baseline": round(baseline / t_band, 2),
    }
    print(json.dumps(line))
    result = dict(line=line, nnode=mesh.nnode, nnz=int(nnz), maxit=MAXIT,
                  rtol=RTOL, ell_us_per_iter=1e6 * t_ell,
                  banded_us_per_iter=1e6 * t_band, it_ell=int(r_ell.it),
                  it_banded=int(r_band.it), m=op.m, nb=op.nb,
                  x_ell=r_ell.x, x_banded=unperm(r_band.x))

    # --- DD interiors: dense Cholesky vs RCM-banded block-tridiagonal ------
    # (fem/dd_banded.py): the per-realization interior factorisation + the
    # condensation on the same Delaunay mesh, ndom = BENCH_NDOM.
    ndom = int(os.environ.get("BENCH_NDOM", "16"))
    epart, _ = fem.mesh_partition(mesh.cells, mesh.points, ndom,
                                  mesh.cell_neighbors)
    part = fem.set_subdomains(mesh.cells, epart, maps, ndom)
    plan = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part, maps,
                                   fsrc, uex, dtype=dt, device=dev)
    tab = prepare_banded_interiors(mesh.cells, part, plan)
    A_II, A_IG, A_GGd, b_I, b_G = fem.assemble_dd_values(plan, t(kappa))

    def dense_path():
        S = prepare_schur_operator(plan, part, A_II, A_IG, A_GGd)
        return assemble_local_schurs(S)

    def banded_path():
        Sb = prepare_schur_operator_banded(plan, part, A_II, A_IG, A_GGd,
                                           tab)
        return assemble_local_schurs(Sb)

    def timed_raw(fn, label):
        out = fn()
        sync(args)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            float(torch.sum(out))
            ts.append(time.perf_counter() - t0)
        dt_s = sorted(ts)[1]
        print(f"# {label}: {dt_s * 1e3:.1f} ms")
        return dt_s, out

    nI = part.interior_l2g.shape[1]
    print(f"# DD interiors: ndom={ndom} nI={nI} banded m={tab.m} "
          f"nb={tab.nb} (bw max {int(tab.bw.max())})")
    t_dense, Sd_d = timed_raw(dense_path, "dense-interior factor+condense")
    t_bnd, Sd_b = timed_raw(banded_path, "banded-interior factor+condense")
    err = float(torch.max(torch.abs(Sd_b - Sd_d)) / torch.max(torch.abs(Sd_d)))
    dd_line = {
        "metric": "dd_interior_banded_speedup",
        "value": round(t_dense / t_bnd, 2),
        "unit": "x",
        "parity_relerr": round(err, 10),
    }
    print(json.dumps(dd_line))
    result.update(dd_line=dd_line, dd_ndom=ndom, dense_ms=1e3 * t_dense,
                  banded_ms=1e3 * t_bnd)

    # --- memory-envelope datapoint: nI beyond the dense wall ----------------
    # BENCH_ENVELOPE=1 runs the whole no-dense-interior pipeline
    # (prepare_banded_dd_refill -> assemble_dd_values_banded -> banded
    # factorisation -> interface PCG) at BENCH_ENV_NNODE nodes, where the
    # dense (ndom, nI, nI) batch alone would be large, and reports the
    # card's peak memory.
    if os.environ.get("BENCH_ENVELOPE"):
        env_nnode = int(os.environ.get("BENCH_ENV_NNODE", "200000"))
        env_ndom = int(os.environ.get("BENCH_ENV_NDOM", "16"))
        mesh3 = fem.get_delaunay_mesh(env_nnode, seed=0)
        maps3 = fem.get_dirichlet_inds(mesh3.points, mesh3.point_markers)
        epart3, _ = fem.mesh_partition(mesh3.cells, mesh3.points, env_ndom,
                                       mesh3.cell_neighbors)
        part3 = fem.set_subdomains(mesh3.cells, epart3, maps3, env_ndom)
        plan3 = fem.prepare_dd_assembly(mesh3.cells, mesh3.points, epart3,
                                        part3, maps3, fsrc, uex, dtype=dt,
                                        device=dev)
        tab3 = prepare_banded_interiors(mesh3.cells, part3, plan3)
        bplan3 = prepare_banded_dd_refill(plan3, part3, tab3)
        nI3 = part3.interior_l2g.shape[1]
        dense_gb = env_ndom * nI3 * nI3 * 4 / 2**30
        band_gb = 2 * env_ndom * tab3.nb * tab3.m * tab3.m * 4 / 2**30
        print(f"# envelope: nnode={mesh3.nnode} ndom={env_ndom} nI={nI3} "
              f"m={tab3.m} nb={tab3.nb}: dense A_II batch would be "
              f"{dense_gb:.1f} GB; banded (D,E) {band_gb:.2f} GB")
        rngc = np.random.default_rng(1)
        coeff3 = t(np.exp(0.3 * rngc.normal(size=mesh3.nnode)))
        if dev.type == "cuda":
            sync(args)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        D3, E3, A_IG3, A_GG3, b_I3, b_G3 = assemble_dd_values_banded(
            plan3, bplan3, coeff3)
        Sb3 = prepare_schur_operator_banded_refill(plan3, part3, D3, E3,
                                                   A_IG3, A_GG3, tab3)
        b_s3 = get_schur_rhs(Sb3, b_I3, b_G3)
        r3 = pcg(Sb3, b_s3, maxit=200, rtol=1e-5)
        float(torch.sum(r3.x))
        wall = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated(dev) / 2**30
                   if dev.type == "cuda" else 0.0)
        env_line = {
            "metric": "dd_banded_envelope",
            "value": int(nI3),
            "unit": "nI",
            "wall_s": round(wall, 1),
            "interface_its": int(r3.it),
            "peak_device_gb": round(peak_gb, 2),
            "dense_would_need_gb": round(dense_gb, 1),
            "banded_blocks_gb": round(band_gb, 2),
        }
        print(json.dumps(env_line))
        result.update(env_line=env_line)
    return result


if __name__ == "__main__":
    main()
