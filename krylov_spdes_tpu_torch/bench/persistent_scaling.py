"""Time an iteration of the persistent kernels E and H on one GPU against
the number of deflation vectors (E) and the grid (H).

    python3 krylov_spdes_tpu_torch/bench/persistent_scaling.py

E: one stretch of eigDef-PCG on the 250k-node bench system (bench.py's
coefficient exp(0.3·N(0,1)), numpy seed 0) with a random orthonormal basis
of nvec = 1 … 24 vectors; µs an iteration from a full stretch less a
one-iteration stretch. H: 200 fixed iterations (tol 0) less 10 on random
diagonally dominant 9-point operators from 132 × 32 (one row a block: the
barriers alone) to 1000 × 1000. CUDA-event times; one JSON line per case,
each with the kernel's shared-memory plan.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch import fem  # noqa: E402
from krylov_spdes_tpu_torch.ops import fused_cg as fc  # noqa: E402
from krylov_spdes_tpu_torch.ops import pallas_cg as pc  # noqa: E402
from krylov_spdes_tpu_torch.ops import vmem_eigdef as ve  # noqa: E402
from krylov_spdes_tpu_torch.ops.stencil import (StencilOp,  # noqa: E402
                                                build_stencil_op,
                                                to_full_vector)


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bench_system(nn=250000):
    m = fem.get_mesh(nn)
    maps = fem.get_dirichlet_inds(m.points, m.point_markers)
    asm = fem.prepare_elliptic_assembly(m.cells, m.points, maps,
                                        lambda x, y: -1.0 + 0 * x,
                                        lambda x, y: 0 * x)
    A, b = fem.do_isotropic_elliptic_assembly(
        asm, np.exp(0.3 * np.random.default_rng(0).normal(size=m.nnode)))
    h = int(round(np.sqrt(m.nnode)))
    return build_stencil_op(A, maps, (h, h)), to_full_vector(maps, b, m.nnode)


def stretch_case(ps, minv, bp, St, nvec, gen):
    """Operands of a first stretch with a random basis of nvec vectors."""
    free = (St.dir_diag.reshape(-1, 1) == 0).to(bp.dtype)
    W = torch.linalg.qr(torch.randn(St.n, nvec, generator=gen,
                                    device=bp.device, dtype=bp.dtype) * free)[0]
    return ve.stretch_operands(ps, minv, bp, torch.stack(
        [fc.pad_vec(ps, w) for w in W.T.contiguous()]))


def run_stretch(ps, minv, o, V, nsteps, nvec):
    tol2 = V.new_zeros(())
    return ve.stretch(ps, minv, o["G"], o["Ac"], o["Bc"], o["x"].clone(),
                      o["r"].clone(), o["p"].clone(), V, tol2, o["rTz"],
                      o["rTr"], nsteps, nvec)


def main():
    card = torch.cuda.get_device_name(0)
    St, b = bench_system()
    ps = fc.build_padded_stencil(St)
    bp = fc.pad_vec(ps, b)
    minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for nvec in (1, 2, 4, 8, 16, 24):
        o = stretch_case(ps, minv, bp, St, nvec, gen)
        spdim = 2 * nvec + 33
        full = spdim - 1 - nvec
        V = bp.new_zeros((spdim, ps.R, ps.C))
        t = ms(lambda: run_stretch(ps, minv, o, V, full, nvec))
        t1 = ms(lambda: run_stretch(ps, minv, o, V, 1, nvec))
        print(json.dumps(dict(kernel="E", nvec=nvec, iterations=full,
                              us_per_iteration=1e3 * (t - t1) / (full - 1),
                              plan=vars(ve.plan_for(ps, bp, nvec)),
                              card=card)), flush=True)
    rng = np.random.default_rng(1)
    for H, W in ((132, 32), (132, 128), (264, 256), (500, 500), (1000, 1000)):
        planes = torch.tensor(rng.normal(size=(9, H, W)) * 0.01,
                              dtype=torch.float32, device="cuda")
        planes[0] += 1.0
        S = StencilOp(planes=planes, dir_diag=torch.zeros(H, W, device="cuda"),
                      slot=torch.zeros(0, dtype=torch.int64, device="cuda"),
                      H=H, W=W)
        rhs = torch.ones(H * W, device="cuda")
        t11 = ms(lambda: pc.stencil_cg(S, rhs, 11, 0.0), 3)
        t211 = ms(lambda: pc.stencil_cg(S, rhs, 211, 0.0), 3)
        print(json.dumps(dict(kernel="H", grid=[H, W],
                              us_per_iteration=1e3 * (t211 - t11) / 200,
                              plan=vars(pc.plan_for(rhs, H, W)), card=card)),
              flush=True)


if __name__ == "__main__":
    main()
