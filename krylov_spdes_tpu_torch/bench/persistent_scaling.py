"""Time an iteration of the persistent kernels on one GPU: E against the
number of deflation vectors, the whole-solve CG kernels C, D and H against
the grid and the dtype.

    python3 krylov_spdes_tpu_torch/bench/persistent_scaling.py

E: one stretch of eigDef-PCG on the 250k-node bench system (bench.py's
coefficient exp(0.3·N(0,1)), numpy seed 0) with a random orthonormal basis
of nvec = 1 … 24 vectors; µs an iteration from a full stretch less a
one-iteration stretch. C, D, H: 200 fixed iterations (tol 0) less 10 on the
9-point operator with bonds −1 and diagonal 8.001 (symmetric positive
definite, K = 5 on the padded layout; CG does not reach rounding level in
211 iterations, `it` is printed), float32 and float64, from 132 × 32 (one
row a block: the barriers alone) to 1000 × 1000. CUDA-event times; one JSON
line per case, each with the kernel's shared-memory plan.
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
from krylov_spdes_tpu_torch.ops.stencil import (OFFSETS,  # noqa: E402
                                                StencilOp, build_stencil_op,
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


def model_stencil(H, W, dtype):
    """Bonds −1 to the eight neighbours inside the grid, diagonal 8.001."""
    planes = torch.zeros(9, H, W, dtype=dtype, device="cuda")
    planes[0] = 8.001
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        planes[k, max(0, -di):H - max(0, di), max(0, -dj):W - max(0, dj)] = -1.0
    return StencilOp(planes=planes, dir_diag=torch.zeros_like(planes[0]),
                     slot=torch.zeros(0, dtype=torch.int64, device="cuda"),
                     H=H, W=W)


def run_cg_kernels(card):
    for dtype in (torch.float32, torch.float64):
        for H, W in ((132, 32), (64, 64), (132, 128), (264, 256), (368, 368),
                     (500, 500), (1000, 1000)):
            S = model_stencil(H, W, dtype)
            rhs = torch.ones(H * W, dtype=dtype, device="cuda")
            ps = fc.build_padded_stencil(S)
            bp = fc.pad_vec(ps, rhs)
            minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
            zero = bp.new_zeros(())
            for kernel, solve, plan in (
                    ("C", lambda m: fc.whole_cg(ps, bp, m, zero),
                     fc.plan_for(ps, bp, False)),
                    ("D", lambda m: fc.whole_pcg(ps, minv, bp, m, zero),
                     fc.plan_for(ps, bp, True)),
                    ("H", lambda m: pc.stencil_cg(S, rhs, m, 0.0),
                     pc.plan_for(rhs, H, W))):
                t11 = ms(lambda: solve(11), 3)
                t211 = ms(lambda: solve(211), 3)
                print(json.dumps(dict(kernel=kernel, grid=[H, W], K=ps.K,
                                      dtype=str(dtype).split(".")[-1],
                                      it=int(solve(211)[1]),
                                      us_per_iteration=1e3 * (t211 - t11) / 200,
                                      plan=vars(plan), card=card)), flush=True)


def run_stretch_sweep(card):
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


def main():
    card = torch.cuda.get_device_name(0)
    run_stretch_sweep(card)
    run_cg_kernels(card)


if __name__ == "__main__":
    main()
