"""Example01: deterministic elliptic solve with AMG-PCG.

Port of `examples/ex01_elliptic_pde.py` (reference
Example01_EllipticPde.jl:48-66): assemble, solve with smoothed-aggregation
AMG-preconditioned CG, re-insert Dirichlet values, persist the solution.
"""

from __future__ import annotations

import numpy as np

from .common import base_parser, build_fem, init_backend, save_npz, uex


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--precond", default="amg",
                   choices=["amg", "stencil-amg"],
                   help="amg: host SA-AMG setup + ELL V-cycle (any mesh); "
                        "stencil-amg: all-stencil SA-AMG, setup AND apply "
                        "on the device, the CG matvec kernel A (structured "
                        "meshes)")
    p.add_argument("--op", default="ell", choices=["ell", "banded"],
                   help="CG matvec path: ell (general gather SpMV) or "
                        "banded (RCM block-tridiagonal, batched dense "
                        "blocks: the fast matvec for --mesh delaunay)")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import append_bc, do_isotropic_elliptic_assembly
    from ..precond.amg import amg_precond
    from ..solvers.cg import pcg
    from ..utils.metrics import PhaseMetrics

    m = PhaseMetrics(device=device)
    mesh, maps, asm = build_fem(args)
    with m.phase("assembly"):
        A, b = do_isotropic_elliptic_assembly(asm, np.ones(mesh.nnode))
    if args.precond == "stencil-amg":
        from ..ops.stencil import (build_stencil_op, to_free_vector,
                                   to_full_vector)
        from ..precond.stencil_amg import stencil_amg_precond
        m1 = int(round(np.sqrt(mesh.nnode)))
        St = build_stencil_op(A, maps, (m1, m1))
        with m.phase("amg_setup"):
            M = stencil_amg_precond(St)
        with m.phase("pcg", nnz=A.nnz):
            res = pcg(St, to_full_vector(maps, b, mesh.nnode), M=M)
        x = to_free_vector(maps, res.x)
    elif args.op == "banded":
        # unstructured fast path: solve the RCM-permuted system so the hot
        # matvec is block-tridiagonal dense-block work (ops/banded.py); the
        # AMG hierarchy is built on the permuted matrix so the whole solve
        # lives in banded ordering (one gather at entry and exit)
        from ..ops.banded import banded_system
        with m.phase("banded_setup"):
            Aop, bp, unperm, op = banded_system(A, b)
            perm = op.perm.cpu().numpy()
        with m.phase("amg_setup"):
            # banded V-cycle too: every level's smoother matvec banded
            M = amg_precond(A.to_scipy()[perm][:, perm], matvec="banded",
                            device=device, dtype=dtype)
        with m.phase("pcg", nnz=A.nnz):
            res = pcg(Aop, bp, M=M)
        x = unperm(res.x)
    else:
        with m.phase("amg_setup"):
            M = amg_precond(A)
        with m.phase("pcg", nnz=A.nnz):
            res = pcg(A, b, M=M)
        x = res.x
    u = append_bc(maps, x, mesh.points, uex)
    print(f"n={maps.n_free} it={int(res.it)} "
          f"rel={res.history()[-1] / float(torch.linalg.norm(b)):.2e}")
    save_npz(args, "ex01.solution", u=u, iters=np.asarray([int(res.it)]))
    m.dump()


if __name__ == "__main__":
    main()
