"""Example10: large deterministic solve (scale point).

Port of `examples/ex10_large_deterministic.py` (reference
Example10_EllipticPdePllPcg.jl, a 2M-DoF validation point). CG on the
gather-free stencil operator: on the card every matvec is kernel A
(csrc/stencil_spmv.cu).
"""

from __future__ import annotations

import time

import numpy as np

from .common import base_parser, build_fem, init_backend, save_npz, sync


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(nnode=1_000_000)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    from ..fem import do_isotropic_elliptic_assembly
    from ..ops.stencil import build_stencil_op, to_full_vector
    from ..solvers.cg import cg

    mesh, maps, asm = build_fem(args)
    rng = np.random.default_rng(args.seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(0.3 * rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    St = build_stencil_op(A, maps, (m1, m1))
    b_full = to_full_vector(maps, b, mesh.nnode)
    sync(args)
    t0 = time.perf_counter()
    r = cg(St, b_full, maxit=8000)
    sync(args)
    dt = time.perf_counter() - t0
    print(f"n={mesh.nnode} it={int(r.it)} t={dt:.1f}s "
          f"-> {A.nnz * int(r.it) / dt / 1e9:.1f} Gnnz/s")
    save_npz(args, "ex10", iters=np.asarray([int(r.it)]),
             time_s=np.asarray([dt]))


if __name__ == "__main__":
    main()
