"""Example19: truncated-KL preconditioners, the preconditioner built from
the first k modes, k = 1..nKL.

Port of `examples/ex19_truncated_preconds.py` (reference
Example19_TruncatedPreconditioners.jl:70-114).
"""

from __future__ import annotations

import numpy as np

from .common import (add_factor_flag, base_parser, build_fem, build_kl,
                     cholesky_factory, init_backend, save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--ks", default="0,1,2,4,8,16")
    add_factor_flag(p)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..precond.amg import amg_precond
    from ..quantization.precond_bank import truncated_kl_precond
    from ..samplers.samplers import draw, prepare_mc_sampler
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    get_chol = cholesky_factory(args, mesh=mesh, maps=maps)
    cov, M, lam, psi = build_kl(args, mesh)
    smp = prepare_mc_sampler(lam, psi, key=args.seed, device=device,
                             dtype=dtype)
    smp, _ = draw(smp)
    A, b = do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))

    def assemble(coeff):
        Ak, _ = do_isotropic_elliptic_assembly(asm, coeff)
        return Ak

    ks = [k for k in map(int, args.ks.split(",")) if k <= len(lam)]
    its_chol, its_amg = [], []
    for k in ks:
        Mc = truncated_kl_precond(lam, psi, k, assemble, get_chol, xi=smp.xi)
        Ma = truncated_kl_precond(lam, psi, k, assemble, amg_precond,
                                  xi=smp.xi)
        ic = int(pcg(A, b, M=Mc).it)
        ia = int(pcg(A, b, M=Ma).it)
        its_chol.append(ic)
        its_amg.append(ia)
        print(f"k={k:3d}: chol {ic}  amg {ia}", flush=True)
    save_npz(args, "ex19.truncated", ks=np.asarray(ks),
             chol=np.asarray(its_chol), amg=np.asarray(its_amg))


if __name__ == "__main__":
    main()
