"""Example14: quantization + Shepard interpolation of preconditioners.

Port of `examples/ex14_shepard.py` (reference
Example14_QuantizationAndShepardLocalInterpolation_Functions.jl:18-327):
inverse-distance-weighted combination of centroidal preconditioners vs
nearest-centroid selection.
"""

from __future__ import annotations

import numpy as np

from .common import (add_factor_flag, base_parser, build_fem, build_kl,
                     cholesky_factory, init_backend, save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--P", type=int, default=6)
    add_factor_flag(p)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..quantization.precond_bank import (build_centroidal_preconds,
                                             select_nearest,
                                             shepard_interpolating_precond)
    from ..quantization.quantizers import get_quantizer
    from ..samplers.samplers import draw, prepare_mc_sampler
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    get_cholesky = cholesky_factory(args, mesh=mesh, maps=maps)
    cov, M, lam, psi = build_kl(args, mesh)
    X, centroids, _, _ = get_quantizer(1500, args.P, lam, device=device,
                                       dtype=dtype)

    def assemble(coeff):
        A, _ = do_isotropic_elliptic_assembly(asm, coeff)
        return A

    bank = build_centroidal_preconds(centroids, lam, psi, assemble,
                                     get_cholesky)
    smp = prepare_mc_sampler(lam, psi, key=args.seed, device=device,
                             dtype=dtype)
    it_near = np.zeros(args.nreals, dtype=np.int64)
    it_shep = np.zeros(args.nreals, dtype=np.int64)
    for s in range(args.nreals):
        smp, _ = draw(smp)
        A, b = do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))
        Mn, _, _ = select_nearest(bank, smp.xi, centroids, lam)
        Ms = shepard_interpolating_precond(smp.xi, centroids, bank, lam)
        it_near[s] = int(pcg(A, b, M=Mn).it)
        it_shep[s] = int(pcg(A, b, M=Ms).it)
        print(f"s={s}: nearest={it_near[s]} shepard={it_shep[s]}", flush=True)
    print(f"nearest mean {it_near.mean():.1f}  shepard mean "
          f"{it_shep.mean():.1f}")
    save_npz(args, f"P{args.P}.ex14", nearest=it_near, shepard=it_shep)


if __name__ == "__main__":
    main()
