"""Example12: Voronoi quantization of the stochastic space + centroidal
preconditioners.

Port of `examples/ex12_quantization.py` (reference
Example12_Quantization_Functions.jl:29-167): k-means over N(0,I) samples
under L2/L2-10%/cdf metrics, one preconditioner per centroid, solves with
the nearest-centroid preconditioner. The quantizer's samples come from a
torch generator seeded as the JAX package's default key (987654321), a
different stream from that key's.
"""

from __future__ import annotations

import numpy as np

from .common import (add_factor_flag, base_parser, build_fem, build_kl,
                     cholesky_factory, init_backend, save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--P", type=int, default=8, help="number of centroids")
    p.add_argument("--nsamples", type=int, default=2000)
    p.add_argument("--distance", default="L2-full",
                   choices=["L2-full", "L2-10%", "cdf"])
    add_factor_flag(p)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..quantization.precond_bank import (build_centroidal_preconds,
                                             select_nearest)
    from ..quantization.quantizers import get_quantizer
    from ..samplers.samplers import draw, prepare_mc_sampler
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    get_cholesky = cholesky_factory(args, mesh=mesh, maps=maps)
    cov, M, lam, psi = build_kl(args, mesh)

    X, centroids, assignments, costs = get_quantizer(
        args.nsamples, args.P, lam, distance=args.distance, device=device,
        dtype=dtype)
    print(f"quantizer: P={args.P} mean cost {float(torch.mean(costs)):.3f}")

    def assemble(coeff):
        A, _ = do_isotropic_elliptic_assembly(asm, coeff)
        return A

    bank = build_centroidal_preconds(centroids, lam, psi, assemble,
                                     get_cholesky)
    smp = prepare_mc_sampler(lam, psi, key=args.seed, device=device,
                             dtype=dtype)
    iters = np.zeros(args.nreals, dtype=np.int64)
    dists = np.zeros(args.nreals)
    assign = np.zeros(args.nreals, dtype=np.int64)
    for s in range(args.nreals):
        smp, _ = draw(smp)
        A, b = do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))
        Mp, pidx, d = select_nearest(bank, smp.xi, centroids, lam)
        r = pcg(A, b, M=Mp)
        iters[s], dists[s], assign[s] = int(r.it), d, pidx
        print(f"s={s}: centroid {pidx} dist {d:.2f} it {iters[s]}",
              flush=True)
    print(f"mean iters {iters.mean():.1f}")
    save_npz(args, f"P{args.P}.ex12", iters=iters, dists=dists,
             assignments=assign)


if __name__ == "__main__":
    main()
