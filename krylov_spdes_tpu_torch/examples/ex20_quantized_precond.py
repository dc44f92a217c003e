"""Example20: quantized preconditioners at scale.

Port of `examples/ex20_quantized_precond.py` (reference
Example20_QuantizedPreconditioner.jl:26-53 and its _Functions.jl:56-147):
P ∈ {kmeans | cdf-kmeans | deterministic ±s grid} codebooks over a
truncated latent space; many realizations solved with the nearest
quantized preconditioner (the bank stays on the device).
"""

from __future__ import annotations

import numpy as np

from .common import (add_factor_flag, base_parser, build_fem, build_kl,
                     cholesky_factory, host, init_backend, save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--P", type=int, default=16)
    p.add_argument("--nKL-trunc", type=int, default=4)
    p.add_argument("--codebook", default="kmeans",
                   choices=["kmeans", "cdf", "grid"])
    p.add_argument("--grid-s", type=float, default=1.0)
    add_factor_flag(p)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..quantization.precond_bank import (build_centroidal_preconds,
                                             select_nearest)
    from ..quantization.quantizers import deterministic_grid, get_quantizer
    from ..samplers.samplers import draw, prepare_mc_sampler
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    get_cholesky = cholesky_factory(args, mesh=mesh, maps=maps)
    cov, M, lam, psi = build_kl(args, mesh)
    k = min(args.nKL_trunc, len(lam))

    if args.codebook == "grid":
        _, xi_cb = deterministic_grid(k, args.grid_s, lam)
    else:
        dist = "cdf" if args.codebook == "cdf" else "L2-full"
        _, cb, _, _ = get_quantizer(4000, args.P, lam[:k], distance=dist,
                                    device=device, dtype=dtype)
        xi_cb = host(cb)
    # pad truncated codebook back to full latent dimension (zeros beyond k)
    full_cb = np.zeros((xi_cb.shape[0], len(lam)))
    full_cb[:, :k] = xi_cb
    print(f"codebook: {full_cb.shape[0]} entries over {k} modes")

    def assemble(coeff):
        A, _ = do_isotropic_elliptic_assembly(asm, coeff)
        return A

    bank = build_centroidal_preconds(full_cb, lam, psi, assemble,
                                     get_cholesky)
    smp = prepare_mc_sampler(lam, psi, key=args.seed, device=device,
                             dtype=dtype)
    iters = np.zeros(args.nreals, dtype=np.int64)
    for s in range(args.nreals):
        smp, _ = draw(smp)
        A, b = do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))
        Mp, pidx, d = select_nearest(bank, smp.xi, full_cb, lam)
        iters[s] = int(pcg(A, b, M=Mp).it)
    print(f"mean iters {iters.mean():.1f} over {args.nreals} realizations")
    save_npz(args, f"P{full_cb.shape[0]}.ex20", iters=iters)


if __name__ == "__main__":
    main()
