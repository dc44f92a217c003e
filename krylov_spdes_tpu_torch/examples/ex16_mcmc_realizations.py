"""Example16: dump MCMC field realizations at several chain lengths.

Port of `examples/ex16_mcmc_realizations.py` (reference
Example16_McmcRealizations.jl:63-88).
"""

from __future__ import annotations

from .common import base_parser, build_fem, build_kl, init_backend, save_npz


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--lengths", default="0,10,100,1000")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    from ..samplers.samplers import draw, prepare_mcmc_sampler

    mesh, maps, asm = build_fem(args)
    cov, M, lam, psi = build_kl(args, mesh)
    lengths = sorted(map(int, args.lengths.split(",")))
    smp = prepare_mcmc_sampler(lam, psi, key=args.seed, device=device,
                               dtype=dtype)
    out = {}
    step = 0
    for target in lengths:
        while step < target:
            smp, _ = draw(smp)
            step += 1
        out[f"g_{target}"] = smp.g
        print(f"recorded realization at chain length {target}")
    save_npz(args, "ex16.realizations", **out)


if __name__ == "__main__":
    main()
