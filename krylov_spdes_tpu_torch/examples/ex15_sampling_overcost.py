"""Example15: sampling overcost, MC vs MCMC vs hybrid chains.

Port of `examples/ex15_sampling_overcost.py` (reference
Example15_SamplingOvercost_Functions.jl:56-195): the QoI is u at the vertex
closest to a probe point; compares the proposal counts and solve costs per
effective sample across sampler types.
"""

from __future__ import annotations

import numpy as np

from .common import (base_parser, build_fem, build_kl, host, init_backend,
                     save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--probe", default="0.5,0.5")
    p.add_argument("--m-mcmc", type=int, default=10)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..precond.amg import amg_precond
    from ..samplers.samplers import (draw, prepare_hybrid_sampler,
                                     prepare_mc_sampler, prepare_mcmc_sampler)
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    cov, M, lam, psi = build_kl(args, mesh)
    px, py = map(float, args.probe.split(","))
    probe = np.argmin((mesh.points[:, 0] - px) ** 2
                      + (mesh.points[:, 1] - py) ** 2)
    A0, _ = do_isotropic_elliptic_assembly(asm, np.ones(mesh.nnode))
    M0 = amg_precond(A0)

    on = dict(device=device, dtype=dtype)
    samplers = {
        "mc": prepare_mc_sampler(lam, psi, key=args.seed, **on),
        "mcmc": prepare_mcmc_sampler(lam, psi, key=args.seed + 1, **on),
        "hybrid": prepare_hybrid_sampler(lam, psi,
                                         min(args.m_mcmc, len(lam)),
                                         key=args.seed + 2, **on),
    }
    out = {}
    for name, smp in samplers.items():
        qoi = np.zeros(args.nreals)
        props = np.zeros(args.nreals, dtype=np.int64)
        its = np.zeros(args.nreals, dtype=np.int64)
        for s in range(args.nreals):
            smp, cnt = draw(smp)
            A, b = do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))
            r = pcg(A, b, M=M0)
            u = np.zeros(mesh.nnode)
            u[maps.free_l2g] = host(r.x)
            qoi[s] = u[probe]
            props[s] = int(cnt)
            its[s] = int(r.it)
        print(f"{name}: proposals/sample {props.mean():.2f}, "
              f"iters/sample {its.mean():.1f}, QoI mean {qoi.mean():.4e}")
        out[f"{name}_qoi"] = qoi
        out[f"{name}_proposals"] = props
        out[f"{name}_iters"] = its
    save_npz(args, "ex15.overcost", **out)


if __name__ == "__main__":
    main()
