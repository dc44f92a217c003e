"""Example09: MCMC chains with online deflation recycling (eigDef-PCG).

Port of `examples/ex09_defpcg_mcmc.py` (reference
Example09_DefPcgMcmcStochasticEllipticPde.jl:130-143 and its
_Functions.jl:139-509): per chain, per sample: RW-Metropolis draw,
on-device operator refill, solve with {pcg, eigpcg, eigdefpcg, defpcg}
under a constant "median" preconditioner; the deflation basis W is recycled
sample to sample; chains whose basis degenerates (rank(W) < 0.9 nvec) are
flagged; on solver breakdown the (A, b, W) fixture is dumped (SURVEY.md
§4.5-4.6) and the chain checkpoint allows resume instead of
discard-and-rerun.
"""

from __future__ import annotations

import os

import numpy as np

from .common import (base_parser, build_dd, build_fem, build_kl,
                     init_backend, root_fname, save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--nchains", type=int, default=3)
    p.add_argument("--nsmp", type=int, default=5)
    p.add_argument("--nvec", type=int, default=None,
                   help="default floor(1.25*ndom) like the reference")
    p.add_argument("--maxit", type=int, default=5000)
    p.add_argument("--precond", default="amg",
                   choices=["amg", "lorasc0", "lorasc1", "bj"],
                   help="constant median preconditioner (built at xi=0): "
                        "the reference protocol runs lorasc1 = LORASC with "
                        "eps_threshold 0.01 (Example09:42-51 preconds = "
                        "['lorasc$(ndom)_1']); lorasc0 = eps 0, bj/amg as "
                        "in Example06")
    p.add_argument("--certify", action="store_true",
                   help="solve every system to the CERTIFIED reference "
                        "tolerance (1e-7) via df32 refinement on float32 "
                        "hardware; iters are total inner its")
    p.add_argument("--inner-rtol", type=float, default=1e-5)
    p.add_argument("--resume", action="store_true",
                   help="continue from the archive's ndone_chain marker "
                        "(chains are RNG-independent, keyed seed*1000+ic, "
                        "so completed chains are skipped exactly); any "
                        "already-archived certified entry above tolerance "
                        "is retro-flagged status=-1")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..precond.amg import amg_precond
    from ..samplers.samplers import draw, prepare_mcmc_sampler
    from ..solvers.base import check_w_rank
    from ..solvers.cg import pcg
    from ..solvers.defcg import defpcg, eigdefpcg
    from ..solvers.eigcg import eigpcg
    from ..utils.persistence import (save_chain_checkpoint,
                                     save_deflated_system)

    nvec = args.nvec or int(1.25 * args.ndom)
    spdim = 3 * args.ndom
    spdim = max(spdim, 2 * nvec + 1)
    mesh, maps, asm = build_fem(args)
    cov, M, lam, psi = build_kl(args, mesh)

    # constant "median" preconditioner (reference get_constant_preconds,
    # Example09..._Functions.jl:10-119)
    A0, _ = do_isotropic_elliptic_assembly(asm, np.ones(mesh.nnode))
    if args.precond == "amg":
        M0 = amg_precond(A0)
    elif args.precond == "bj":
        from ..precond.block_jacobi import block_jacobi_precond
        M0 = block_jacobi_precond(A0, max(2, args.ndom))
    else:
        from ..fem import assemble_dd_values
        from ..fem.schur import prepare_schur_operator
        from ..precond.dd_preconds import prepare_lorasc_precond
        epart, part, plan = build_dd(args, mesh, maps)
        blocks0 = assemble_dd_values(plan, torch.ones(mesh.nnode, dtype=dtype,
                                                      device=device))
        S0 = prepare_schur_operator(plan, part, *blocks0[:3])
        M0 = prepare_lorasc_precond(
            S0, part, maps, nvec=min(25, part.n_gamma // 2 or 1),
            eps_threshold=0.0 if args.precond == "lorasc0" else 0.01)
    if args.certify:
        from ..solvers.refine import (refined_pcg_sparse,
                                      refined_recycled_solve)
    inner = args.inner_rtol if args.certify else None

    methods = ["pcg", "eigpcg", "eigdefpcg", "defpcg"]
    iters = {m: np.zeros((args.nchains, args.nsmp), dtype=np.int64)
             for m in methods}
    certres = ({m: np.zeros((args.nchains, args.nsmp)) for m in methods}
               if args.certify else {})
    status = np.zeros(args.nchains, dtype=np.int64)
    ptag = "" if args.precond == "amg" else f".{args.precond}"

    ic0 = 0
    if args.resume:
        prev = os.path.join(args.data_dir,
                            f"{root_fname(args)}.ndom{args.ndom}"
                            f".ex09.iters{ptag}.npz")
        if os.path.exists(prev):
            d = np.load(prev)
            ic0 = int(d["ndone_chain"]) if "ndone_chain" in d else args.nchains
            nc = min(ic0, args.nchains)
            status[:nc] = d["status"][:nc]
            for m in methods:
                iters[m][:nc] = d[m][:nc]
                if args.certify and f"certres_{m}" in d:
                    certres[m][:nc] = d[f"certres_{m}"][:nc]
                    # retro-flag archived over-tolerance entries: a certified
                    # archive must never hold certres > rtol with status=0
                    # (the reference discards such chains,
                    # Example09..._Functions.jl:356-360)
                    bad = np.flatnonzero(certres[m][:nc].max(axis=1) > 1e-7)
                    for ib in bad:
                        if status[ib] == 0:
                            print(f"resume: chain {ib} {m} certres "
                                  f"{certres[m][ib].max():.2e} > 1e-7: "
                                  f"retro-flagged status=-1", flush=True)
                            status[ib] = -1
            print(f"resuming from {prev}: chains 0..{ic0 - 1} loaded",
                  flush=True)

    for ic in range(ic0, args.nchains):
        smp = prepare_mcmc_sampler(lam, psi, key=args.seed * 1000 + ic,
                                   device=device, dtype=dtype)
        W = {m: None for m in methods}
        for s in range(args.nsmp):
            if s > 0:
                smp, cnt = draw(smp)
            A, b = do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))
            for m in methods:
                if m == "pcg":
                    first = lambda: pcg(A, b, M=M0, maxit=args.maxit,  # noqa: E731
                                        rtol=inner)
                elif m == "eigpcg" or (m == "eigdefpcg" and W[m] is None):
                    first = lambda: eigpcg(  # noqa: E731
                        A, b, M=M0, nvec=nvec, spdim=spdim,
                        maxit=args.maxit, rtol=inner)
                elif m == "eigdefpcg":
                    first = lambda Wc=W[m]: eigdefpcg(  # noqa: E731
                        A, b, M=M0, W=Wc, spdim=spdim, maxit=args.maxit,
                        rtol=inner)
                elif W["eigpcg"] is None:   # defpcg before any basis
                    first = lambda: pcg(A, b, M=M0, maxit=args.maxit,  # noqa: E731
                                        rtol=inner)
                else:   # defpcg with the eigpcg-seeded basis
                    first = lambda Wc=W["eigpcg"]: defpcg(  # noqa: E731
                        A, b, W=Wc, M=M0, maxit=args.maxit, rtol=inner)
                if args.certify and m == "pcg":
                    r = refined_pcg_sparse(A, b, M=M0, rtol=1e-7,
                                           inner_rtol=args.inner_rtol,
                                           inner_maxit=args.maxit)
                    certres[m][ic, s] = float(r.res_norm[0]) / float(
                        torch.linalg.norm(b))
                elif args.certify:
                    r = refined_recycled_solve(
                        A, b, first, M=M0, rtol=1e-7,
                        inner_rtol=args.inner_rtol, inner_maxit=args.maxit)
                    certres[m][ic, s] = float(r.res_norm[0]) / r.bnorm
                else:
                    r = first()
                iters[m][ic, s] = int(r.it)
                if r.failed:
                    path = os.path.join(args.data_dir,
                                        f"{root_fname(args)}.ex09-failed-"
                                        f"c{ic}s{s}-{m}.npz")
                    save_deflated_system(
                        path, A, b, W[m] if W[m] is not None
                        else np.zeros((maps.n_free, 0)))
                    status[ic] = -1
                if r.W is not None:
                    if not check_w_rank(r.W):
                        print(f"chain {ic}: rank(W) < 0.9 nvec at s={s} "
                              f"({m}): flagged")
                        status[ic] = -1
                    W[m] = r.W
            print(f"chain {ic} s={s}: " + " ".join(
                f"{m}={iters[m][ic, s]}" for m in methods), flush=True)
            ckpt = os.path.join(args.data_dir,
                                f"{root_fname(args)}.ex09-chain{ic}.ckpt.npz")
            save_chain_checkpoint(
                ckpt, smp,
                W["eigdefpcg"] if W["eigdefpcg"] is not None else
                np.zeros((maps.n_free, 0)), s, iters["eigdefpcg"][ic])
        # periodic archive checkpoint after each completed chain
        save_npz(args, f"ndom{args.ndom}.ex09.iters{ptag}", status=status,
                 ndone_chain=np.int64(ic + 1),
                 **{m: iters[m] for m in methods},
                 **({f"certres_{m}": v for m, v in certres.items()}
                    if certres else {}),
                 **({"certified_rtol": np.float64(1e-7)} if certres else {}))

    for m in methods:
        print(f"{m}: mean per-sample iters "
              f"{iters[m].mean(axis=0).round(1)}")
    extra = {}
    if certres:
        extra.update({f"certres_{m}": v for m, v in certres.items()})
        extra["certified_rtol"] = np.float64(1e-7)
        for m, v in certres.items():
            print(f"certified relres {m}: max {v.max():.2e}")
    save_npz(args, f"ndom{args.ndom}.ex09.iters{ptag}", status=status,
             nchains=np.int64(args.nchains), nsmp=np.int64(args.nsmp),
             nvec=np.int64(nvec), spdim=np.int64(spdim),
             **{m: iters[m] for m in methods}, **extra)


if __name__ == "__main__":
    main()
