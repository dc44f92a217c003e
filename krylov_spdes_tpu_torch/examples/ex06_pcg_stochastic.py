"""Example06: stochastic elliptic PDE, constant vs rebuilt preconditioners.

Port of `examples/ex06_pcg_stochastic.py` (reference
Example06_PcgStochasticEllipticPde.jl:95-675): nreals MC samples; for each
strategy (AMG / LORASC / block-Jacobi / stencil AMG) compare the "median"
preconditioner (built once at ξ=0) against one rebuilt per sample; record
per-sample iteration counts to NPZ (the reference's regression surface,
SURVEY.md §4.3).
"""

from __future__ import annotations

import os

import numpy as np

from .common import (base_parser, build_dd, build_fem, build_kl,
                     init_backend, root_fname, save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--strategies", default="amg,lorasc,bj",
                   help="comma list of amg | lorasc | bj | samg "
                        "(samg = all-stencil AMG, rebuilt on the device)")
    p.add_argument("--save-conditioning", action="store_true",
                   help="record per-sample condition estimates of Pi^-1 A "
                        "(Example06:185-209)")
    p.add_argument("--save-spectra", action="store_true",
                   help="record full preconditioned spectra: dense, "
                        "study-sized only (Example06:215-241)")
    p.add_argument("--resume", action="store_true",
                   help="fast-forward through realizations already in the "
                        "periodic checkpoint (ndone marker); a COMPLETED "
                        "archive is extended toward --nreals (sampler "
                        "stream replayed for reproducibility)")
    p.add_argument("--ckpt-every", type=int, default=20,
                   help="archive-checkpoint cadence in realizations; set 1 "
                        "to bank every completed realization")
    p.add_argument("--certify", action="store_true",
                   help="solve to the CERTIFIED reference tolerance "
                        "(1e-7, cg.jl:33-35) via df32 iterative refinement "
                        "(solvers/refine.py): samg through the stencil "
                        "residual, amg/lorasc/bj through the ELL one; "
                        "recorded iters are total inner iterations")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import assemble_dd_values, do_isotropic_elliptic_assembly
    from ..fem.schur import prepare_schur_operator
    from ..precond.amg import amg_precond
    from ..precond.block_jacobi import (block_jacobi_precond,
                                        prepare_block_jacobi_plan)
    from ..precond.dd_preconds import prepare_lorasc_precond
    from ..samplers.samplers import draw, prepare_mc_sampler
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    cov, M, lam, psi = build_kl(args, mesh)
    strategies = args.strategies.split(",")
    # the DD plan only feeds LORASC; skip its host setup otherwise
    part = plan = None
    if "lorasc" in strategies:
        epart, part, plan = build_dd(args, mesh, maps)
    smp = prepare_mc_sampler(lam, psi, key=args.seed, device=device,
                             dtype=dtype)

    # median operator (xi = 0 -> g = 0 -> coeff = 1)
    A0, _ = do_isotropic_elliptic_assembly(asm, np.ones(mesh.nnode))
    bj_plan = (prepare_block_jacobi_plan(A0, max(2, args.ndom))
               if "bj" in strategies else None)

    St0 = None
    if "samg" in strategies:
        from ..ops.stencil import build_stencil_op, to_full_vector
        from ..precond.stencil_amg import stencil_amg_precond
        m1 = int(round(np.sqrt(mesh.nnode)))
        St0 = build_stencil_op(A0, maps, (m1, m1))

    def build_precond(name, A, coeff):
        if name == "amg":
            return amg_precond(A)
        if name == "samg":
            # value-only refill + the on-device setup: the "rebuilt" arm at
            # device speed (Example06:115-124's costly host AMG setup per
            # sample is the reference's acknowledged bottleneck)
            return stencil_amg_precond(St0.with_csr_data(A.data))
        if name == "bj":
            return block_jacobi_precond(A, max(2, args.ndom), plan=bj_plan)
        if name == "lorasc":
            blocks = assemble_dd_values(
                plan, torch.as_tensor(coeff, dtype=dtype, device=device))
            S = prepare_schur_operator(plan, part, *blocks[:3])
            return prepare_lorasc_precond(
                S, part, maps, nvec=min(25, part.n_gamma // 2 or 1),
                eps_threshold=0.01)
        raise ValueError(name)

    const_preconds = {s: build_precond(s, A0, np.ones(mesh.nnode))
                      for s in strategies}
    iters = {f"{s}_{mode}": np.zeros(args.nreals, dtype=np.int64)
             for s in strategies for mode in ("const", "rebuilt")}
    kappas = {s: np.zeros(args.nreals) for s in strategies} \
        if args.save_conditioning else None
    spectra = [] if args.save_spectra else None

    if args.certify:
        from ..solvers.refine import refined_pcg, refined_pcg_sparse
        certres = {f"{s}_{mode}": np.zeros(args.nreals)
                   for s in strategies for mode in ("const", "rebuilt")}

        def solve(Ak, bk, M, key, ireal):
            # stencil strategies refine through the 9-plane df32 residual;
            # the general ELL strategies (amg/lorasc/bj) through the ELL
            # df32 residual: both certify 1e-7 (cg.jl:33-35)
            if key.startswith("samg"):
                r = refined_pcg(Ak, bk, M=M, rtol=1e-7)
            else:
                r = refined_pcg_sparse(Ak, bk, M=M, rtol=1e-7,
                                       single_trace=False)
            certres[key][ireal] = float(r.res_norm[0]) / float(
                torch.linalg.norm(bk))
            return r
    else:
        certres = {}

        def solve(Ak, bk, M, key, ireal):
            return pcg(Ak, bk, M=M)

    start = 0
    carry = {}      # archive columns not owned by this run (e.g. resuming
                    # a strategy subset): passed through on every save
    if args.resume:
        ckpt = os.path.join(args.data_dir,
                            f"{root_fname(args)}.ndom{args.ndom}"
                            ".ex06.iters.npz")
        if os.path.exists(ckpt):
            d = np.load(ckpt)
            # a COMPLETED archive has no ndone marker: its length is the
            # done count (lets --nreals extend a finished protocol run).
            # A strategy absent from the archive restarts the whole run at
            # 0 (its rows must be computed; the shared sampler stream keeps
            # the carried columns coherent).
            if all(f"{s}_const" in d.files for s in strategies):
                start = (int(d["ndone"]) if "ndone" in d
                         else min(len(d[f"{s}_const"]) for s in strategies))
            start = min(start, args.nreals)
            for k in iters:
                if k in d.files:
                    n = min(start, len(d[k]))
                    iters[k][:n] = d[k][:n]
            for k in certres:
                kk = f"certres_{k}"
                if kk in d.files:
                    n = min(start, len(d[kk]))
                    certres[k][:n] = d[kk][:n]
            owned = (set(iters) | {f"certres_{k}" for k in certres}
                     | {"ndone", "certified_rtol"})
            carry = {k: d[k] for k in d.files if k not in owned}
            print(f"resuming from {ckpt}: {start}/{args.nreals} done"
                  + (f" (carrying {sorted(carry)})" if carry else ""))

    for ireal in range(args.nreals):
        smp, _ = draw(smp)
        if ireal < start:     # fast-forward the sampler through done reals
            continue
        coeff = torch.exp(smp.g)
        A, b = do_isotropic_elliptic_assembly(asm, coeff)
        for s in strategies:
            if s == "samg":
                Ak = St0.with_csr_data(A.data)
                bk = to_full_vector(maps, b, mesh.nnode)
            else:
                Ak, bk = A, b
            r = solve(Ak, bk, const_preconds[s], f"{s}_const", ireal)
            iters[f"{s}_const"][ireal] = int(r.it)
            r = solve(Ak, bk, build_precond(s, A, coeff), f"{s}_rebuilt",
                      ireal)
            iters[f"{s}_rebuilt"][ireal] = int(r.it)
            if kappas is not None:
                from ..utils.diagnostics import condition_estimate
                kappas[s][ireal] = condition_estimate(
                    Ak, const_preconds[s], iters=60, device=device,
                    dtype=dtype)[2]
        if spectra is not None:
            from ..utils.diagnostics import preconditioned_spectrum
            spectra.append(preconditioned_spectrum(
                A, const_preconds[strategies[0]], device=device, dtype=dtype))
        print(f"real {ireal}: " + "  ".join(
            f"{s}: {iters[f'{s}_const'][ireal]}/{iters[f'{s}_rebuilt'][ireal]}"
            for s in strategies), flush=True)
        if (ireal + 1) % args.ckpt_every == 0 or ireal == args.nreals - 1:
            # periodic checkpoint of the regression surface
            cext = ({f"certres_{k}": v for k, v in certres.items()}
                    if certres else {})
            if certres:
                cext["certified_rtol"] = np.float64(1e-7)
            save_npz(args, f"ndom{args.ndom}.ex06.iters",
                     ndone=np.int64(ireal + 1), **iters, **cext, **carry)

    for k, v in iters.items():
        print(f"{k}: mean {v.mean():.1f} ± {v.std():.1f}")
    extra = {}
    if kappas is not None:
        extra.update({f"kappa_{s}": kappas[s] for s in strategies})
    if spectra is not None:
        extra["spectra"] = np.stack(spectra)
    if certres:
        extra.update({f"certres_{k}": v for k, v in certres.items()})
        extra["certified_rtol"] = np.float64(1e-7)
        for k, v in certres.items():
            print(f"certified relres {k}: max {v.max():.2e}")
    save_npz(args, f"ndom{args.ndom}.ex06.iters", **iters, **extra,
             **carry)


if __name__ == "__main__":
    main()
