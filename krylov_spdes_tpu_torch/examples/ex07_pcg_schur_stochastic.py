"""Example07: stochastic Schur-complement PCG with NN / A_ΓΓ preconditioners.

Port of `examples/ex07_pcg_schur_stochastic.py` (reference
Example07_PcgSchurStochasticEllipticPde.jl:86-424): per realization, refill
the DD blocks, condense, and solve the interface system with (a) constant
"median" NN, (b) rebuilt NN, (c) A_ΓΓ-Cholesky preconditioners; record
iteration counts.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import torch

from .common import (base_parser, build_dd, build_fem, build_kl,
                     init_backend, root_fname, save_npz)


def _gamma_chol_apply(L, r):
    return torch.cholesky_solve(r[:, None], L)[:, 0]


def gamma_chol_precond(S):
    """Dense Cholesky of the assembled A_ΓΓ (the reference's A_ΓΓ
    preconditioner of the interface system)."""
    from ..precond.dd_preconds import assemble_gamma_matrix
    return partial(_gamma_chol_apply,
                   torch.linalg.cholesky(assemble_gamma_matrix(S)))


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted protocol run from its "
                        "periodic checkpoint (ndone marker): completed "
                        "realizations are fast-forwarded (draws only)")
    p.add_argument("--rtol", type=float, default=1e-7,
                   help="interface-solve relative tolerance (reference "
                        "default 1e-7, cg.jl:33-35; use ~1e-5 for a "
                        "float32 arm on the card)")
    p.add_argument("--tag", default=None,
                   help="suffix for the archive filename (e.g. 'chip' to "
                        "keep a card-side arm separate from the f64 one)")
    p.add_argument("--interiors", default="dense",
                   choices=["dense", "banded"],
                   help="subdomain interior factorization: dense batched "
                        "Cholesky (reference CHOLMOD slot) or RCM-banded "
                        "block-tridiagonal (fem/dd_banded.py, the "
                        "unstructured-mesh fast path, O(nI*m^2) vs O(nI^3))")
    p.add_argument("--certify", action="store_true",
                   help="solve each arm to the CERTIFIED reference tolerance "
                        "(1e-7) via df32 full-DD-system iterative refinement "
                        "(solvers/refine.py::refined_dd_pcg); --rtol becomes "
                        "the inner interface tolerance and the archive "
                        "gains per-real certres_* columns")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    from ..fem import assemble_dd_values
    from ..fem.schur import (get_schur_rhs,
                             prepare_neumann_neumann_schur_precond,
                             prepare_schur_operator)
    from ..samplers.samplers import draw, prepare_mc_sampler
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    cov, M, lam, psi = build_kl(args, mesh)
    epart, part, plan = build_dd(args, mesh, maps)
    smp = prepare_mc_sampler(lam, psi, key=args.seed, device=device,
                             dtype=dtype)

    if args.interiors == "banded":
        from ..fem.dd_banded import (prepare_banded_interiors,
                                     prepare_schur_operator_banded)
        btab = prepare_banded_interiors(mesh.cells, part, plan)
        print(f"banded interiors: m={btab.m} nb={btab.nb} "
              f"(bw max {int(btab.bw.max())}, nI={part.interior_l2g.shape[1]})")

        def make_schur(pl, pt, A_II, A_IG, A_GGd):
            return prepare_schur_operator_banded(pl, pt, A_II, A_IG, A_GGd,
                                                 btab)
    else:
        make_schur = prepare_schur_operator

    blocks0 = assemble_dd_values(plan, torch.ones(mesh.nnode, dtype=dtype,
                                                  device=device))
    S0 = make_schur(plan, part, *blocks0[:3])
    Pnn0 = prepare_neumann_neumann_schur_precond(S0)

    tag = f".{args.tag}" if args.tag else ""
    names = ["nn_const", "nn_rebuilt", "gamma_chol"]
    iters = {k: np.zeros(args.nreals, dtype=np.int64) for k in names}
    certres = ({k: np.zeros(args.nreals) for k in names}
               if args.certify else {})
    pull = None
    if args.certify:
        from ..fem.schur import (assemble_local_schurs,
                                 assembled_schur_operator)
        from ..ops.df32 import build_gamma_pullback
        from ..solvers.refine import refined_dd_pcg
        pull = build_gamma_pullback(S0.gammad_to_gamma, S0.gmask,
                                    S0.n_gamma)
    start = 0
    if args.resume:
        ckpt = os.path.join(args.data_dir,
                            f"{root_fname(args)}.ndom{args.ndom}"
                            f".ex07.iters{tag}.npz")
        if os.path.exists(ckpt):
            d = np.load(ckpt)
            # a COMPLETED archive has no ndone marker: its length is the
            # done count (lets --nreals extend a finished protocol run)
            start = int(d["ndone"]) if "ndone" in d else len(d[names[0]])
            start = min(start, args.nreals)
            for k in names:
                n = min(start, len(d[k]))
                iters[k][:n] = d[k][:n]
            for k in certres:
                kk = f"certres_{k}"
                if kk in d.files:
                    n = min(start, len(d[kk]))
                    certres[k][:n] = d[kk][:n]
            print(f"resuming from {ckpt}: {start}/{args.nreals} done")
    for ireal in range(args.nreals):
        smp, _ = draw(smp)
        if ireal < start:     # fast-forward the sampler through done reals
            continue
        coeff = torch.exp(smp.g)
        A_II, A_IG, A_GGd, b_I, b_G = assemble_dd_values(plan, coeff)
        S = make_schur(plan, part, A_II, A_IG, A_GGd)
        b_s = get_schur_rhs(S, b_I, b_G)
        if args.certify:
            # the certificate is the df32 FULL-system residual, so the
            # inner interface solver is purely a speed choice: ride the
            # assembled-Sd batched apply (computed for the NN rebuild
            # anyway) instead of per-iteration interior triangular solves
            Sd = assemble_local_schurs(S)
            inner_op = assembled_schur_operator(S, Sd)
            Pnn_reb = prepare_neumann_neumann_schur_precond(S, Sd=Sd)
        else:
            inner_op = None
            Pnn_reb = prepare_neumann_neumann_schur_precond(S)
        for name, Mp in [("nn_const", Pnn0), ("nn_rebuilt", Pnn_reb),
                         ("gamma_chol", gamma_chol_precond(S))]:
            if args.certify:
                r = refined_dd_pcg(plan, S, inner_op, b_I, b_G,
                                   A_II, A_IG, A_GGd,
                                   M=Mp, rtol=1e-7, inner_rtol=args.rtol,
                                   pull=pull)
                certres[name][ireal] = float(r.res_norm[0]) / r.bnorm
            else:
                r = pcg(S, b_s, M=Mp, rtol=args.rtol)
            iters[name][ireal] = int(r.it)
        print(f"real {ireal}: " + "  ".join(
            f"{k}={iters[k][ireal]}" for k in names), flush=True)
        if (ireal + 1) % 20 == 0 or ireal == args.nreals - 1:
            # periodic checkpoint of the regression surface (long protocols
            # survive interruption; ndone marks validity)
            cext = ({f"certres_{k}": v for k, v in certres.items()}
                    if certres else {})
            if certres:
                cext["certified_rtol"] = np.float64(1e-7)
            save_npz(args, f"ndom{args.ndom}.ex07.iters{tag}",
                     ndone=np.int64(ireal + 1), **iters, **cext)

    for k, v in iters.items():
        print(f"{k}: mean {v.mean():.1f} ± {v.std():.1f}")
    extra = {}
    if certres:
        extra.update({f"certres_{k}": v for k, v in certres.items()})
        extra["certified_rtol"] = np.float64(1e-7)
        for k, v in certres.items():
            print(f"certified relres {k}: max {v.max():.2e}")
    save_npz(args, f"ndom{args.ndom}.ex07.iters{tag}", **iters, **extra)


if __name__ == "__main__":
    main()
