"""Example11: multiple right-hand sides with a constant operator.

Port of `examples/ex11_multiple_rhs.py` (reference
Example11_EigInitPcgEllipticPdeMultipleRhs.jl:140-148): constant A,
MC-sampled RHS sequence; compare Init-PCG and eigPCG/eigDef-PCG
(incremental eigenvector harvesting across solves).

--schur runs the reference's Schur-system flavor
(Example11_EigInitPcgEllipticPdeMultipleRhs_Functions.jl:53-166: condense
the constant operator once, per sample condense the new RHS with
get_schur_rhs and solve the interface system under the Neumann-Neumann
preconditioner). --block-rhs k adds the alternative the reference lacks:
block-PCG over k stacked RHS (solvers/block_cg.py), where every apply takes
an (n, k) block and the block shares spectral information.
"""

from __future__ import annotations

import numpy as np

from .common import (base_parser, build_dd, build_fem, init_backend,
                     save_npz)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--nvec", type=int, default=10)
    p.add_argument("--spdim", type=int, default=30)
    p.add_argument("--schur", action="store_true",
                   help="solve the interface (Schur) system per sample "
                        "instead of the assembled A (reference's "
                        "neumann-neumann precond arm)")
    p.add_argument("--block-rhs", type=int, default=0,
                   help="also solve the whole RHS sequence in blocks of "
                        "this size with block-PCG and record its per-solve "
                        "iteration count (column 'blockpcg')")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import do_isotropic_elliptic_assembly
    from ..precond.amg import amg_precond
    from ..solvers.cg import pcg
    from ..solvers.defcg import eigdefpcg
    from ..solvers.eigcg import eigpcg
    from ..solvers.initcg import initpcg

    mesh, maps, asm = build_fem(args)
    rng = np.random.default_rng(args.seed)
    coeff = np.exp(rng.normal(size=mesh.nnode))
    A, b0 = do_isotropic_elliptic_assembly(asm, coeff)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731

    if args.schur:
        from ..fem import assemble_dd_values
        from ..fem.schur import (get_schur_rhs,
                                 prepare_neumann_neumann_schur_precond,
                                 prepare_schur_operator)
        epart, part, plan = build_dd(args, mesh, maps)
        blocks = assemble_dd_values(plan, t(coeff))
        S = prepare_schur_operator(plan, part, *blocks[:3])
        M0 = prepare_neumann_neumann_schur_precond(S)
        # free-vector -> padded DD RHS split (the per-sample analogue of
        # the reference's get_schur_rhs re-condensation, :147-154)
        iidx = maps.free_g2l[np.maximum(part.interior_l2g, 0)]
        gidx = maps.free_g2l[part.gamma_l2g]
        imask = plan.imask.cpu().numpy()

        def sample_rhs():
            bf = rng.normal(size=maps.n_free)
            return get_schur_rhs(S, t(bf[iidx] * imask), t(bf[gidx]))

        def block_op(X):
            # the interior solves of S take one vector at a time: the
            # block applies column by column
            return torch.stack([S(x) for x in X.T], dim=1)

        def block_precond(R):
            return M0(R.T).T
        Aop = S
    else:
        M0 = amg_precond(A)

        def sample_rhs():
            return t(rng.normal(size=maps.n_free))
        Aop = block_op = A
        block_precond = M0

    iters = {m: np.zeros(args.nreals, dtype=np.int64)
             for m in ("pcg", "initpcg", "eigdefpcg")}
    W = None
    rhs_hist = []
    for s in range(args.nreals):
        b = sample_rhs()
        rhs_hist.append(b)
        iters["pcg"][s] = int(pcg(Aop, b, M=M0).it)
        if W is None:
            r = eigpcg(Aop, b, M=M0, nvec=args.nvec, spdim=args.spdim)
            iters["initpcg"][s] = iters["eigdefpcg"][s] = int(r.it)
            W = r.W
        else:
            iters["initpcg"][s] = int(initpcg(Aop, b, W=W, M=M0).it)
            r = eigdefpcg(Aop, b, M=M0, W=W, spdim=args.spdim)
            iters["eigdefpcg"][s] = int(r.it)
            W = r.W
        print(f"s={s}: pcg={iters['pcg'][s]} initpcg={iters['initpcg'][s]} "
              f"eigdefpcg={iters['eigdefpcg'][s]}", flush=True)
    extra = {}
    if args.block_rhs > 0:
        from ..solvers.block_cg import block_pcg
        k = args.block_rhs
        bits = []
        for s0 in range(0, args.nreals, k):
            B = torch.stack(rhs_hist[s0:s0 + k], dim=1)
            r = block_pcg(block_op, B, M=block_precond)
            bits.extend([int(r.it)] * B.shape[1])
            print(f"blockpcg [{s0}:{s0 + B.shape[1]}]: {int(r.it)} its "
                  "(all RHS converge together)", flush=True)
        extra["blockpcg"] = np.asarray(bits, dtype=np.int64)
    for k_, v in {**iters, **extra}.items():
        print(f"{k_}: mean {v.mean():.1f}")
    tag = ".schur" if args.schur else ""
    save_npz(args, f"ex11.iters{tag}", **iters, **extra)


if __name__ == "__main__":
    main()
