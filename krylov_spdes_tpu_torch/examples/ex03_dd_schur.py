"""Example03: domain-decomposition / Schur showcase with cross-checks.

Port of `examples/ex03_dd_schur.py` (reference
Example03_EllipticPdeDomainDecomposition.jl:78-320): matrix-free vs
assembled Schur apply agreement, DD vs monolithic solution agreement,
NN-PCG, deflated NN-PCG, LORASC-PCG (plus the DDLR/NN-induced paths the
reference keeps commented out, exposed here behind flags).
"""

from __future__ import annotations

import numpy as np

from .common import (base_parser, build_dd, build_fem, host, init_backend,
                     save_npz, uex)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--with-ddlr", action="store_true")
    p.add_argument("--with-nn-induced", action="store_true")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..fem import assemble_dd_values, do_isotropic_elliptic_assembly
    from ..fem.schur import (assembled_schur_operator, get_schur_rhs,
                             get_subdomain_solutions,
                             merge_subdomain_solutions,
                             prepare_neumann_neumann_schur_precond,
                             prepare_schur_operator)
    from ..precond.dd_preconds import (prepare_ddlr_precond,
                                       prepare_lorasc_precond,
                                       prepare_nn_induced_precond)
    from ..solvers.cg import cg, pcg
    from ..solvers.defcg import eigdefpcg
    from ..solvers.eigcg import eigpcg

    mesh, maps, asm = build_fem(args)
    epart, part, plan = build_dd(args, mesh, maps)
    rng = np.random.default_rng(args.seed)
    coeff = np.exp(rng.normal(size=mesh.nnode))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731

    A_II, A_IG, A_GGd, b_I, b_G = assemble_dd_values(plan, t(coeff))
    S = prepare_schur_operator(plan, part, A_II, A_IG, A_GGd)
    b_s = get_schur_rhs(S, b_I, b_G)

    # cross-check 1: matrix-free vs assembled Schur apply (Example03:175)
    Sa = assembled_schur_operator(S)
    x = t(rng.normal(size=part.n_gamma))
    diff = host(S(x) - Sa(x))
    print(f"apply cross-check extrema: ({diff.min():.2e}, {diff.max():.2e})")

    # Schur solves
    Pnn = prepare_neumann_neumann_schur_precond(S)
    r_nn = pcg(S, b_s, M=Pnn)
    print(f"NN-PCG on Schur: {int(r_nn.it)} iters")
    nv = part.ndom // 2 or 2
    W = eigpcg(S, b_s, M=Pnn, nvec=nv, spdim=3 * nv + 1).W
    r_def = eigdefpcg(S, b_s, M=Pnn, W=W, spdim=3 * nv + 1)
    print(f"deflated NN-PCG on Schur: {int(r_def.it)} iters")

    # cross-check 2: DD vs monolithic solution (Example03:204)
    u_I = get_subdomain_solutions(S, r_nn.x, b_I)
    u_dd = merge_subdomain_solutions(part, maps, mesh.points, uex, r_nn.x,
                                     u_I)
    A, b = do_isotropic_elliptic_assembly(asm, coeff)
    u_mono = np.zeros(mesh.nnode)
    u_mono[maps.free_l2g] = host(cg(A, b, rtol=1e-10).x)
    d = u_dd - u_mono
    print(f"solution cross-check extrema: ({d.min():.2e}, {d.max():.2e})")

    # LORASC on the full system, plain and deflated (Example03 README:
    # "shows effect of deflation on LorascPreconditioner for A u = b")
    M_lor = prepare_lorasc_precond(S, part, maps,
                                   nvec=min(25, part.n_gamma // 2),
                                   eps_threshold=0.01)
    r_lor = pcg(A, b, M=M_lor)
    print(f"LORASC-PCG on full system: {int(r_lor.it)} iters")
    nv = 8
    W2 = eigpcg(A, b, M=M_lor, nvec=nv, spdim=2 * nv + 4).W
    r_lor_def = eigdefpcg(A, b, M=M_lor, W=W2, spdim=2 * nv + 4)
    print(f"deflated LORASC-PCG: {int(r_lor_def.it)} iters")

    if args.with_ddlr:
        M_ddlr = prepare_ddlr_precond(S, part, maps, A_II, plan.imask)
        r = pcg(A, b, M=M_ddlr)
        print(f"DDLR-PCG: {int(r.it)} iters (experimental, edge partitions)")
    if args.with_nn_induced:
        M_nni = prepare_nn_induced_precond(S, part, maps)
        rW = eigpcg(A, b, M=M_nni, nvec=8, spdim=20)
        r = eigdefpcg(A, b, M=M_nni, W=rW.W, spdim=20)
        print(f"NN-induced eigdefpcg: {int(r.it)} iters (experimental)")

    save_npz(args, f"ndom{args.ndom}.ex03",
             iters=np.asarray([int(r_nn.it), int(r_def.it), int(r_lor.it)]),
             apply_err=np.abs(diff).max(), sol_err=np.abs(d).max())


if __name__ == "__main__":
    main()
