"""Example08: parallel (sharded) Schur-DD solve.

Port of `examples/ex08_dd_parallel.py`. The reference's Example08/10 are
"work in progress" stubs; the sketch in
Fem/EllipticPdePllDomainDecomposition.jl:1-19 (a commented-out `@distributed
(+)` Schur matvec) is here a real sharded solve: each rank owns a share of
the subdomains' batched blocks and the Γ scatter-add is a sum over the
ranks (`parallel.shard_schur_operator`).

Run on two ranks on the CPU, or on the card:
  python -m krylov_spdes_tpu_torch.examples.ex08_dd_parallel --cpu --ranks 2
  python -m krylov_spdes_tpu_torch.examples.ex08_dd_parallel --ranks 2
"""

from __future__ import annotations

import numpy as np

from ..parallel import is_coordinator
from .common import (add_ranks_flag, base_parser, build_dd, build_fem, host,
                     init_backend, run_ranks, save_npz)


def rank_main(args):
    """One rank: the whole problem, its share of the Schur blocks, the
    NN-PCG solve. Returns `it`, the recursive relative residual and x."""
    import torch
    from ..fem import assemble_dd_values
    from ..fem.schur import (get_schur_rhs,
                             prepare_neumann_neumann_schur_precond,
                             prepare_schur_operator)
    from ..parallel import make_mesh, shard_schur_operator
    from ..solvers.cg import pcg

    mesh, maps, asm = build_fem(args)
    epart, part, plan = build_dd(args, mesh, maps)
    rng = np.random.default_rng(args.seed)
    coeff = torch.as_tensor(np.exp(rng.normal(size=mesh.nnode)),
                            dtype=args.dtype, device=args.device)

    dev_mesh = make_mesh(n_dom=args.ranks, n_chain=1)
    A_II, A_IG, A_GGd, b_I, b_G = assemble_dd_values(plan, coeff)
    S = prepare_schur_operator(plan, part, A_II, A_IG, A_GGd)
    S = shard_schur_operator(S, dev_mesh)
    b_s = get_schur_rhs(S, b_I, b_G)
    Pnn = prepare_neumann_neumann_schur_precond(S)
    r = pcg(S, b_s, M=Pnn)
    rel = float(r.history()[-1] / np.linalg.norm(host(b_s)))
    print(f"sharded NN-PCG over {args.ranks} rank(s): {int(r.it)} iters, "
          f"rel {rel:.2e}")
    rank0 = is_coordinator()
    if rank0:
        save_npz(args, f"ndom{args.ndom}.ex08", iters=np.asarray([int(r.it)]))
    return dict(it=int(r.it), rel=rel, x=host(r.x) if rank0 else None,
                psum_calls=dev_mesh.psum_calls)


def parser():
    return add_ranks_flag(base_parser(__doc__))


def main(argv=None):
    args = parser().parse_args(argv)
    init_backend(args)
    args.ndom = ((args.ndom + args.ranks - 1) // args.ranks) * args.ranks
    return run_ranks(args, rank_main)


if __name__ == "__main__":
    main()
