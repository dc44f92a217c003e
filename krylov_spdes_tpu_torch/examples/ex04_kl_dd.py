"""Example04: serial two-level KL by domain decomposition vs single-domain.

Port of `examples/ex04_kl_dd.py` (reference
Example04_KarhunenLoeveDomainDecomposition.jl:68-100).
"""

from __future__ import annotations

import numpy as np

from .common import base_parser, build_fem, build_kl, host, init_backend, \
    save_npz


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--nev", type=int, default=40)
    p.add_argument("--forget", type=float, default=-1.0)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    from ..fem import mesh_partition
    from ..kl.covariance import make_cov
    from ..kl.dd import compute_dd_kl
    from ..kl.helper import suggest_parameters

    mesh, maps, asm = build_fem(args)
    cov = make_cov(args.model, args.sig2, args.L)
    epart, _ = mesh_partition(mesh.cells, mesh.points, args.ndom,
                              mesh.cell_neighbors)
    rel_local, rel_global = suggest_parameters(args.nnode)
    lam2, psi2 = compute_dd_kl(mesh.cells, mesh.points, epart, args.ndom,
                               cov, nev=args.nev, relative_local=rel_local,
                               relative_global=rel_global,
                               forget=args.forget, verbose=True,
                               dtype=dtype, device=device)
    lam2, psi2 = host(lam2), host(psi2)
    print(f"two-level KL: {len(lam2)} global modes")
    # compare against single-domain (Example02) when affordable
    if mesh.nnode <= 5000:
        cov1, M, lam1, psi1 = build_kl(args, mesh, nev=args.nev)
        lam1 = host(lam1)
        k = min(8, len(lam1), len(lam2))
        rel = np.abs(lam2[:k] - lam1[:k]) / lam1[:k]
        print(f"leading-{k} eigenvalue drift vs single-domain: "
              f"max {rel.max():.2e}")
    save_npz(args, f"ndom{args.ndom}.ex04.kl-dd", lam=lam2, psi=psi2)


if __name__ == "__main__":
    main()
