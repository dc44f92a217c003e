"""Example05: distributed two-level KL over ranks.

Port of `examples/ex05_kl_dd_distributed.py`, which mirrors
the reference's Example05_KarhunenLoevePllDomainDecomposition.jl:45-57
(pll_compute_kl with dynamic scheduling over SSH workers; validated config
nnode=320_000 / ndom=80, Example05:31-34). After a light host pass that
builds integer tables, every numeric stage runs on the device
(kl/dd_device.py): the local eigensolves as batched generalized eighs, the
reduced-covariance pair tiles split over the ranks' 'dom' axis with one
psum. `--host-pipeline` runs the host two-level pipeline (kl/dd.py) with the
local eigensolves split over the ranks instead.

Run on two ranks on the CPU, or on the card:
  python -m krylov_spdes_tpu_torch.examples.ex05_kl_dd_distributed --cpu \\
      --ranks 2 --ndom 16
  python -m krylov_spdes_tpu_torch.examples.ex05_kl_dd_distributed --ranks 2

Reference scale point (320k DoF / 80 dom):
  ... --nnode 320000 --ndom 80 --nev 50
"""

from __future__ import annotations

import time

import numpy as np

from ..parallel import is_coordinator
from .common import (add_ranks_flag, base_parser, build_fem, host,
                     init_backend, run_ranks, save_npz, sync)


def rank_main(args):
    """One rank: the whole two-level KL, its stages split over the ranks.
    Returns λ, the captured variance and the wall seconds (every rank
    holds the whole result)."""
    import torch
    from ..fem import mesh_partition
    from ..kl.covariance import make_cov
    from ..parallel import make_mesh

    mesh, maps, asm = build_fem(args)
    cov = make_cov(args.model, args.sig2, args.L)
    ndom = args.ndom
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    dev_mesh = make_mesh(n_dom=args.ranks, n_chain=1)
    print(f"{ndom} subdomains over {args.ranks} rank(s); nnode={mesh.nnode}")

    sync(args)
    t0 = time.perf_counter()
    if args.host_pipeline:
        from ..kl import dd as kldd
        sub = kldd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom,
                                     dtype=args.dtype, device=args.device)
        lam_d, phi_d, m_d, energy = kldd.solve_local_kls(
            sub, mesh.points, cov, args.nev, relative=args.relative_local,
            verbose=False, mesh=dev_mesh)
        print(f"local solves done; m_d in [{m_d.min()}, {m_d.max()}]")
        K = kldd.assemble_reduced_covariance(sub, mesh.points, cov, phi_d,
                                             forget=args.forget)
        lam, psi = kldd.solve_global_reduced_kl(
            mesh.nnode, K, energy, sub, phi_d,
            relative=args.relative_global, verbose=True)
    else:
        from ..kl.dd_device import compute_dd_kl_device
        # the randomized local solver's start block from a generator
        # seeded 0 (the JAX package draws it from PRNGKey(0))
        gen = torch.Generator(device=args.device).manual_seed(0)
        lam, psi = compute_dd_kl_device(
            mesh.cells, mesh.points, epart, ndom, cov, nev=args.nev,
            relative_local=args.relative_local,
            relative_global=args.relative_global, forget=args.forget,
            dom_chunk=args.dom_chunk, pair_chunk=args.pair_chunk,
            mesh=dev_mesh, verbose=True, local_eig=args.local_eig,
            max_modes=args.max_modes, dtype=args.dtype, device=args.device,
            generator=gen)
    lam, psi = host(lam), host(psi)
    sync(args)
    wall = time.perf_counter() - t0
    captured = float(np.sum(lam)) / (args.sig2 * 1.0)  # unit-square area
    print(f"distributed two-level KL: {len(lam)} global modes, "
          f"captured variance {captured:.4f}, wall {wall:.1f}s "
          f"({'host' if args.host_pipeline else 'device'} pipeline)")
    if is_coordinator():
        if args.summary_only:
            save_npz(args, f"ndom{ndom}.ex05.kl-dd-pll.summary",
                     lam=np.asarray(lam), wall=np.float64(wall),
                     captured=np.float64(captured),
                     relative_global=np.float64(args.relative_global),
                     local_eig=np.bytes_(args.local_eig))
        else:
            save_npz(args, f"ndom{ndom}.ex05.kl-dd-pll", lam=lam, psi=psi,
                     wall=np.float64(wall), captured=np.float64(captured))
    return dict(lam=lam, captured=captured, wall=wall,
                psum_calls=dev_mesh.psum_calls,
                psum_bytes=dev_mesh.psum_bytes)


def parser():
    p = add_ranks_flag(base_parser(__doc__))
    p.add_argument("--nev", type=int, default=30)
    p.add_argument("--forget", type=float, default=1e-6)
    p.add_argument("--relative-local", type=float, default=0.99)
    p.add_argument("--relative-global", type=float, default=0.99)
    p.add_argument("--dom-chunk", type=int, default=None)
    p.add_argument("--pair-chunk", type=int, default=64)
    p.add_argument("--max-modes", type=int, default=None,
                   help="cap on kept global modes; when nred >> cap the "
                        "reduced eigensolve runs Lanczos (scipy eigsh) "
                        "instead of the full O(nred^3) eigh, required at "
                        "the 1M/2M presets where nred = ndom*nev ~ 17k")
    p.add_argument("--host-pipeline", action="store_true",
                   help="host two-level pipeline (kl/dd.py) instead of the "
                        "device-resident one")
    p.add_argument("--local-eig", default="auto",
                   choices=["auto", "eigh", "randomized"],
                   help="stage-A local eigensolver: dense batched eigh, or "
                        "subspace iteration from a seeded start block "
                        "(auto: eigh)")
    p.add_argument("--summary-only", action="store_true",
                   help="archive lam/captured only (skip the (nnode, nmode) "
                        "psi payload: at 1M DoF psi alone is ~1 GB)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    init_backend(args)
    # pad ndom to a multiple of the ranks so the dom axis splits evenly
    args.ndom = ((args.ndom + args.ranks - 1) // args.ranks) * args.ranks
    return run_ranks(args, rank_main)


if __name__ == "__main__":
    main()
