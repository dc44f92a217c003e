"""Example02: single-domain KL expansion + field realization.

Port of `examples/ex02_karhunen_loeve.py` (reference
Example02_KarhunenLoeve.jl:39-46). The realization is drawn from a torch
generator seeded --seed (the JAX driver's PRNG key of the same seed is a
different stream).
"""

from __future__ import annotations

from .common import base_parser, build_fem, build_kl, init_backend, save_npz


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--nev", type=int, default=50)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..kl.synthesis import draw, get_kl_coordinates

    mesh, maps, asm = build_fem(args)
    cov, M, lam, psi = build_kl(args, mesh, nev=args.nev)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    xi, g = draw(lam, psi, gen)
    # round-trip check (SURVEY §4.2)
    chi = get_kl_coordinates(g, lam, psi, M)
    print(f"kept {len(lam)} modes; latent round-trip max err "
          f"{float(torch.max(torch.abs(chi - xi))):.2e}")
    save_npz(args, "ex02.kl", lam=lam, psi=psi, g=g)


if __name__ == "__main__":
    main()
