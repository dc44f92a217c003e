"""Example18: 2D clustering visualization study.

Port of `examples/ex18_clustering2d.py` (reference
Example18_Clustering2D*.jl): k-means in a 2D latent subspace; writes
samples, centroids and assignments for plotting (the reference renders
convex hulls with matplotlib). The samples come from a torch generator
seeded --seed (the JAX driver's PRNG key of that seed is another stream).
"""

from __future__ import annotations

from .common import base_parser, init_backend, save_npz


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--P", type=int, default=6)
    p.add_argument("--ns", type=int, default=3000)
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..quantization.quantizers import distortion, kmeans

    lam2 = torch.tensor([1.0, 0.4], dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    X = torch.randn(args.ns, 2, generator=gen, dtype=dtype,
                    device=device) * torch.sqrt(lam2)
    C, _ = kmeans(X, args.P, iters=100)
    d2 = (torch.sum(X ** 2, 1)[:, None] - 2 * X @ C.T
          + torch.sum(C ** 2, 1)[None, :])
    a = torch.argmin(d2, dim=1)
    print(f"P={args.P}: distortion {float(distortion(X, C)):.4f}")
    save_npz(args, f"P{args.P}.ex18", X=X, centroids=C, assignments=a)


if __name__ == "__main__":
    main()
