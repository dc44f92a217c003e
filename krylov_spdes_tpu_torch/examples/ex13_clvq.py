"""Example13: CLVQ vs k-means distortion/timing study.

Port of `examples/ex13_clvq.py` (reference Example13_CLVQ_Functions.jl:
71-159). The samples come from a torch generator seeded 987654321, the
seed of the JAX driver's PRNG key (a different stream).
"""

from __future__ import annotations

import time

import numpy as np

from .common import base_parser, init_backend, save_npz, sync


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--ns", type=int, default=20000)
    p.add_argument("--Ps", default="4,16,64")
    p.add_argument("--nKLs", default="4,16")
    args = p.parse_args(argv)
    device, dtype = init_backend(args)
    import torch
    from ..quantization.quantizers import (clvq, distortion,
                                           get_gain_sequence, kmeans)

    lam_full = np.exp(-0.4 * np.arange(64))
    results = {}
    for P in map(int, args.Ps.split(",")):
        for nKL in map(int, args.nKLs.split(",")):
            gen = torch.Generator(device=device).manual_seed(987_654_321)
            lam = torch.as_tensor(lam_full[:nKL], dtype=dtype, device=device)
            X = torch.randn(args.ns, nKL, generator=gen, dtype=dtype,
                            device=device) * torch.sqrt(lam)
            sync(args)
            t0 = time.perf_counter()
            Ck, _ = kmeans(X, P, iters=50)
            sync(args)
            dt_km = time.perf_counter() - t0
            w_km = float(distortion(X, Ck))
            gains = get_gain_sequence(1.0, 0.1, 0.2, 0.51, args.ns,
                                      device=device, dtype=dtype)
            t0 = time.perf_counter()
            Cc, _ = clvq(X, X[:P], gains)
            sync(args)
            dt_cl = time.perf_counter() - t0
            w_cl = float(distortion(X, Cc))
            print(f"P={P:3d} nKL={nKL:3d}: kmeans w2={w_km:.4f} "
                  f"({dt_km:.2f}s)  clvq w2={w_cl:.4f} ({dt_cl:.2f}s)",
                  flush=True)
            results[f"P{P}_nKL{nKL}"] = np.asarray(
                [w_km, dt_km, w_cl, dt_cl])
    save_npz(args, "ex13.clvq", **results)


if __name__ == "__main__":
    main()
