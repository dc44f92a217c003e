"""The Schur-DD step in float32 on the card against the host: the two
float32 questions of the DD step.

1. `_masked_pinv` (fem/schur.py, the NN preconditioner's pinv; rule λ >
   √eps·max|λ|, float32's √eps = 3.5e-4): along one chain at bench.py's
   DD protocol (get_mesh(32000), 30 tiles, nvec 30, spdim 90, a seed and
   9 steps), the kept eigenvalues per tile of each field's float32 blocks
   on the card, the same blocks through the host's LAPACK (what the JAX
   package's rule keeps on them), and a float64 eigh of the blocks under
   float32's rule; each eigensolver's largest eigenvalue error against
   float64 (relative to max|λ|), and the pinv's ms on the card either way.
2. The interface solve's `it` under last-bit changes of the deflation
   basis: 4 chains stepped by the batched step (base_key 10, 2 steps); on
   each post-draw field the recycled eigDef-PCG solve from W and 4 copies
   of W changed in their last bit, on the card, on the host, and on the
   card with the solver's small dense algebra (eigh, svd, cholesky,
   triangular solves, qr) in float64. The fields and bases go to
   `<out>/dd_float32.npz`; `tests/test_torch_float32_dd.py` runs the JAX
   package in float32 on one of them.

Prints one JSON line a part. On the card:

  python3 krylov_spdes_tpu_torch/bench/dd_float32.py [--out build/dd_float32]

`--cpu` runs both sides on the CPU (a rehearsal; BENCH_DD_NNODE,
BENCH_DD_NDOM, BENCH_DD_NVEC shrink it).
"""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from krylov_spdes_tpu_torch.bench.bench import dd_sizes  # noqa: E402
from krylov_spdes_tpu_torch.bench.bench_chain import sine_basis  # noqa: E402


def perturbed(b, n, seed=1):
    """b, and n copies of b with every entry scaled by 1 + 2⁻²³·ξ, ξ ∈
    {−1, 0, 1} (a last-bit change); also the ξ."""
    import torch
    gen = torch.Generator(device=b.device).manual_seed(seed)
    xis = [torch.randint(-1, 2, b.shape, generator=gen, device=b.device)
           for _ in range(n)]
    return [b] + [b * (1 + 2.0 ** -23 * xi.to(b.dtype)) for xi in xis], xis


def clone_state(s):
    """A sampler state with copies of its generators."""
    import torch

    def copy(gen):
        out = torch.Generator(device=gen.device)
        out.set_state(gen.get_state())
        return out
    gen = [copy(g) for g in s.gen] if isinstance(s.gen, list) else copy(s.gen)
    return dataclasses.replace(s, gen=gen)


def pinv_f64_eigh(Sd, gmask, return_kept=False):
    """`_masked_pinv` with its eigh in float64 and float32's √eps rule,
    rounded back."""
    import torch
    lam, Q = torch.linalg.eigh(Sd.double())
    tol = torch.finfo(Sd.dtype).eps ** 0.5 * lam.abs().amax(-1, keepdim=True)
    keep = lam > tol
    linv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
    P = (Q * linv[..., None, :]) @ Q.transpose(-1, -2)
    P = (P * gmask[..., :, None] * gmask[..., None, :]).to(Sd.dtype)
    return (P, keep.sum(-1)) if return_kept else P


class Float64SmallAlgebra:
    """torch.linalg's dense factorisations run in float64 on float32
    inputs, their results rounded back, while the context is open."""
    NAMES = ("eigh", "eigvalsh", "svd", "cholesky", "solve_triangular", "qr",
             "solve")

    def __enter__(self):
        import torch
        self.saved = {k: getattr(torch.linalg, k) for k in self.NAMES}
        for k, fn in self.saved.items():
            setattr(torch.linalg, k, self._up(fn))

    def __exit__(self, *exc):
        import torch
        for k, fn in self.saved.items():
            setattr(torch.linalg, k, fn)

    @staticmethod
    def _up(fn):
        import torch

        def down(o):
            return (o.float() if torch.is_tensor(o) and o.is_floating_point()
                    else o)

        def f(*a, **kw):
            if not any(torch.is_tensor(x) and x.dtype == torch.float32
                       for x in a):
                return fn(*a, **kw)
            out = fn(*[x.double() if torch.is_tensor(x) else x for x in a],
                     **kw)
            return (type(out)(tuple(down(o) for o in out))
                    if isinstance(out, tuple) else down(out))
        return f


def main(argv=None):
    import torch
    from krylov_spdes_tpu_torch import chains, dd_chains, fem
    from krylov_spdes_tpu_torch.config import config
    from krylov_spdes_tpu_torch.fem import dd_stencil, schur
    from krylov_spdes_tpu_torch.solvers.defcg import _eigdef_impl
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default="build/dd_float32")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to rehearse on the "
                           "CPU")
    dev = "cpu" if args.cpu else "cuda"
    dt = torch.float32
    config.device = dev
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    (nnode, ndom, nvec, spdim, maxit), cfg = dd_sizes()
    mesh = fem.get_mesh(nnode, seed=0)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    plans = {}
    for d in (dev, "cpu"):
        _, part, plans[d] = fem.prepare_dd_stencil_assembly(
            mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x,
            ndom, dtype=dt, device=d)
    lam, psi = sine_basis(mesh.points)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    lam, psi = t(lam), t(psi)
    rtol = chains.effective_rtol(dt)

    # ---- 1. the pinv's kept counts along one chain -------------------------
    state = chains.chain_state(chains.prepare_chain_states(
        lam, psi, 1, device=dev, dtype=dt), 0)
    W, it0, _ = dd_chains.seed_dd_chain(plans[dev], part, state, nvec, spdim,
                                        maxit)
    step = dd_chains.make_dd_chain_step(plans[dev], part, nvec=nvec,
                                        spdim=spdim, maxit=maxit)
    fields, its = [state.g], [int(it0)]
    for _ in range(9):
        state, W, it, _ = step(state, W)
        fields.append(state.g)
        its.append(int(it))
    rows = []
    for g in fields:
        S = dd_stencil.condense_dd_stencil(plans[dev], torch.exp(g))[0]
        Sd = schur.assemble_local_schurs(S)
        kept = {"card": schur._masked_pinv(Sd, S.gmask, return_kept=True)[1],
                "host": schur._masked_pinv(Sd.cpu(), S.gmask.cpu(),
                                           return_kept=True)[1],
                "f64_eigh": pinv_f64_eigh(Sd, S.gmask, return_kept=True)[1]}
        l64 = torch.linalg.eigvalsh(Sd.double()).cpu()
        scale = l64.abs().amax(-1, keepdim=True)
        err = {k: float(((torch.linalg.eigvalsh(a).double().cpu() - l64).abs()
                         / scale).max())
               for k, a in (("card", Sd), ("host", Sd.cpu()))}
        ms = {}
        for k, fn in (("float32", schur._masked_pinv),
                      ("f64_eigh", pinv_f64_eigh)):
            fn(Sd, S.gmask)
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                fn(Sd, S.gmask)
            sync()
            ms[k] = 1e3 * (time.perf_counter() - t0) / 5
        rows.append(dict(
            kept_card=kept["card"].tolist(),
            card_minus_host=(kept["card"].cpu() - kept["host"]).tolist(),
            f64_eigh_minus_card=(kept["f64_eigh"] - kept["card"]).tolist(),
            n_gammad=S.gmask.sum(1).int().tolist(),
            eig_err_card=err["card"], eig_err_host=err["host"],
            pinv_ms=ms))
    print(json.dumps({"part": "masked_pinv", "device": dev, "config": cfg,
                      "chain_its": its, "fields": rows}), flush=True)

    # ---- 2. `it` from last-bit copies of W, card / host / float64 algebra --
    def solve_it(d, g, Wc):
        A, M, b = dd_chains._dd_system(plans[d], part, g.to(d))
        return int(_eigdef_impl(A, M, b, torch.zeros_like(b), Wc.to(d), nvec,
                                spdim, maxit, rtol, True, True)[1])

    states = chains.prepare_chain_states(lam, psi, 4, base_key=10,
                                         device=dev, dtype=dt)
    Wb, its0 = dd_chains.seed_dd_chains_batched(plans[dev], part, states,
                                                nvec, spdim, maxit)
    bstep = dd_chains.make_batched_dd_chain_step(plans[dev], part, nvec=nvec,
                                                 spdim=spdim, maxit=maxit)
    saved = dict(g=[], W=[], xi=[])
    for k in range(2):
        copies = [perturbed(Wb[c], 4) for c in range(4)]
        states, Wn, itsb, _ = bstep(clone_state(states), Wb)
        rec = dict(part="it_spread", step=k, seed_its=its0.tolist(),
                   batched=itsb.tolist())
        for name, d in (("card", dev), ("host", "cpu")):
            rec[name] = [[solve_it(d, states.g[c], Wc) for Wc in cs]
                         for c, (cs, _) in enumerate(copies)]
        with Float64SmallAlgebra():
            rec["card_f64_small_algebra"] = [
                [solve_it(dev, states.g[c], Wc) for Wc in cs]
                for c, (cs, _) in enumerate(copies)]
        print(json.dumps(rec), flush=True)
        saved["g"].append(states.g.cpu().numpy())
        saved["W"].append(Wb.cpu().numpy())
        saved["xi"].append(np.stack([np.stack([x.cpu().numpy() for x in xs])
                                     for _, xs in copies]).astype(np.int8))
        Wb = Wn
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "dd_float32.npz")
    np.savez_compressed(path, **{k: np.stack(v) for k, v in saved.items()},
                        nnode=nnode, ndom=ndom, nvec=nvec, spdim=spdim,
                        maxit=maxit)
    print(f"saved {path}", flush=True)


if __name__ == "__main__":
    main()
