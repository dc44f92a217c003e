"""Shared driver scaffolding: the flags every example takes and the problem
setup they share.

Port of `examples/common.py`. The reference has no config system: every
Example*.jl hard-codes globals at the top of the file (SURVEY.md §5). Here
every driver takes CLI flags with reference-matching defaults and writes its
artifacts to --data-dir under the reference's naming convention, with the
same file names and keys as the JAX package's drivers, so either package's
archives read alike (`examples/postproc.py`, `make_protocol_plots.py`).

The drivers run on the card in float32; `--cpu` runs them on the CPU in
float64. `init_backend` picks the two and the drivers hand them explicitly
to every plan, sampler and tensor: nothing here changes the package's
`config`, so a driver called in a process leaves later calls as it found
them.
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
import torch


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--nnode", type=int, default=4000,
                   help="tentative number of mesh nodes")
    p.add_argument("--ndom", type=int, default=20, help="subdomains")
    p.add_argument("--sig2", type=float, default=1.0, help="field variance")
    p.add_argument("--L", type=float, default=0.1, help="correlation length")
    p.add_argument("--model", default="SExp", choices=["SExp", "Exp"])
    p.add_argument("--nreals", type=int, default=20, help="realizations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU in float64 (default: the CUDA card "
                        "in float32)")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--mesh", default="structured",
                   choices=["structured", "delaunay"],
                   help="structured: jittered structured-topology mesh "
                        "(stencil fast paths apply); delaunay: genuinely "
                        "unstructured triangulation (general path; pair "
                        "with ex01 --op banded for the banded matvec)")
    p.add_argument("--kl-method", default="single",
                   choices=["single", "dd"],
                   help="sampling-basis construction: single-domain KL "
                        "(Arpack-analogue, KarhunenLoeve.jl:27-193) or the "
                        "two-level DD KL device pipeline (kl/dd_device.py, "
                        "the reference's own strategy for large bases)")
    return p


def init_backend(args):
    """(device, dtype) of the run: the CPU in float64 with --cpu, else the
    CUDA card in float32. Raises when there is no CUDA device and --cpu was
    not given; it never falls back to the CPU. Also kept on `args` for the
    helpers below."""
    if args.cpu:
        device, dtype = torch.device("cpu"), torch.float64
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the drivers run on the card "
                           "(device 'cuda'); pass --cpu to run on the CPU")
    else:
        device, dtype = torch.device("cuda"), torch.float32
    args.device, args.dtype = device, dtype
    print(f"device {device.type} {str(dtype).removeprefix('torch.')}",
          flush=True)
    return device, dtype


def sync(args):
    """Wait for the work queued on the run's device (before a clock is
    read)."""
    if args.device.type == "cuda":
        torch.cuda.synchronize(args.device)


def host(a):
    """A tensor (or array) as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def fsrc(x, y):
    return -1.0 + 0.0 * x


def uex(x, y):
    return 0.0 * x


def build_fem(args):
    from ..fem import (get_delaunay_mesh, get_dirichlet_inds, get_mesh,
                       prepare_elliptic_assembly)
    if getattr(args, "mesh", "structured") == "delaunay":
        mesh = get_delaunay_mesh(args.nnode, seed=args.seed)
    else:
        mesh = get_mesh(args.nnode, jitter=0.2, seed=args.seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps, fsrc, uex,
                                    dtype=args.dtype, device=args.device)
    return mesh, maps, asm


def build_kl(args, mesh, nev=50, relative=0.995, verbose=True):
    """KL basis with artifact caching: the (λ, Ψ) pair is persisted to
    data_dir keyed by the reference's root filename (the reference's
    load_existing_* stage-skipping, Example07:24-30 / SURVEY.md §5).
    Returns (cov, M, λ, Ψ), λ and Ψ as tensors on the run's device.

    --kl-method dd builds the basis through the two-level DD KL device
    pipeline instead (kl/dd_device.py), cached under a distinct `.dd`
    suffix."""
    from ..fem import get_mass_matrix
    from ..kl.covariance import make_cov
    cov = make_cov(args.model, args.sig2, args.L)
    M = get_mass_matrix(mesh.cells, mesh.points, dtype=args.dtype,
                        device=args.device)
    t = partial(torch.as_tensor, dtype=args.dtype, device=args.device)
    method = getattr(args, "kl_method", "single")
    # the JAX package's name: a basis cached by either package loads in the
    # other
    sfx = f"kl{nev}" + (".dd" if method == "dd" else "")
    cache = os.path.join(args.data_dir,
                         f"{root_fname(args)}.seed{args.seed}.{sfx}.npz")
    if os.path.exists(cache):
        d = np.load(cache)
        if d["psi"].shape[0] == mesh.nnode:
            if verbose:
                print(f"KL basis loaded from {cache}")
            return cov, M, t(d["lam"]), t(d["psi"])
    if method == "dd":
        from ..fem import mesh_partition
        from ..kl.dd_device import compute_dd_kl_device
        # eigh cost ~ n³/ndom²: ~600-node subdomains; 0.995 energy still met
        ndom_kl = max(16, min(512, mesh.nnode // 600))
        epart, _ = mesh_partition(mesh.cells, mesh.points, ndom_kl,
                                  mesh.cell_neighbors)
        lam, psi = compute_dd_kl_device(
            mesh.cells, mesh.points, epart, ndom_kl, cov, nev=nev,
            relative_local=0.999, relative_global=relative, verbose=verbose,
            max_modes=nev, dtype=args.dtype, device=args.device)
    else:
        from ..kl.single import solve_kl
        # LOBPCG's start block from a generator seeded 0 (the JAX package's
        # default key 0)
        gen = torch.Generator(device=args.device).manual_seed(0)
        lam, psi = solve_kl(mesh.cells, mesh.points, cov, nev, M,
                            relative=relative, verbose=verbose,
                            generator=gen)
    os.makedirs(args.data_dir, exist_ok=True)
    np.savez(cache, lam=host(lam), psi=host(psi))
    return cov, M, t(host(lam)), t(host(psi))


def build_dd(args, mesh, maps):
    from ..fem import mesh_partition, prepare_dd_assembly, set_subdomains
    epart, npart = mesh_partition(mesh.cells, mesh.points, args.ndom,
                                  mesh.cell_neighbors)
    part = set_subdomains(mesh.cells, epart, maps, args.ndom)
    plan = prepare_dd_assembly(mesh.cells, mesh.points, epart, part, maps,
                               fsrc, uex, dtype=args.dtype, device=args.device)
    return epart, part, plan


def add_factor_flag(p):
    p.add_argument("--factor", default="dense",
                   choices=["dense", "banded", "stencil"],
                   help="Cholesky-preconditioner factorization: dense "
                        "(study sizes, reference CholPreconditioners.jl:5-56),"
                        " banded (host RCM + device block-tridiagonal scan, "
                        "250k+ DoF), stencil (grid-row block-tridiagonal on "
                        "structured meshes, 1M DoF)")
    return p


def cholesky_factory(args, mesh=None, maps=None):
    """SparseOp A -> preconditioner callable, per --factor. The banded and
    stencil flavors never densify: precond/block_tridiag_chol.py factors in
    O(n·m²) instead of O(n³)."""
    kind = getattr(args, "factor", "dense")
    if kind == "dense":
        from ..precond.cholesky import get_cholesky32
        return get_cholesky32
    if kind == "banded":
        from ..precond.block_tridiag_chol import get_banded_cholesky
        return partial(get_banded_cholesky, device=args.device,
                       out_dtype=args.dtype)
    if kind == "stencil":
        from ..ops.stencil import build_stencil_op, to_full_vector
        from ..precond.block_tridiag_chol import get_stencil_cholesky
        m1 = int(round(np.sqrt(mesh.nnode)))
        free = torch.as_tensor(maps.free_l2g, dtype=torch.int64,
                               device=args.device)

        def factory(A):
            M_full = get_stencil_cholesky(build_stencil_op(A, maps, (m1, m1)))

            # the stencil solves act on full grid vectors: lift the free
            # vector, solve, restrict
            def apply_free(r):
                z = M_full(to_full_vector(maps, r, mesh.nnode))
                return z[free].to(r.dtype)
            return apply_free
        return factory
    raise ValueError(kind)


def root_fname(args) -> str:
    from ..kl.helper import get_root_filename
    return get_root_filename(args.model, args.sig2, args.L, args.nnode)


def save_npz(args, name: str, **arrays):
    os.makedirs(args.data_dir, exist_ok=True)
    path = os.path.join(args.data_dir, f"{root_fname(args)}.{name}.npz")
    np.savez(path, **{k: host(v) for k, v in arrays.items()})
    print(f"saved {path}")
    return path
