"""Where a preconditioner apply's time goes on one GPU, and how accurate the
card's float32 symmetric eigensolver is on DDLR's H.

    python3 krylov_spdes_tpu_torch/bench/precond_profile.py

Applies: the constant (ξ = 0) builds of chip_smoke.py's ex06_certified arms
on its general DD plan (get_mesh(32000), 30 subdomains through the C++
partitioner): LORASC (nvec 25, ε 0.01), AMG, block-Jacobi (30 blocks) and
the stencil AMG. For each, the host-clock ms an apply (synchronised, mean
of 20), the device's busy ms an apply and the device operations that take
the most device and host time (torch.profiler, 5 applies).

Eigensolver: DDLR's H = Eᵀ A0⁻¹ E (precond/dd_preconds.py) at
precond_apply's size (get_mesh(4000), 20 subdomains, chip_smoke.py's
seeded field), formed in float32 on the card and on the CPU, and in float64
on the CPU; the relative error of H and of its eigenvalues from
torch.linalg.eigvalsh in float32 (cuSOLVER on the card, LAPACK on the CPU)
and in float64, all against the float64 H's eigenvalues. One JSON line per
measurement.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402
from krylov_spdes_tpu_torch import fem  # noqa: E402
from krylov_spdes_tpu_torch.fem import schur  # noqa: E402
from krylov_spdes_tpu_torch.ops.stencil import build_stencil_op  # noqa: E402
from krylov_spdes_tpu_torch.precond import (  # noqa: E402
    amg_precond, block_jacobi_precond, prepare_lorasc_precond)
from krylov_spdes_tpu_torch.precond import dd_preconds as ddp  # noqa: E402
from krylov_spdes_tpu_torch.precond.stencil_amg import (  # noqa: E402
    stencil_amg_precond)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_dir(x, y):
    return 0.0 * x


def general_plan(nnode, ndom, device, dtype):
    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = fem.mesh_partition(mesh.cells, mesh.points, ndom,
                                  mesh.cell_neighbors, use_native=True)
    part = fem.set_subdomains(mesh.cells, epart, maps, ndom)
    plan = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part,
                                   maps, f_src, u_dir, device=device,
                                   dtype=dtype)
    return mesh, maps, epart, part, plan


def applies(card):
    mesh, maps, _, part, plan = general_plan(cs.DD_NNODE, cs.DD_NDOM, "cuda",
                                             torch.float32)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_dir)
    ones = torch.ones(mesh.nnode, device="cuda")
    A, _ = fem.do_isotropic_elliptic_assembly(asm, ones)
    S = schur.prepare_schur_operator(plan, part,
                                     *fem.assemble_dd_values(plan, ones)[:3])
    m1 = int(round(np.sqrt(mesh.nnode)))
    St = build_stencil_op(A, maps, (m1, m1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = torch.randn(maps.n_free, device="cuda", generator=gen)
    r_full = torch.randn(St.n, device="cuda", generator=gen)
    builds = {
        "lorasc": lambda: prepare_lorasc_precond(
            S, part, maps, nvec=min(25, part.n_gamma // 2),
            eps_threshold=0.01),
        "amg": lambda: amg_precond(A),
        "block_jacobi": lambda: block_jacobi_precond(A, cs.DD_NDOM),
        "stencil_amg": lambda: stencil_amg_precond(St),
    }
    for name, build in builds.items():
        M = build()
        x = r_full if name == "stencil_amg" else r
        for _ in range(3):
            M(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            M(x)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                M(x)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        top = lambda key: [  # noqa: E731
            dict(op=e.key[:80], ms=getattr(e, key) / 5e3, calls=e.count // 5)
            for e in sorted(ev, key=lambda e: -getattr(e, key))[:4]]
        print(json.dumps(dict(
            measure="apply", precond=name, nnode=mesh.nnode, ndom=cs.DD_NDOM,
            nI=plan.nI, nG=plan.nG, n_gamma=part.n_gamma, ms_an_apply=wall,
            device_busy_ms=sum(e.self_device_time_total for e in ev) / 5e3,
            launches=sum(e.count for e in ev
                         if e.key == "cudaLaunchKernel") // 5,
            top_device=top("self_device_time_total"),
            top_host=top("self_cpu_time_total"), card=card)), flush=True)


def ddlr_h(S, A_II, imask):
    """prepare_ddlr_precond's H (α = 1)."""
    dt, dev, n = S.A_IG.dtype, S.A_IG.device, S.n_gamma
    I_G = torch.eye(n, dtype=dt, device=dev)
    L0_G = torch.linalg.cholesky(ddp.assemble_gamma_matrix(S) + I_G)
    nI = A_II.shape[1]
    A0_I = (A_II + S.A_IG @ S.A_IG.transpose(-1, -2)) * imask[:, :, None] \
        * imask[:, None, :] + (1.0 - imask)[:, :, None] * torch.eye(
            nI, dtype=dt, device=dev)
    Xg = I_G[S.gammad_to_gamma] * S.gmask[:, :, None]
    ZI = schur.interior_solve(torch.linalg.cholesky(A0_I), S.A_IG @ Xg)
    ZG = ddp._solve_upper(L0_G.T, ddp._solve_lower(L0_G, -I_G))
    H = ddp._gamma_rows(S, (S.A_IG.transpose(-1, -2) @ ZI)
                        * S.gmask[:, :, None]) - ZG
    return (H + H.T) / 2


def eigensolver(card):
    mesh, maps, epart, part, plan64 = general_plan(
        cs.PA_NNODE, cs.PA_NDOM, "cpu", torch.float64)
    lam, psi = cs.sine_basis(mesh.points)
    xi = np.random.default_rng(0).normal(size=lam.shape[0])
    coeff = torch.as_tensor(np.exp(psi @ (np.sqrt(lam) * xi)))
    blocks64 = fem.assemble_dd_values(plan64, coeff)
    out = {}
    for key, dev, dt in (("cpu_float64", "cpu", torch.float64),
                         ("cpu_float32", "cpu", torch.float32),
                         ("card_float32", "cuda", torch.float32)):
        plan = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part,
                                       maps, f_src, u_dir, device=dev,
                                       dtype=dt)
        bl = [b.to(dev, dt) for b in blocks64]
        S = schur.prepare_schur_operator(plan, part, *bl[:3])
        H = ddlr_h(S, bl[0], plan.imask)
        out[key] = (H.double().cpu(), torch.linalg.eigvalsh(H).double().cpu(),
                    torch.linalg.eigvalsh(H.double()).cpu())
    H64, w64, _ = out["cpu_float64"]
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)  # noqa: E731
                             / torch.linalg.vector_norm(b))
    for key in ("cpu_float32", "card_float32"):
        H, w, w_of_64 = out[key]
        print(json.dumps(dict(
            measure="eigh", H_of=key, n=int(H.shape[0]), H_rel_err=rel(H, H64),
            eigvalsh_float32_rel_err=rel(w, w64),
            eigvalsh_float64_rel_err=rel(w_of_64, w64),
            eigvalsh_float32_max_abs_err=float((w - w64).abs().max()),
            card=card)), flush=True)


def main():
    if not torch.cuda.is_available():
        print("precond_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    applies(card)
    eigensolver(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
