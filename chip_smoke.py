#!/usr/bin/env python3
"""Drive the PyTorch port's stencil solve path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from krylov_spdes_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, drives the main path through
the port's entry points, checks the results, and prints one JSON line per
phase. Size: bench.py's system, a 500 x 500 grid (get_mesh(250000)) with
coefficient exp(0.3·N(0,1)) from numpy seed 0, float32, maxit 2000,
rtol 1e-6; then 4 seeded lognormal realizations certified at 1e-7.

Phases:
  1. build      nvcc build time; the card's name and power limit
  2. kernel_a   stencil SpMV vs its plain version; kernel, plain, library
                (torch.sparse.mm on the same operator in CSR) and bound times
  3. kernel_b   one CG sweep vs its plain version
  4. kernel_c / kernel_d   whole-solve CG / Jacobi-PCG vs their plain versions
     (before them, it_envelope: the plain solvers' float32 iteration counts
     on b and on copies of b changed in their last bit; a kernel's count
     must lie within 5% of the range they span)
  5. main_path  with every launch count set to 0: fused_pcg (B), vmem_cg (C),
                vmem_pcg (D) on the bench system, then per realization
                stencil_assemble -> refill_padded_stencil -> vmem_pcg ->
                refined_pcg (A); each solve held against solvers.cg/pcg
  6. kernels    one {"kernels": [...]} line with each kernel's launches on
                the main path (all must be > 0) and its times

The last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero; so does a host without a CUDA device, or a directory without the
port's package beside this script. The bound of a kernel is the larger of
its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
H100 SXM's published HBM rate and non-tensor float32 peak). Kernels A and
B are timed with their operands cold in the 50 MB L2, so that the HBM rate
bounds them; the run fails if any kernel's time is below its bound.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NNODE, MAXIT, RTOL, SIGMA = 250000, 2000, 1e-6, 0.3
N_REALIZATIONS = 4
L2_EVICT_BYTES = 200e6   # four times the H100's 50 MB L2


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, names=None):
    """Device time per call (ms) of the kernels fn() launches, summed from a
    torch.profiler trace (kernels whose name holds one of `names`, or all);
    None when the trace records no such device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if names is None or any(m in e.key for m in names))
    return us / reps / 1e3 if us > 0 else None


def timings(fn, reps, names=None):
    """(ms, ms_per_call, how): the kernels' device time per call from the
    profiler (or, without one, the CUDA-event time per call), and the
    CUDA-event time per call with the host's launch overhead."""
    per_call = cuda_ms(fn, reps)
    dev = device_ms(fn, reps, names)
    return (per_call, per_call, "events") if dev is None else (
        dev, per_call, "profiler")


def nbytes(a):
    """Bytes of the tensors in a (a tensor, or a dataclass of tensors)."""
    if dataclasses.is_dataclass(a):
        return sum(nbytes(getattr(a, f.name)) for f in dataclasses.fields(a))
    return a.numel() * a.element_size() if torch.is_tensor(a) else 0


def cold(fn, make_args):
    """A callable that runs fn on operands cold in the L2: each call takes
    the next of enough copies of make_args() to span L2_EVICT_BYTES, and
    keeps its outputs until that copy comes round again, so that no call
    reads or writes memory that a recent call touched."""
    first = make_args()
    n = math.ceil(L2_EVICT_BYTES / sum(nbytes(a) for a in first))
    sets = [first] + [make_args() for _ in range(n)]
    held = [None] * len(sets)
    turn = itertools.cycle(range(len(sets)))

    def call():
        i = next(turn)
        held[i] = fn(*sets[i])
    return call


NAMING = ("name", "route", "source", "replaces", "max_abs_err")


def timed(fn, reps, names, plain, plain_reps, library=None):
    """The kernel's, plain version's and library call's times: device time
    per call (profiler) and CUDA-event time per call (with host overhead)."""
    ms, ms_call, how = timings(fn, reps, names)
    plain_ms, plain_call, _ = timings(plain, plain_reps)
    lib_ms = timings(library, reps)[0] if library is not None else None
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                ms_per_call=ms_call, plain_ms_per_call=plain_call, timing=how)


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def csr_of(St):
    """The full-grid 9-point operator as a torch CSR matrix (the library
    yardstick of kernel A; the port never calls it)."""
    from krylov_spdes_tpu_torch.ops.stencil import OFFSETS
    H, W = St.H, St.W
    idx = torch.arange(H * W, device=St.planes.device).reshape(H, W)
    rows, cols, vals = [], [], []
    for k, (di, dj) in enumerate(OFFSETS):
        P = St.planes[0] + St.dir_diag if k == 0 else St.planes[k]
        i0, i1, j0, j1 = max(0, -di), min(H, H - di), max(0, -dj), min(W, W - dj)
        v = P[i0:i1, j0:j1]
        keep = v != 0
        rows.append(idx[i0:i1, j0:j1][keep])
        cols.append(idx[i0 + di:i1 + di, j0 + dj:j1 + dj][keep])
        vals.append(v[keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (H * W, H * W))
    return coo.coalesce().to_sparse_csr()


def true_relres(St, b, x, xl=None):
    """‖b − A (x + xl)‖ / ‖b‖ evaluated in float64."""
    from krylov_spdes_tpu_torch.ops.df32 import stencil_residual_df32
    xl = torch.zeros_like(x) if xl is None else xl
    rh, rl = stencil_residual_df32(St.planes, St.dir_diag, St.H, St.W, b,
                                   torch.zeros_like(b), x, xl)
    r = rh.double() + rl.double()
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b.double()))


def f32_floor(St, b, x):
    """u32·‖|A||x|‖/‖b‖: the float64 residual of rounding x to float32."""
    from krylov_spdes_tpu_torch.ops.stencil_kernel import stencil_spmv_plain
    ax = stencil_spmv_plain(St.planes.double().abs(), St.dir_diag.double().abs(),
                            x.double().abs())
    return 2.0 ** -24 * float(torch.linalg.vector_norm(ax)
                              / torch.linalg.vector_norm(b.double()))


def it_envelope(solve, b, n=5):
    """The plain solver's iteration counts on b and on n copies of b changed
    in their last bit, and the iterations its residual history on b spends
    within 1.5x above the tolerance. In float32 at this conditioning the
    residual crosses rtol·‖b‖ on a plateau, so a last-bit change moves the
    stop by up to ~15%: two orderings of the same sums can agree no closer
    than the counts this envelope spans."""
    gen = torch.Generator(device=b.device).manual_seed(1)
    r0 = solve(b)
    its = [int(r0.it)]
    for _ in range(n):
        xi = torch.randint(-1, 2, b.shape, generator=gen, device=b.device)
        its.append(int(solve(b * (1 + 2.0 ** -23 * xi.to(b.dtype))).it))
    h = r0.history()
    tol = RTOL * float(torch.linalg.vector_norm(b))
    plateau = int(np.sum((h > tol) & (h <= 1.5 * tol)))
    return its, plateau


def run(card):
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.ops import cuda_build
    from krylov_spdes_tpu_torch.ops import fused_cg as fc
    from krylov_spdes_tpu_torch.ops import stencil_kernel as sk
    from krylov_spdes_tpu_torch.ops.stencil import build_stencil_op, to_full_vector
    from krylov_spdes_tpu_torch.solvers.cg import cg, pcg
    from krylov_spdes_tpu_torch.solvers.refine import refined_pcg

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    for name in cuda_build.SOURCES:      # load (and check) every library
        cuda_build.load(name)
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         card=card)

    # ---- setup: bench.py's system, through the port's entry points ----------
    t0 = time.perf_counter()
    f_src = lambda x, y: -1.0 + 0.0 * x   # noqa: E731
    u_dir = lambda x, y: 0.0 * x          # noqa: E731
    mesh = fem.get_mesh(NNODE)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_dir)
    coeff = np.exp(SIGMA * np.random.default_rng(0).normal(size=mesh.nnode))
    A, b = fem.do_isotropic_elliptic_assembly(asm, coeff)
    H = W = int(round(np.sqrt(mesh.nnode)))
    St = build_stencil_op(A, maps, (H, W))
    b_full = to_full_vector(maps, b, mesh.nnode)
    ps = fc.build_padded_stencil(St)
    plan = fem.prepare_stencil_assembly(mesh, maps, f_src, u_dir)
    torch.cuda.synchronize()
    check(b_full.is_cuda and b_full.dtype == torch.float32,
          "entry points default to float32 on the card")
    n, RC, nnz = H * W, ps.R * ps.C, A.nnz
    emit("setup", seconds=time.perf_counter() - t0, H=H, W=W, nnz=nnz,
         K=ps.K, R=ps.R, C=ps.C)
    g = torch.Generator(device="cuda").manual_seed(0)
    kernels = {}

    # the plain solvers' float32 iteration counts under last-bit changes of
    # b: a kernel's count must lie within 5% of the range they span
    dinv = 1.0 / St.diagonal()
    envelope = {}
    for key, solve in (
            ("cg", lambda rhs: cg(St, rhs, maxit=MAXIT, rtol=RTOL)),
            ("pcg", lambda rhs: pcg(St, rhs, M=lambda v: dinv * v,
                                    maxit=MAXIT, rtol=RTOL))):
        its, plateau = it_envelope(solve, b_full)
        envelope[key] = (0.95 * min(its), 1.05 * max(its))
        emit("it_envelope", solver=key, its=its, allowed=envelope[key],
             iterations_within_1p5x_of_tol=plateau, card=card)

    def it_ok(it, key):
        lo, hi = envelope[key]
        return lo <= it <= hi

    # ---- 2. kernel A ---------------------------------------------------------
    x = torch.randn(n, generator=g, device="cuda")
    y = sk.stencil_spmv(St.planes, St.dir_diag, x)
    y0 = sk.stencil_spmv_plain(St.planes, St.dir_diag, x)
    err = float((y - y0).abs().max())
    err_rel = err / float(y0.abs().max())
    check(err_rel <= 1e-6, f"kernel A vs plain: max rel err {err_rel}")
    csr = csr_of(St)
    ylib = torch.sparse.mm(csr, x[:, None])[:, 0]
    check(rel(ylib, y0) <= 1e-5, "torch.sparse.mm yardstick disagrees")
    bnd, by = bound_ms(12 * n * 4, 18 * n)
    copies = lambda: (St.planes.clone(), St.dir_diag.clone(), x.clone())  # noqa: E731
    kernels["A"] = dict(
        name="stencil_spmv", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/stencil_spmv.cu",
        replaces="krylov_spdes_tpu/ops/pallas_stencil.py:22",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **timed(cold(sk.stencil_spmv, copies), 200, ["stencil_spmv_kernel"],
                cold(sk.stencil_spmv_plain, copies), 50,
                cold(lambda c, v: torch.sparse.mm(c, v[:, None]),
                     lambda: (csr.clone(), x.clone()))))
    # the time with the operands warm in the L2, as in a solver's loop
    warm = timings(lambda: sk.stencil_spmv(St.planes, St.dir_diag, x), 200,
                   ["stencil_spmv_kernel"])[0]
    emit("kernel_a", max_rel_err=err_rel, tolerance=1e-6, card=card,
         ms_l2_warm=warm,
         **{k: v for k, v in kernels["A"].items() if k not in NAMING})

    # ---- 3. kernel B: one sweep ---------------------------------------------
    bp = fc.pad_vec(ps, b_full)
    p = fc.pad_vec(ps, torch.randn(n, generator=g, device="cuda"))
    beta = torch.tensor(0.3, device="cuda")
    pn, ap, d = fc.cg_sweep(ps, bp, p, beta)
    pn0, ap0, d0 = fc.cg_sweep_plain(ps, bp, p, beta)
    errs = {"pn": rel(pn, pn0), "ap": rel(ap, ap0),
            "d": abs(float(d) - float(d0)) / abs(float(d0))}
    check(max(errs.values()) <= 1e-5, f"kernel B vs plain: {errs}")
    bnd, by = bound_ms((ps.K + 4) * RC * 4, 21 * n)
    copies = lambda: (dataclasses.replace(ps, planes=ps.planes.clone()),  # noqa: E731
                      bp.clone(), p.clone(), beta.clone())
    kernels["B"] = dict(
        name="cg_sweep", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/fused_cg.cu",
        replaces="krylov_spdes_tpu/ops/fused_cg.py:207",
        max_abs_err=max(float((pn - pn0).abs().max()),
                        float((ap - ap0).abs().max()), abs(float(d - d0))),
        bound_ms=bnd, bound_by=by,
        **timed(cold(fc.cg_sweep, copies), 200,
                ["cg_sweep_kernel", "sum_kernel"],
                cold(fc.cg_sweep_plain, copies), 50))
    warm = timings(lambda: fc.cg_sweep(ps, bp, p, beta), 200,
                   ["cg_sweep_kernel", "sum_kernel"])[0]
    emit("kernel_b", rel_err=errs, tolerance=1e-5, card=card,
         ms_l2_warm=warm,
         **{k: v for k, v in kernels["B"].items() if k not in NAMING})

    # ---- 4. kernels C and D: whole solves ------------------------------------
    tol2 = torch.tensor(RTOL, device="cuda") ** 2 * torch.sum(bp * bp)
    minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    for key, name, kern, plain, args, per_it, line in (
            ("C", "whole_cg", fc.whole_cg, fc.whole_cg_plain, (bp,), 27, 473),
            ("D", "whole_pcg", fc.whole_pcg, fc.whole_pcg_plain, (minv, bp),
             31, 564)):
        xk, itk, resk = kern(ps, *args, MAXIT, tol2)
        xp, itp, resp = plain(ps, *args, MAXIT, tol2)
        itk, itp = int(itk), int(itp)
        check(float(resk) ** 2 <= float(tol2) and float(resp) ** 2 <= float(tol2),
              f"kernel {key}: a solve missed its tolerance")
        check(it_ok(itk, "cg" if key == "C" else "pcg"),
              f"kernel {key}: it {itk} (plain {itp}) outside the envelope")
        err_x = rel(xk, xp)
        check(err_x <= 1e-3, f"kernel {key}: x rel err {err_x}")
        # inputs read once (planes, b, minv), x written once; the operations
        # of the iterations this run's data needed
        bnd, by = bound_ms((ps.K + len(args) + 1) * RC * 4,
                           per_it * n * (itk - 1))
        kernels[key] = dict(
            name=name, route="cuda",
            source="krylov_spdes_tpu_torch/csrc/fused_cg.cu",
            replaces=f"krylov_spdes_tpu/ops/fused_cg.py:{line}",
            max_abs_err=float((xk - xp).abs().max()), bound_ms=bnd,
            bound_by=by,
            **timed(lambda: kern(ps, *args, MAXIT, tol2), 5, ["whole_cg_kernel"],
                    lambda: plain(ps, *args, MAXIT, tol2), 1))
        emit(f"kernel_{key.lower()}", it=itk, it_plain=itp, x_rel_err=err_x,
             us_per_iteration=1e3 * kernels[key]["ms"] / (itk - 1), card=card,
             **{k: v for k, v in kernels[key].items() if k not in NAMING})

    # fixed cost of one whole-solve iteration (two grid syncs, four block
    # reductions): 11 against 211 iterations with tol² = 0, never met (in
    # float64, so that the residual recurrence does not underflow), on a
    # grid of 16 blocks and on one that fills every resident block
    for nn in (4096, 135424):
        m_s = fem.get_mesh(nn)
        maps_s = fem.get_dirichlet_inds(m_s.points, m_s.point_markers)
        A_s, b_s = fem.do_isotropic_elliptic_assembly(
            fem.prepare_elliptic_assembly(m_s.cells, m_s.points, maps_s, f_src,
                                          u_dir, dtype=torch.float64),
            np.ones(m_s.nnode))
        h = int(round(np.sqrt(m_s.nnode)))
        ps_s = fc.build_padded_stencil(build_stencil_op(A_s, maps_s, (h, h)))
        bp_s = fc.pad_vec(ps_s, to_full_vector(maps_s, b_s, m_s.nnode))
        zero = bp_s.new_zeros(())
        check(int(fc.whole_cg(ps_s, bp_s, 211, zero)[1]) == 211,
              "grid_sync: the fixed-count solve stopped early")
        t_few = cuda_ms(lambda: fc.whole_cg(ps_s, bp_s, 11, zero), 3)
        t_many = cuda_ms(lambda: fc.whole_cg(ps_s, bp_s, 211, zero), 3)
        emit("grid_sync", H=h, W=h, dtype="float64",
             blocks=fc._lib().whole_cg_grid(1, ps_s.K, 0, h, h),
             us_per_iteration=1e3 * (t_many - t_few) / 200, card=card)

    # ---- 5. the main path, with every launch count at 0 ----------------------
    counters = {"A": sk.stencil_spmv, "B": fc.cg_sweep, "C": fc.whole_cg,
                "D": fc.whole_pcg}
    for fn in counters.values():
        fn.launches = 0
    bnorm = float(torch.linalg.vector_norm(b_full))
    solves = {}
    for name, drive in (("fused_pcg", fc.fused_pcg), ("vmem_cg", fc.vmem_cg),
                        ("vmem_pcg", fc.vmem_pcg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, it, res = drive(ps, b_full, maxit=MAXIT, rtol=RTOL)
        torch.cuda.synchronize()
        solves[name] = (xs, int(it), float(res[int(it) - 1] if res.ndim else res),
                        time.perf_counter() - t0)
    realizations = []
    ps_r = ps
    for seed in range(1, N_REALIZATIONS + 1):
        c = np.exp(SIGMA * np.random.default_rng(seed).normal(size=mesh.nnode))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        St_r, b_r = fem.make_stencil_operator(plan, c)
        ps_r = fc.refill_padded_stencil(ps_r, St_r)
        x_r, it_r, res_r = fc.vmem_pcg(ps_r, b_r, maxit=MAXIT, rtol=RTOL)
        dinv_r = 1.0 / St_r.diagonal()
        cert = refined_pcg(St_r, b_r, M=lambda v, d=dinv_r: d * v,
                           rtol=1e-7, inner_rtol=1e-5, inner_maxit=MAXIT)
        torch.cuda.synchronize()
        realizations.append(dict(
            seed=seed, ms=1e3 * (time.perf_counter() - t0), it=int(it_r),
            res=float(res_r), bnorm=float(torch.linalg.vector_norm(b_r)),
            certified_relres=float(cert.res_norm[0]) / float(
                torch.linalg.vector_norm(b_r)),
            refine_sweeps=cert.refines, certified_iters=int(cert.it),
            St=St_r, b=b_r, x_df32=cert.x_df32))
    launches = {k: fn.launches for k, fn in counters.items()}
    emit("main_path", launches=launches)

    # checks of the main path (the reference solves run after the counts)
    ref = {"cg": cg(St, b_full, maxit=MAXIT, rtol=RTOL),
           "pcg": pcg(St, b_full, M=lambda v: dinv * v, maxit=MAXIT,
                      rtol=RTOL)}
    for name, (xs, it, res, sec) in solves.items():
        r = ref["cg" if name == "vmem_cg" else "pcg"]
        it_ref = int(r.it)
        res_ref = float(r.res_norm[it_ref - 1])
        check(res <= RTOL * bnorm and res_ref <= RTOL * bnorm,
              f"{name}: recurrence tolerance missed ({res}, {res_ref})")
        check(it_ok(it, "cg" if name == "vmem_cg" else "pcg"),
              f"{name}: it {it} (reference {it_ref}) outside the envelope")
        err_x = rel(xs, r.x)
        check(err_x <= 1e-3, f"{name}: x rel err {err_x}")
        # A float32 x cannot have a float64 residual below about
        # u32·‖|A||x|‖/‖b‖ (~5e-3 here: stiffness rows cancel to h²), so the
        # kernel's x is held to the plain solver's accuracy in the same
        # arithmetic; phase 5 certifies 1e-7 by refinement.
        tr, tr_ref = true_relres(St, b_full, xs), true_relres(St, b_full, r.x)
        check(tr <= max(1e-5, 2 * tr_ref),
              f"{name}: true residual {tr} / reference {tr_ref}")
        emit(f"solve_{name}", it=it, it_reference=it_ref, x_rel_err=err_x,
             true_relres=tr, true_relres_reference=tr_ref,
             f32_floor=f32_floor(St, b_full, xs), ms=1e3 * sec,
             us_per_iteration=1e6 * sec / max(it - 1, 1),
             cg_spmv_throughput_nnz_per_s=nnz * it / sec, card=card)
    for real in realizations:
        check(real["res"] <= RTOL * real["bnorm"], "realization: vmem_pcg tolerance")
        check(real["certified_relres"] <= 1e-7,
              f"realization {real['seed']}: certified {real['certified_relres']}")
        tr = true_relres(real["St"], real["b"], *real["x_df32"])
        check(tr <= 1e-7, f"realization {real['seed']}: true residual {tr}")
        emit("realization", true_relres=tr, card=card,
             **{k: real[k] for k in ("seed", "it", "certified_relres",
                                     "refine_sweeps", "certified_iters", "ms")})

    # ---- 6. kernel list --------------------------------------------------------
    for key, n_launch in launches.items():
        check(n_launch > 0, f"kernel {key} was not launched on the main path")
        check(kernels[key]["ms"] >= kernels[key]["bound_ms"],
              f"kernel {key}: {kernels[key]['ms']} ms is below its bound "
              f"{kernels[key]['bound_ms']} ms: the bound or the timing is wrong")
        kernels[key]["launches"] = n_launch
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[key][k] for k in order}
                                  for key in "ABCD"]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import krylov_spdes_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    if Path(krylov_spdes_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: krylov_spdes_tpu_torch was not imported from this "
              "checkout", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    try:
        run(card)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
