#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the stencil solve path, the
recycled MCMC chain, the Schur-DD flagship chain, and the certified
preconditioned solves of Examples 06, 07 and 09.

    python3 chip_smoke.py

Builds the port's CUDA kernels from krylov_spdes_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, drives the main paths through
the port's entry points, checks the results, and prints one JSON line per
phase. Size: a 500 x 500 grid (get_mesh(250000)), float32. The stencil solve
path runs bench.py's system (coefficient exp(0.3·N(0,1)) from numpy seed 0,
maxit 2000, rtol 1e-6), then 2 seeded lognormal realizations certified at
1e-7. The chain runs bench_chain.py's configuration: 25 sine modes with
λ = exp(−0.2(a² + b²)) as the KL basis, nvec 16, spdim 48, maxit 5000, the
float32 recurrence tolerance 1e-5. The Schur-DD chain runs bench.py's DD
protocol (get_mesh(32000), 30 subdomains through prepare_dd_stencil_assembly,
the same 25 sine modes, nvec 30, spdim 90, maxit 500) and the 500 x 500 grid
in 8 x 8 tiles. The certified arms of Examples 06, 07 and 09 run on the
general DD plan of dd_general (32k nodes, 30 subdomains) with the same 25
sine modes in place of the KL basis the protocols ran on, float32,
certified at 1e-7 with inner solves at 1e-5; Example 06 takes 1
realization where the protocol takes 2 (a cut that holds the run within
three minutes of its earlier length), Example 07 2 realizations, Example 09
one MCMC chain of 3 samples. precond_apply runs at Example 06's default
size, get_mesh(4000) in 20 subdomains.

Phases:
  1. build      nvcc build time; the card's name and power limit
  2. kernel_a   stencil SpMV vs its plain version; kernel, plain, library
                (torch.sparse.mm on the same operator in CSR) and bound times
  3. kernel_b   one CG sweep vs its plain version (pn and Ap bit-equal, pads
                zero, d within 1e-5 and repeated bit for bit), its device
                operations a call (one launch), L2-cold and L2-warm device
                times, CUDA-event time a call, bound and share of it, launch
                plan; kernel_b_parent: the parent commit's figures with its
                two memsets (a constant, PERF.md §6)
  4. kernel_c / kernel_d   whole-solve CG / Jacobi-PCG vs their plain versions
     over 1 and 8 iterations, a solve twice bit for bit, the shared-memory
     plan (grid, nrmax, resident vectors and planes, bytes a block) and
     barriers an iteration; the solve to the bench tolerance (before them,
     it_envelope: the plain solvers' float32 iteration counts on b and on
     copies of b changed in their last bit; a kernel's count must lie within
     5% of the range they span); grid_sync: the fixed cost of an iteration
     (two all-gathers) on 64 and on 132 blocks
  5. main_path  with every launch count set to 0: fused_pcg (B), vmem_cg (C),
                vmem_pcg (D) on the bench system, then per realization
                stencil_assemble -> refill_padded_stencil -> vmem_pcg ->
                refined_pcg (A); each solve held against solvers.cg/pcg;
                B launched once a fused_pcg iteration after the first, and
                fused_pcg's it, ms and µs an iteration
  6. kernel_e   one stretch of eigDef-PCG on the operands of a real recycled
                solve vs its plain version, and again bit for bit; its
                shared-memory plan (bytes a block, blocks, resident rows of
                W) and barriers an iteration; kernel_e_nvec32: the same at
                nvec 32, where W does not fit in shared memory;
                kernel_e_float64: small float64 solves through the kernel vs
                solvers.eigdefpcg
  7. kernel_f / kernel_g   the batched projections on the operands of a
                batched chain step at B = 4 vs their plain versions (F also
                vs torch.bmm)
  8. chain      with the counts of E, F, G set to 0: prepare_chain_states ->
                seed_chain (eigPCG) -> three make_chain_step steps, and in
                step with them the same realizations through
                refill_padded_stencil -> vmem_eigdefpcg (E) from the same W;
                chain_parts: the draw, the assembly, the setup algebra of a
                solve through E and the thick restart's dense algebra, each
                alone; chain_device_share: the device's idle share of one
                recycled solve through either path, and kernel E's device
                time in it (torch.profiler)
  9. chain_batched   seed_chains_batched -> two make_batched_chain_step
                steps at B = 4, per-chain counts held against the
                single-chain solver. The batched solver keeps its library
                products and launches neither F nor G: this script calls
                gemv_rows (F) and fused_reorth (G), entry points of their
                own, on each step's operands, F held against the float64
                product
 10. kl         solve_kl(method="dense") on a 2.5k-node mesh on the card, and
                a short chain from its basis
  5b. kernel_h   the whole CG solve on the unpadded 9-plane layout
                (stencil_cg) vs its plain version over 1 and 8 iterations,
                and the bench system's solve under the limits of phase 5
                against solvers.cg, its `it` on b and on last-bit copies of
                b within 5% of the range its own plain version spans on the
                same right-hand sides, its shared-memory plan and barriers;
                main_path_h, with H's count at 0: stencil_cg on the bench
                system and on the realizations' operators; kernel_b_large:
                one sweep at 1000 x 1000 vs its plain version, L2-cold;
                kernel_h_large, kernel_c_large, kernel_d_large: 1000 x 1000,
                where the planes do not fit in shared memory, vs their plain
                versions over 1 and 8 iterations, bit for bit, µs an
                iteration
 11. dd_protocol   seed_dd_chain (eigPCG + Neumann-Neumann on the interface
                system), 4 warm-up and 5 timed make_dd_chain_step steps;
                dd_repeat: one step twice from the same state and W, equal
                `it` and bit-equal W'; dd_tf32: TF32 off inside a step even
                with the caller's setting on; dd_parts: the draw, the refill,
                the factorisation, assemble_local_schurs, _masked_pinv, one
                Schur apply, one NN apply, the deflation setup and one thick
                restart, each alone, and one solve's `it` with the pinv of
                the float32 and of the float64 rule; dd_device_share: the
                device's idle share
                of one step (torch.profiler); dd_batched: B = 4,
                seed_dd_chains_batched and 2 make_batched_dd_chain_step
                steps, per-chain `its` (from W and from last-bit copies of W)
                within 2 of the range of the single-chain step's
 12. dd_general    the general plan (mesh_partition(use_native=True) ->
                set_subdomains -> prepare_dd_assembly, dense interiors) at
                the protocol size, seed and 2 steps; dd_entry: entry()'s
                step once; dd_full: the 500 x 500 grid in 8 x 8 tiles, seed
                and 3 steps, then one step's merged DD solution against the
                monolithic stencil system (float64 residual within twice the
                solution's float32 floor)
 12b. ex06_certified   with kernel A's count at 0 before each samg solve:
                amg, lorasc (nvec min(25, n_Γ/2), ε 0.01), bj (ndom blocks)
                and samg, each built at ξ = 0 (const) and per realization
                (rebuilt), from prepare_mc_sampler's draws; samg certifies
                through refined_pcg (kernel A, launched once an inner
                iteration), the others through refined_pcg_sparse in both
                single_trace forms, which must agree; lorasc_randomized:
                the lorasc build on the randomized range finder. Per arm it,
                refines, the certified and the float64 true relative
                residual, build and solve ms
     ex07_certified   nn_const, nn_rebuilt and gamma_chol through
                refined_dd_pcg on assembled_schur_operator(S, Sd), the
                pullback table built once; one solve run twice, the same it
                and bits of x_df32 and u_I
     ex09_certified   one MCMC chain: pcg through refined_pcg_sparse,
                eigpcg, eigdefpcg and defpcg through refined_recycled_solve
                with Example 09's W bookkeeping, M0 = lorasc1 at ξ = 0, nvec
                37, spdim 90; it per method and sample, rank(W); eigdefpcg's
                mean it over samples 2-3 must be below pcg's
     Every certified solve: breakdown false, its float64 true residual
     (computed apart from the residual that certified it: CSR segment sums,
     torch's CSR product, index_add_ over Γ) ≤ 1e-7·‖b‖, and TF32 off in
     every preconditioner apply although the caller turned it on.
     precond_apply   AMG, stencil AMG, block-Jacobi, Cholesky32/16,
                Chebyshev, LORASC exact and randomized (one start block),
                DDLR and NN-induced built on the card in float32 from the
                rounded float64 inputs and applied to one seeded r, against
                the same build in float64 on the CPU: relative difference
                ≤ 1e-4 (≤ 2e-2 for Cholesky16)
 13. kernels    one {"kernels": [...]} line with each kernel's launches on
                its main path (all must be > 0; A's count includes the samg arm of
                ex06_certified, printed there on its own) and its times

The last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero; so does a host without a CUDA device, or a directory without the
port's package beside this script. The bound of a kernel is the larger of
its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
H100 SXM's published HBM rate and non-tensor float32 peak). Kernels A, B, F
and G are timed with their operands cold in the 50 MB L2, so that the HBM
rate bounds them; the run fails if any kernel's time is below its bound.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
NNODE, MAXIT, RTOL, SIGMA = 250000, 2000, 1e-6, 0.3
N_REALIZATIONS = 2
# the chain: bench_chain.py's configuration
NVEC, SPDIM, CHAIN_MAXIT, CHAIN_RTOL = 16, 48, 5000, 1e-5
KL_MODES, KL_DECAY, N_BATCH, KL_NNODE = 5, 0.2, 4, 2500
# least cosine of the principal angles between the basis harvested through
# kernel E and the torch path's, on the same realization from the same W
W_COSINE_MIN = 0.9999
L2_EVICT_BYTES = 200e6   # four times the H100's 50 MB L2
# the Schur-DD chain: bench.py's DD protocol (32k nodes, 30 subdomains, nvec
# 30, spdim max(3·ndom, 2·nvec + 1) = 90, maxit 500), and the 500 x 500 grid
# in 8 x 8 tiles
DD_NNODE, DD_NDOM, DD_NVEC, DD_MAXIT = 32000, 30, 30, 500
DD_FULL_NDOM, DD_FULL_SPDIM = 64, 90
H_ENVELOPE = 9     # last-bit copies of b behind kernel H's `it` envelope
# the certified arms of Examples 06, 07 and 09 on dd_general's plan (32k
# nodes, 30 subdomains): certified at 1e-7 with inner solves at 1e-5;
# realizations of ex06 (cut from 2 to 1 to hold the run's length) and
# ex07, samples of ex09's MCMC chain, ex09's maxit
CERT_RTOL, CERT_INNER_RTOL = 1e-7, 1e-5
EX06_REALIZATIONS, EX07_REALIZATIONS = 1, 2
EX09_SAMPLES, EX09_MAXIT = 3, 5000
# precond_apply: Example 06's default size (examples/common.py:23-25), and
# the limits of the card's float32 builds against the CPU's float64 ones
PA_NNODE, PA_NDOM = 4000, 20
PA_TOL = {"float32": 1e-4, "cholesky16": 2e-2}


L2_BYTES = 50e6
SWEEP_KERNEL = "cg_sweep_strip_kernel"
# Kernel B before its redesign (two memsets of pn and Ap, cg_sweep_kernel
# and sum_kernel a call): device µs a call of the parent commit's cg_sweep,
# all four operations, on this script's operands in float32, four runs of
# krylov_spdes_tpu_torch/bench/sweep_bench.py --tree <that checkout> on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6). A constant: the old kernel
# is no longer in the tree.
PARENT_B = {"device_ops_per_call": 4, "us_l2_cold_with_memsets": [10.52, 10.69],
            "us_l2_warm_with_memsets": [8.69, 8.87],
            "us_l2_cold_1000x1000_with_memsets": [25.29, 25.75],
            "source": "bench/sweep_bench.py --tree <parent>, "
                      "NVIDIA H100 80GB HBM3, 700.00 W"}
# barriers an iteration of the persistent kernels (csrc/persistent.cuh): E,
# and the whole-solve CG kernels C, D and H
E_BARRIERS = {"all_gather": 3, "neighbour_only": 1}
CG_BARRIERS = {"all_gather": 2, "neighbour_only": 0}
OVER_1_AND_8 = {1: 1e-5, 8: 2e-3}


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
    """(ms, how): device time per call of the kernels fn() launches, from a
    torch.profiler trace (kernels whose name holds one of `names`, or all),
    and how it was taken; (None, None) when the trace records no such device
    time. A named kernel runs the same number of times in every call. In a
    long process the trace can lose the records of some launches (their
    count is then no multiple of `reps`, and their summed time too short):
    each named kernel's time is the mean over the launches the trace did
    record, times its launches a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if e.self_device_time_total > 0
             and (names is None or any(m in e.key for m in names))]
    if not found:
        return None, None
    if names is None or all(e.count % reps == 0 for e in found):
        return sum(e.self_device_time_total for e in found) / reps / 1e3, "profiler"
    a_call = [math.ceil(e.count / reps) for e in found]
    ms = sum(e.self_device_time_total / e.count * k
             for e, k in zip(found, a_call)) / 1e3
    return ms, (f"profiler, mean of the {sum(e.count for e in found)} of "
                f"{reps * sum(a_call)} launches that the trace recorded")


def device_share(fn, names=None):
    """Wall ms of fn() unprofiled, ms the device was busy in a profiled run
    of it, the device's idle share of the wall time and, with `names`, the
    device ms of the kernels whose name holds one of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    out = dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall)
    if names is not None:
        out["device_ms_of_" + "_".join(names)] = sum(
            e.self_device_time_total for e in events
            if any(m in e.key for m in names)) / 1e3
    return out


def timings(fn, reps, names=None):
    """(ms, ms_per_call, how): the kernels' device time per call from the
    profiler (or, without one, the CUDA-event time per call), and the
    CUDA-event time per call with the host's launch overhead."""
    per_call = cuda_ms(fn, reps)
    dev, how = device_ms(fn, reps, names)
    return (per_call, per_call, "events") if dev is None else (
        dev, per_call, how)


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


def device_ops(fn, reps):
    """(operations a call, their names): every device operation (kernel,
    memset, copy) that fn() makes, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return sum(e.count for e in found) / reps, [e.key for e in found]


def check_sweep(what, fc, ps, r, p, beta):
    """Kernel B against its plain version: pn and Ap bit-equal with their
    pads exactly zero, d within 1e-5 and the same bits over 3 calls.
    Returns the relative errors and the largest absolute error."""
    pn0, ap0, d0 = fc.cg_sweep_plain(ps, r, p, beta)
    outs = [fc.cg_sweep(ps, r, p, beta) for _ in range(3)]
    pn, ap, d = outs[0]
    check(torch.equal(pn, pn0) and torch.equal(ap, ap0),
          f"{what}: pn or Ap not bit-equal to the plain version")
    r0 = fc.ROW0
    for a in (pn, ap):
        check(not (a[:r0].any() or a[r0 + ps.H:].any() or a[:, ps.W:].any()),
              f"{what}: a pad of pn or Ap is not zero")
    check(all(torch.equal(o[2], d) for o in outs),
          f"{what}: d does not repeat bit for bit")
    errs = {"pn": rel(pn, pn0), "ap": rel(ap, ap0),
            "d": abs(float(d) - float(d0)) / abs(float(d0))}
    check(errs["d"] <= 1e-5, f"{what} vs plain: {errs}")
    return errs, abs(float(d - d0))


def over_1_and_8(what, kern, plain):
    """A whole-solve kernel, kern(maxit), against its plain version,
    plain(maxit), over 1 and 8 iterations with a tolerance never met: CG
    amplifies a last-bit difference from iteration to iteration (the two
    reduce in different orders), so they are compared there and not at the
    end of a solve. Returns the relative errors and the largest absolute
    error of x after 8 iterations."""
    errs = {}
    for its, tol in OVER_1_AND_8.items():
        xk, itk, resk = kern(its + 1)
        xp, itp, resp = plain(its + 1)
        check(int(itk) == int(itp) == its + 1,
              f"{what}: it {int(itk)} / plain {int(itp)} of {its + 1}")
        errs[its] = {"x": rel(xk, xp),
                     "res": abs(float(resk) - float(resp)) / float(resp)}
        check(max(errs[its].values()) <= tol,
              f"{what} vs plain over {its} iterations: {errs[its]}")
    return errs, float((xk - xp).abs().max())


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
    bs = perturbed(b, n)
    r0 = solve(bs[0])
    its = [int(r0.it)] + [int(solve(v).it) for v in bs[1:]]
    h = r0.history()
    tol = RTOL * float(torch.linalg.vector_norm(b))
    plateau = int(np.sum((h > tol) & (h <= 1.5 * tol)))
    return its, plateau


def sine_basis(points):
    """bench_chain.py's spectral stand-in for a KL basis (the dense KL is
    O(n²) and the basis' provenance does not matter to the solvers):
    KL_MODES² sine modes, λ = exp(−KL_DECAY·(a² + b²))."""
    xs, ys = points[:, 0], points[:, 1]
    modes, lams = [], []
    for a in range(1, KL_MODES + 1):
        for b in range(1, KL_MODES + 1):
            modes.append(np.sin(np.pi * a * xs) * np.sin(np.pi * b * ys) * 2)
            lams.append(np.exp(-KL_DECAY * (a * a + b * b)))
    return np.asarray(lams), np.stack(modes, 1)


def subspace_cosines(Wa, Wb):
    """Cosines of the principal angles between span(Wa) and span(Wb)."""
    Qa = torch.linalg.qr(Wa.double())[0]
    Qb = torch.linalg.qr(Wb.double())[0]
    return torch.linalg.svdvals(Qa.T @ Qb)


def maxrel(a, b):
    """max |a − b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def perturbed(b, n, seed=1):
    """b and n copies of b changed in their last bit."""
    gen = torch.Generator(device=b.device).manual_seed(seed)
    out = [b]
    for _ in range(n):
        xi = torch.randint(-1, 2, b.shape, generator=gen, device=b.device)
        out.append(b * (1 + 2.0 ** -23 * xi.to(b.dtype)))
    return out


def stretch_errors(k, pl, nsteps, nvec):
    """Relative differences of a kernel-E stretch k from its plain version
    pl, and equal cnt and live."""
    check(int(k[7]) == int(pl[7]) == nsteps and bool(k[9]) == bool(pl[9]),
          f"kernel E: cnt {int(k[7])} / plain {int(pl[7])} of {nsteps}")
    cols = slice(nvec + 1, nvec + 1 + nsteps)
    return {"x": rel(k[0], pl[0]), "r": rel(k[1], pl[1]),
            "p": rel(k[2], pl[2]), "V": rel(k[3][cols], pl[3][cols]),
            "alpha": maxrel(k[4][:nsteps], pl[4][:nsteps]),
            "beta": maxrel(k[5][:nsteps], pl[5][:nsteps]),
            "res2": maxrel(k[6][:nsteps], pl[6][:nsteps]),
            "rTz": abs(float(k[8]) - float(pl[8])) / abs(float(pl[8]))}


def stretch_abs_err(k, pl, nsteps, nvec):
    cols = slice(nvec + 1, nvec + 1 + nsteps)
    return max([float((k[i] - pl[i]).abs().max()) for i in range(3)]
               + [float((k[3][cols] - pl[3][cols]).abs().max())])


def stretch_streamed(ps, plan, nvec):
    """What an iteration of kernel E reads from and writes to global memory
    with the plan's residency: the K planes, WᵀA·m (G's second half), the
    rows of W not in shared memory (read twice: U and the fixes), one column
    of V and two halo rows of p; the band's vectors too where they live in
    global memory (about a dozen passes). Bytes, and µs at the HBM rate."""
    grids = ps.K + nvec + 2 * (nvec - plan.w_rows) + 1
    if not plan.vectors:
        grids += 12
    size = ps.planes.element_size()
    nbytes = (grids * ps.R + 2 * 2 * plan.grid) * ps.C * size
    return {"grids": grids, "bytes": nbytes,
            "us": 1e6 * nbytes / HBM_BYTES_PER_S}


def projection_operands(plan, g, W, nvec):
    """The projection operands of a batched chain step on the fields g
    (B, n) from the bases W (B, n, nvec), after its first CG update, formed
    by the solver's own setup (solvers/batched.py): G = [Wᵀ; WᵀA·m]
    (B, 2nvec, n), the residual r, the coefficients C = [cw | mu] and the
    Jacobi diagonal m."""
    from krylov_spdes_tpu_torch import chains
    from krylov_spdes_tpu_torch.solvers import batched
    A, m, b = chains.batched_system(plan, g)
    o = batched.batched_operands(A, m, b, torch.zeros_like(b), W, nvec)
    Ap = A(o["p"])
    alpha = o["rTz"] / torch.sum(o["p"] * Ap, dim=1)
    r = (o["r"] - alpha[:, None] * Ap).contiguous()
    cw, mu = batched.projection_coefficients(o, r, nvec)
    return (o["Gq"].contiguous(), r, torch.cat([cw, mu], dim=1).contiguous(),
            m.contiguous())


F_FLOOR, F_FLOOR_WTAM = 1e-7, 1e-6


def check_projections(G, r, C, m, nvec):
    """gemv_rows (F) and fused_reorth (G) through their wrappers, held
    against the plain versions. Returns the max abs errors."""
    from krylov_spdes_tpu_torch.ops import batched_proj as bp
    U, U0 = bp.gemv_rows(G, r), bp.gemv_rows_plain(G, r)
    # r is W-orthogonal up to rounding (deflated CG), so U is what is left
    # of sums that cancel and the kernel and its plain version, which sum in
    # different orders, agree only to rounding: both are held against the
    # float64 product. The kernel may be at most twice as far from it as
    # the plain version, plus a floor: F_FLOOR of the largest Σ|G||r| for
    # all of U, and F_FLOOR_WTAM of the largest entry for the WᵀA·m half,
    # which deflated CG does not drive to zero
    U64 = (G.double() @ r.double()[..., None])[..., 0]
    scale = float((G.double().abs() @ r.double().abs()[..., None]).max())
    hi = slice(nvec, None)
    dist = lambda u, rows=slice(None): float(            # noqa: E731
        (u.double() - U64)[:, rows].abs().max())
    f = dict(err=dist(U), err_plain=dist(U0), floor=F_FLOOR * scale,
             err_wtam=dist(U, hi), err_wtam_plain=dist(U0, hi),
             floor_wtam=F_FLOOR_WTAM * float(U64[:, hi].abs().max()),
             max_abs_u=float(U64.abs().max()), max_abs_sums=scale)
    check(f["err"] <= 2 * f["err_plain"] + f["floor"]
          and f["err_wtam"] <= 2 * f["err_wtam_plain"] + f["floor_wtam"],
          f"kernel F vs the float64 product: {f}")
    out, ref = (bp.fused_reorth(G, C, r, m, nvec),
                bp.fused_reorth_plain(G, C, r, m, nvec))
    errs_g = [maxrel(a, c) for a, c in zip(out, ref)]
    check(max(errs_g[:3]) <= 1e-6 and max(errs_g[3:]) <= 1e-4,
          f"kernel G vs plain: max rel errs {errs_g}")
    return (float((U - U0).abs().max()),
            max(float((a - c).abs().max()) for a, c in zip(out, ref)),
            f, errs_g)


def run_chain_slice(card, mesh, plan, kernels, dev="cuda"):
    """Phases 6-10: kernels E, F, G against their plain versions, then the
    recycled chain, single and batched, and the dense KL front end."""
    from krylov_spdes_tpu_torch import chains, fem, kl
    from krylov_spdes_tpu_torch.ops import batched_proj as bproj
    from krylov_spdes_tpu_torch.ops import fused_cg as fc
    from krylov_spdes_tpu_torch.ops import vmem_eigdef as ve
    from krylov_spdes_tpu_torch.ops.stencil import build_stencil_op, to_full_vector
    from krylov_spdes_tpu_torch.samplers import samplers
    from krylov_spdes_tpu_torch.solvers import eigdefpcg, eigpcg

    sync = torch.cuda.synchronize
    f32 = plan.factors.dtype
    n = plan.H * plan.W
    lam, psi = sine_basis(mesh.points)
    opts = dict(nvec=NVEC, spdim=SPDIM, maxit=CHAIN_MAXIT)

    def recycled(St, b, W):
        """The torch path's solver on one realization, full-precision basis."""
        return eigdefpcg(St, b, W=W, spdim=SPDIM, maxit=CHAIN_MAXIT,
                         rtol=CHAIN_RTOL, Mdiag=1.0 / St.diagonal())

    def envelope(St, bs, W, extra=()):
        its = [int(recycled(St, v, W).it) for v in bs] + list(extra)
        return its, (0.95 * min(its), 1.05 * max(its))

    # ---- 6. kernel E: one stretch on the operands of a real solve -----------
    s0 = chains.chain_state(chains.prepare_chain_states(lam, psi, 1), 0)
    check(s0.g.device.type == dev and s0.g.dtype == f32,
          "the sampler state lives on the plan's device")
    W0, it_seed0 = chains.seed_chain(plan, s0, **opts)
    s1, _ = samplers.draw(s0)
    St1, b1 = fem.make_stencil_operator(plan, torch.exp(s1.g))
    ps = fc.build_padded_stencil(St1)
    RC = ps.R * ps.C
    bp = fc.pad_vec(ps, b1)
    minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    Wp = torch.stack([fc.pad_vec(ps, w) for w in W0.T.contiguous()])
    o = ve.stretch_operands(ps, minv, bp, Wp)
    tol2 = (CHAIN_RTOL * torch.linalg.vector_norm(bp)) ** 2
    full = SPDIM - 1 - NVEC

    def new_V():
        V = bp.new_zeros((SPDIM, ps.R, ps.C))
        V[:NVEC] = Wp
        V[NVEC] = o["z"] / torch.sqrt(o["rTz"])
        return V

    def one_stretch(fn, V, nsteps, o=o, nvec=NVEC):
        """The kernel takes G and the coefficient matrices Ac, Bc; its JAX
        twin stretch_plain takes G, A1 and B."""
        m1, m2 = ("Ac", "Bc") if fn is ve.stretch else ("A1", "B")
        return fn(ps, minv, o["G"], o[m1], o[m2], o["x"].clone(),
                  o["r"].clone(), o["p"].clone(), V, tol2, o["rTz"], o["rTr"],
                  nsteps, nvec)

    Vk, Vp = new_V(), new_V()
    errs_e, abs_e = {}, 0.0
    # CG amplifies a last-bit difference from iteration to iteration, so the
    # kernel is held to its plain version over 1 and 8 iterations; the full
    # stretch's difference is reported
    for nsteps, tol in ((1, 1e-5), (min(8, full), 2e-3), (full, None)):
        k, pl = one_stretch(ve.stretch, Vk, nsteps), one_stretch(
            ve.stretch_plain, Vp, nsteps)
        sync()
        e = stretch_errors(k, pl, nsteps, NVEC)
        errs_e[nsteps] = e
        if tol is not None:
            check(max(e.values()) <= tol,
                  f"kernel E vs plain over {nsteps} iterations: {e}")
            abs_e = stretch_abs_err(k, pl, nsteps, NVEC)
    # a stretch repeats bit for bit (fixed-order sums, no float atomics)
    V2 = new_V()
    k2 = one_stretch(ve.stretch, V2, full)
    check(all(torch.equal(a, c) for a, c in zip(k2[:9], k[:9])),
          "kernel E: a stretch does not repeat bit for bit")
    del V2, k2
    # bytes: each input once a launch (planes, minv, G, Ac, Bc, x, r, p) and
    # each output once (x, r, p, the cnt new columns of V); operations of the
    # cnt iterations: 35 a node for the apply and the vector updates, U 4·nvec,
    # the two fixes from W 4·nvec, and c_r, c_p 6·nvec² once an iteration
    flops_it = (35 + 8 * NVEC) * n + 6 * NVEC * NVEC
    bnd, by = bound_ms((ps.K + 1 + 2 * NVEC + 3 + 3 + full) * RC * 4
                       + 3 * NVEC * NVEC * 4, flops_it * full)
    kernels["E"] = dict(
        name="eigdef_stretch", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/eigdef_stretch.cu",
        replaces="krylov_spdes_tpu/ops/vmem_eigdef.py:96",
        max_abs_err=abs_e, bound_ms=bnd, bound_by=by,
        **timed(lambda: one_stretch(ve.stretch, Vk, full), 10,
                ["stretch_kernel"],
                lambda: one_stretch(ve.stretch_plain, Vp, full), 2))
    eplan = ve.plan_for(ps, bp, NVEC)
    streamed = stretch_streamed(ps, eplan, NVEC)
    us_it = 1e3 * kernels["E"]["ms"] / full
    # what an iteration reads from and writes to global memory in this
    # design, with the residency the plan reports: where it cannot stay in
    # the 50 MB L2 it streams from HBM, and a time below that is wrong
    if streamed["bytes"] > L2_BYTES:
        check(us_it >= streamed["us"],
              f"kernel E: {us_it} us an iteration is below the "
              f"{streamed['us']} us its streamed bytes take")
    emit("kernel_e", iterations=full, rel_err=errs_e,
         tolerance={1: 1e-5, min(8, full): 2e-3},
         max_abs_err_over=min(8, full), repeats_bit_for_bit=True,
         us_per_iteration=us_it,
         us_per_iteration_events=1e3 * kernels["E"]["ms_per_call"] / full,
         plain_us_per_iteration=1e3 * kernels["E"]["plain_ms_per_call"] / full,
         global_bytes_per_iteration=streamed["bytes"],
         streamed_bound_us_per_iteration=streamed["us"],
         # the earlier grid-synchronised design streamed G, A1 and B
         # (5·nvec grids) and a dozen vector passes an iteration
         streamed_bound_us_per_iteration_5nvec_design=1e6 * (
             ps.K + 5 * NVEC + 19) * RC * 4 / HBM_BYTES_PER_S,
         operands_mb=2 * NVEC * RC * 4 / 1e6, plan=dataclasses.asdict(eplan),
         barriers_per_iteration=E_BARRIERS, seed_it=int(it_seed0), card=card,
         **{k: v for k, v in kernels["E"].items() if k not in NAMING})
    del Vk, Vp, o

    # ---- kernel E where W does not fit in shared memory: nvec 32 -------------
    nv32 = 2 * NVEC
    g32 = torch.Generator(device=dev).manual_seed(32)
    free = (St1.dir_diag.reshape(-1, 1) == 0).to(f32)
    W32 = torch.linalg.qr(torch.cat([W0, torch.randn(
        n, nv32 - NVEC, generator=g32, device=dev, dtype=f32) * free], 1))[0]
    o32 = ve.stretch_operands(ps, minv, bp, torch.stack(
        [fc.pad_vec(ps, w) for w in W32.T.contiguous()]))
    plan32 = ve.plan_for(ps, bp, nv32)
    check(plan32.w_rows < nv32, f"kernel E nvec {nv32}: plan {plan32}")
    spdim32 = 2 * nv32 + 1
    full32 = spdim32 - 1 - nv32

    def new_V32():
        V = bp.new_zeros((spdim32, ps.R, ps.C))
        V[:nv32] = o32["G"][:nv32]
        return V
    errs32 = {}
    for nsteps, tol in ((1, 1e-5), (8, 2e-3)):
        k = one_stretch(ve.stretch, new_V32(), nsteps, o32, nv32)
        pl = one_stretch(ve.stretch_plain, new_V32(), nsteps, o32, nv32)
        errs32[nsteps] = stretch_errors(k, pl, nsteps, nv32)
        check(max(errs32[nsteps].values()) <= tol,
              f"kernel E nvec {nv32} vs plain over {nsteps} iterations: "
              f"{errs32[nsteps]}")
    V32 = new_V32()
    ms32 = cuda_ms(lambda: one_stretch(ve.stretch, V32, full32, o32, nv32), 5)
    emit("kernel_e_nvec32", nvec=nv32, iterations=full32, rel_err=errs32,
         tolerance={1: 1e-5, 8: 2e-3}, plan=dataclasses.asdict(plan32),
         ms_events=ms32, us_per_iteration_events=1e3 * ms32 / full32,
         streamed=stretch_streamed(ps, plan32, nv32), card=card)
    del o32, V32, W32, Wp

    # small float64 solves through the kernel against solvers.eigdefpcg
    f64 = dict(device=dev, dtype=torch.float64)
    m_s = fem.get_mesh(900, jitter=0.2, seed=3)
    maps_s = fem.get_dirichlet_inds(m_s.points, m_s.point_markers)
    f_src = lambda x, y: -1.0 + 0.0 * x   # noqa: E731
    u_dir = lambda x, y: 0.0 * x          # noqa: E731
    asm_s = fem.prepare_elliptic_assembly(m_s.cells, m_s.points, maps_s, f_src,
                                          u_dir, **f64)
    A_s, b_s = fem.do_isotropic_elliptic_assembly(
        asm_s, np.exp(np.random.default_rng(0).normal(size=m_s.nnode)))
    St_s = build_stencil_op(A_s, maps_s, (30, 30))
    bf_s = to_full_vector(maps_s, b_s, m_s.nnode)
    dinv_s = 1.0 / St_s.diagonal()
    ps_s = fc.build_padded_stencil(St_s)
    small = []
    for nvec, spdim in ((4, 12), (8, 20), (4, 9)):
        W_s = eigpcg(St_s, bf_s, M=lambda v: dinv_s * v, nvec=nvec,
                     spdim=max(spdim, 2 * nvec + 4), maxit=400).W
        ref = eigdefpcg(St_s, bf_s, W=W_s, spdim=spdim, maxit=400, Mdiag=dinv_s)
        n0 = (ve.stretch.launches, ve._restart_iteration.calls)
        x_s, it_s, _, _ = ve.vmem_eigdefpcg(ps_s, bf_s, W_s, spdim=spdim,
                                            maxit=400)
        err = rel(x_s, ref.x)
        check(int(it_s) == int(ref.it) and err <= 1e-8,
              f"kernel E float64 ({nvec}, {spdim}): it {int(it_s)} / "
              f"{int(ref.it)}, x rel err {err}")
        small.append(dict(nvec=nvec, spdim=spdim, it=int(it_s), x_rel_err=err,
                          stretches=ve.stretch.launches - n0[0],
                          restarts=ve._restart_iteration.calls - n0[1]))
    emit("kernel_e_float64", cases=small, tolerance=1e-8, card=card)

    # ---- 7. kernels F and G on the operands of a batched step ---------------
    states4 = chains.prepare_chain_states(lam, psi, N_BATCH, base_key=10)
    G4, r4, C4, m4 = projection_operands(plan, states4.g,
                                         torch.stack([W0] * N_BATCH), NVEC)
    abs_f, abs_g, err_f, errs_g = check_projections(G4, r4, C4, m4, NVEC)
    bnd, by = bound_ms((G4.numel() + r4.numel() + N_BATCH * 2 * NVEC) * 4,
                       2 * G4.numel())
    kernels["F"] = dict(
        name="gemv_rows", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/batched_proj.cu",
        replaces="krylov_spdes_tpu/ops/batched_proj.py:48",
        max_abs_err=abs_f, bound_ms=bnd, bound_by=by,
        **timed(cold(bproj.gemv_rows, lambda: (G4.clone(), r4.clone())), 50,
                ["gemv_rows_kernel", "row_sum_kernel"],
                cold(bproj.gemv_rows_plain, lambda: (G4.clone(), r4.clone())),
                10,
                cold(lambda g_, r_: torch.bmm(g_, r_[..., None]),
                     lambda: (G4.clone(), r4.clone()))))
    emit("kernel_f", B=N_BATCH, K=2 * NVEC, n=n, against_float64=err_f,
         tolerance="err <= 2 err_plain + floor, for U and for its WtA·m half",
         library="torch.bmm", card=card,
         **{k: v for k, v in kernels["F"].items() if k not in NAMING})
    # one pass over the first nvec rows of G, r and m in, r', z, t1 out
    bnd, by = bound_ms((N_BATCH * NVEC * n + 5 * N_BATCH * n) * 4,
                       (4 * NVEC + 6) * N_BATCH * n)
    g_args = lambda: (G4[:, :NVEC].clone(), C4.clone(), r4.clone(),  # noqa: E731
                      m4.clone(), NVEC)
    kernels["G"] = dict(
        name="fused_reorth", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/batched_proj.cu",
        replaces="krylov_spdes_tpu/ops/batched_proj.py:91",
        max_abs_err=abs_g, bound_ms=bnd, bound_by=by,
        **timed(cold(bproj.fused_reorth, g_args), 50,
                ["fused_reorth_kernel", "row_sum_kernel"],
                cold(bproj.fused_reorth_plain, g_args), 5))
    emit("kernel_g", B=N_BATCH, nvec=NVEC, n=n, max_rel_err=errs_g,
         tolerance={"vectors": 1e-6, "sums": 1e-4}, card=card,
         **{k: v for k, v in kernels["G"].items() if k not in NAMING})
    del G4, r4, C4, m4

    # ---- 8. the chain, with the counts of E, F and G at 0 -------------------
    counters = {"E": ve.stretch, "F": bproj.gemv_rows, "G": bproj.fused_reorth}
    for fn in counters.values():
        fn.launches = 0
    sync()
    t0 = time.perf_counter()
    s = chains.chain_state(chains.prepare_chain_states(lam, psi, 1), 0)
    W, it_seed = chains.seed_chain(plan, s, **opts)
    sync()
    emit("chain_seed", it=int(it_seed), ms=1e3 * (time.perf_counter() - t0),
         solver="eigpcg", card=card)
    check(int(it_seed) < CHAIN_MAXIT, "chain: the seed solve hit maxit")
    step = chains.make_chain_step(plan, **opts)
    chain_steps = []
    for k in range(3):
        sync()
        t0 = time.perf_counter()
        s, W_t, it_t, cnt = step(s, W)
        sync()
        ms_t = 1e3 * (time.perf_counter() - t0)
        # the same realization through kernel E from the same W
        t0 = time.perf_counter()
        St, b = fem.make_stencil_operator(plan, torch.exp(s.g))
        ps = fc.refill_padded_stencil(ps, St)
        sync()
        refill_ms = 1e3 * (time.perf_counter() - t0)
        n0 = (ve.stretch.launches, ve._restart_iteration.calls)
        x_e, it_e, res_e, W_e = ve.vmem_eigdefpcg(
            ps, b, W, spdim=SPDIM, maxit=CHAIN_MAXIT, rtol=CHAIN_RTOL)
        sync()
        ms_e = 1e3 * (time.perf_counter() - t0)
        st = dict(refill_ms=refill_ms,
                  stretches=ve.stretch.launches - n0[0],
                  restarts=ve._restart_iteration.calls - n0[1])
        chain_steps.append(dict(k=k, St=St, b=b, W=W, W_t=W_t, it_t=int(it_t),
                                proposals=int(cnt), ms_t=ms_t, x_e=x_e,
                                it_e=int(it_e), res_e=res_e, W_e=W_e,
                                ms_e=ms_e, **st))
        W = W_t

    # the draw and the thick restart's small dense algebra alone (two eigh
    # and an svd of at most SPDIM x SPDIM), on the last step's state
    from krylov_spdes_tpu_torch.solvers.eig_common import thick_restart_basis
    q = torch.linalg.qr(torch.randn(SPDIM, SPDIM, device=b.device,
                                    dtype=b.dtype))[0]
    T = (q * torch.linspace(0.1, 10.0, SPDIM, device=b.device,
                            dtype=b.dtype)) @ q.T

    # the setup algebra of a solve through kernel E, on the last step's system
    c = chain_steps[-1]
    bp_c = fc.pad_vec(ps, c["b"])
    minv_c = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    Wp_c = torch.stack([fc.pad_vec(ps, w) for w in c["W"].T.contiguous()])
    emit("chain_parts", draw_ms=host_ms(lambda: samplers.draw(s)),
         stretch_operands_ms=host_ms(
             lambda: ve.stretch_operands(ps, minv_c, bp_c, Wp_c)),
         assemble_ms=host_ms(lambda: fem.make_stencil_operator(
             plan, torch.exp(s.g))),
         thick_restart_basis_ms=host_ms(
             lambda: int(thick_restart_basis(T, NVEC, SPDIM)[2])),
         spdim=SPDIM, nvec=NVEC, card=card)

    # ---- 9. the batched chain ------------------------------------------------
    sync()
    t0 = time.perf_counter()
    states = chains.prepare_chain_states(lam, psi, N_BATCH, base_key=10)
    Wb, it0_b = chains.seed_chains_batched(plan, states, **opts)
    sync()
    emit("chain_batched_seed", its=it0_b.tolist(),
         ms=1e3 * (time.perf_counter() - t0), card=card)
    bstep = chains.make_batched_chain_step(plan, **opts)
    batched_steps = []
    for k in range(2):
        sync()
        t0 = time.perf_counter()
        states, Wb_new, its_b, cnt_b = bstep(states, Wb)
        sync()
        ms_b = 1e3 * (time.perf_counter() - t0)
        # the projection entry points on this step's operands
        t0 = time.perf_counter()
        proj = check_projections(*projection_operands(plan, states.g, Wb,
                                                      NVEC), NVEC)
        sync()
        batched_steps.append(dict(k=k, g=states.g, W=Wb, its=its_b.tolist(),
                                  proposals=cnt_b.tolist(), ms=ms_b,
                                  proj_ms=1e3 * (time.perf_counter() - t0),
                                  proj_err=proj[2:]))
        Wb = Wb_new
    launches = {key: fn.launches for key, fn in counters.items()}
    emit("main_path_chain", launches=launches)
    for key, n_launch in launches.items():
        kernels[key]["launches"] = n_launch

    # checks of the chain (the reference solves run after the counts)
    for c in chain_steps:
        St, b, W = c["St"], c["b"], c["W"]
        ref = recycled(St, b, W)
        its, allowed = envelope(St, perturbed(b, 3)[1:], W,
                                extra=(int(ref.it), c["it_t"]))
        bnorm = float(torch.linalg.vector_norm(b))
        res_e = float(c["res_e"][c["it_e"] - 1])
        check(c["it_t"] < CHAIN_MAXIT and c["it_e"] < CHAIN_MAXIT
              and res_e <= CHAIN_RTOL * bnorm
              and float(ref.res_norm[int(ref.it) - 1]) <= CHAIN_RTOL * bnorm,
              f"chain step {c['k']}: a solve missed its tolerance")
        check(allowed[0] <= c["it_e"] <= allowed[1],
              f"chain step {c['k']}: kernel E it {c['it_e']} outside the "
              f"envelope {allowed} of {its}")
        err_x = rel(c["x_e"], ref.x)
        check(err_x <= 1e-3, f"chain step {c['k']}: x rel err {err_x}")
        tr, tr_ref = true_relres(St, b, c["x_e"]), true_relres(St, b, ref.x)
        check(tr <= max(1e-5, 2 * tr_ref),
              f"chain step {c['k']}: true residual {tr} / reference {tr_ref}")
        cos_e = subspace_cosines(c["W_e"], ref.W)
        cos_t = subspace_cosines(c["W_t"], ref.W)
        check(float(cos_e.min()) >= W_COSINE_MIN,
              f"chain step {c['k']}: W' of kernel E, cosines {cos_e.tolist()}")
        emit("chain_step", k=c["k"], proposals=c["proposals"], it=c["it_t"],
             ms=c["ms_t"], it_kernel_e=c["it_e"], ms_kernel_e=c["ms_e"],
             stretches=c["stretches"], restarts=c["restarts"],
             refill_ms=c["refill_ms"],
             it_reference=int(ref.it), it_envelope=its, allowed=allowed,
             x_rel_err=err_x, true_relres=tr, true_relres_reference=tr_ref,
             w_cosines_kernel_e_min=float(cos_e.min()),
             w_cosines_kernel_e=cos_e.tolist(),
             w_cosines_bf16_step_min=float(cos_t.min()),
             us_per_iteration=1e3 * c["ms_t"] / max(c["it_t"] - 1, 1),
             us_per_iteration_kernel_e=1e3 * c["ms_e"] / max(c["it_e"] - 1, 1),
             card=card)
    mean_it = float(np.mean([c["it_t"] for c in chain_steps]))
    mean_it_e = float(np.mean([c["it_e"] for c in chain_steps]))
    check(mean_it < int(it_seed) and mean_it_e < int(it_seed),
          f"chain: recycled its {mean_it} / {mean_it_e} not below the seed's "
          f"{int(it_seed)}")
    emit("chain", seed_it=int(it_seed), mean_recycled_it=mean_it,
         mean_recycled_it_kernel_e=mean_it_e, card=card)
    # how far the host holds the card back, on the last realization
    c = chain_steps[-1]
    emit("chain_device_share",
         torch_path=device_share(lambda: recycled(c["St"], c["b"], c["W"])),
         kernel_e_path=device_share(lambda: ve.vmem_eigdefpcg(
             ps, c["b"], c["W"], spdim=SPDIM, maxit=CHAIN_MAXIT,
             rtol=CHAIN_RTOL), ["stretch_kernel"]), card=card)

    for c in batched_steps:
        rows = []
        for ch in range(N_BATCH):
            St, b = fem.make_stencil_operator(plan, torch.exp(c["g"][ch]))
            its, allowed = envelope(St, perturbed(b, 2), c["W"][ch])
            check(c["its"][ch] < CHAIN_MAXIT, "chain_batched: maxit reached")
            check(allowed[0] <= c["its"][ch] <= allowed[1],
                  f"chain_batched step {c['k']} chain {ch}: it {c['its'][ch]} "
                  f"outside the envelope {allowed} of {its}")
            rows.append(dict(it=c["its"][ch], single_chain_its=its))
        emit("chain_batched_step", k=c["k"], B=N_BATCH, its=c["its"],
             proposals=c["proposals"], ms=c["ms"], chains=rows,
             projections_ms=c["proj_ms"], projection_err=c["proj_err"],
             us_per_iteration=1e3 * c["ms"] / max(max(c["its"]) - 1, 1),
             card=card)
    check(np.mean(batched_steps[-1]["its"]) < float(it0_b.float().mean()),
          "chain_batched: recycled its not below the seeds'")

    # ---- 10. the dense KL front end, and a short chain from its basis -------
    sync()
    t0 = time.perf_counter()
    m_k = fem.get_mesh(KL_NNODE)
    maps_k = fem.get_dirichlet_inds(m_k.points, m_k.point_markers)
    M_k = fem.get_mass_matrix(m_k.cells, m_k.points)
    lam_k, psi_k = kl.solve_kl(m_k.cells, m_k.points,
                               kl.make_cov("sexp", 1.0, 0.3), 30, M_k,
                               relative=0.99, method="dense")
    sync()
    ms_kl = 1e3 * (time.perf_counter() - t0)
    gram = psi_k.T @ M_k.todense().double().cpu().numpy() @ psi_k
    orth = float(np.abs(gram - np.eye(lam_k.shape[0])).max())
    check(lam_k.shape[0] >= 3 and np.all(np.diff(lam_k) <= 0)
          and np.all(lam_k > 0), f"kl: eigenvalues {lam_k}")
    check(orth <= 1e-4, f"kl: |ΨᵀMΨ − I| = {orth}")
    plan_k = fem.prepare_stencil_assembly(
        m_k, maps_k, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x)
    _, its_k = chains.run_chains(plan_k, chains.prepare_chain_states(
        lam_k, psi_k, 1), 4, nvec=10, spdim=26, maxit=1000)
    its_k = its_k[0].tolist()
    check(max(its_k) < 1000 and np.mean(its_k[1:]) < its_k[0],
          f"kl: chain iterations {its_k}")
    emit("kl", nnode=m_k.nnode, modes=int(lam_k.shape[0]), ms=ms_kl,
         orthonormality=orth, tolerance=1e-4, chain_its=its_k, card=card)


def run_kernel_h(card, St, b_full, ref_cg, realizations, kernels,
                 c_us_per_iteration):
    """Phases kernel_h and main_path_h: the whole-solve CG kernel on the
    unpadded 9-plane layout against its plain version, on bench.py's system
    and on the realizations' operators."""
    from krylov_spdes_tpu_torch.ops import pallas_cg as pc
    from krylov_spdes_tpu_torch.solvers.cg import cg

    n = St.n
    bnorm = float(torch.linalg.vector_norm(b_full))
    errs, abs_h = over_1_and_8(
        "kernel H", lambda m: pc.stencil_cg(St, b_full, m, 1e-30),
        lambda m: pc.stencil_cg_plain(St, b_full, m, 1e-30))
    xk, itk, resk = pc.stencil_cg(St, b_full, MAXIT, RTOL)
    itk = int(itk)
    # the three limits of phase 5's solves, against solvers.cg
    check(float(resk) <= RTOL * bnorm, f"kernel H: residual {float(resk)}")
    # `it` against the envelope of H's own plain version (the kernel's
    # arithmetic step by step, which differs from solvers.cg's in the order
    # of its updates): the plain version's counts on b and on H_ENVELOPE
    # copies of b changed in their last bit, and the kernel's counts on the
    # same right-hand sides, every one of which must lie within 5% of the
    # range the plain version's span
    rhs = perturbed(b_full, H_ENVELOPE)
    its_plain = [int(pc.stencil_cg_plain(St, v, MAXIT, RTOL)[1]) for v in rhs]
    its_kernel = [itk] + [int(pc.stencil_cg(St, v, MAXIT, RTOL)[1])
                          for v in rhs[1:]]
    allowed = (0.95 * min(its_plain), 1.05 * max(its_plain))
    check(all(allowed[0] <= i <= allowed[1] for i in its_kernel),
          f"kernel H: its {its_kernel} outside {allowed}, the envelope of "
          f"the plain version's {its_plain} (solvers.cg {int(ref_cg.it)})")
    err_x = rel(xk, ref_cg.x)
    check(err_x <= 1e-3, f"kernel H: x rel err {err_x}")
    tr, tr_ref = true_relres(St, b_full, xk), true_relres(St, b_full, ref_cg.x)
    check(tr <= max(1e-5, 2 * tr_ref),
          f"kernel H: true residual {tr} / reference {tr_ref}")
    x2, it2, _ = pc.stencil_cg(St, b_full, MAXIT, RTOL)
    check(int(it2) == itk and torch.equal(x2, xk),
          "kernel H: a solve does not repeat bit for bit")
    # C's method: inputs (9 planes, dir_diag, b) read once and x written
    # once; the operations the function needs in the iterations this run's
    # data took (a node an iteration: the direction r + β·p 2, the 9-plane
    # apply with dir_diag 18, pᵀAp 2, x 2, r 2, rᵀr 2). The kernel's own
    # recomputation of the direction at the eight neighbours is its design,
    # not the function's work, and is not counted
    bnd, by = bound_ms(12 * n * 4, 28 * n * (itk - 1))
    kernels["H"] = dict(
        name="stencil_cg", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/stencil_cg.cu",
        replaces="krylov_spdes_tpu/ops/pallas_cg.py:43",
        max_abs_err=abs_h, bound_ms=bnd, bound_by=by,
        **timed(lambda: pc.stencil_cg(St, b_full, MAXIT, RTOL), 5,
                ["stencil_cg_kernel"],
                lambda: pc.stencil_cg_plain(St, b_full, MAXIT, RTOL), 1))
    hplan = pc.plan_for(b_full, St.H, St.W)
    emit("kernel_h", it=itk, it_solvers_cg=int(ref_cg.it),
         its_plain_version_last_bit_changes_of_b=its_plain,
         its_kernel_last_bit_changes_of_b=its_kernel, allowed=allowed,
         rel_err=errs,
         tolerance=OVER_1_AND_8, max_abs_err_over=8, x_rel_err=err_x,
         true_relres=tr, true_relres_reference=tr_ref,
         us_per_iteration=1e3 * kernels["H"]["ms"] / (itk - 1),
         us_per_iteration_events=1e3 * kernels["H"]["ms_per_call"] / (itk - 1),
         plan=dataclasses.asdict(hplan), barriers_per_iteration=CG_BARRIERS,
         kernel_c_us_per_iteration=c_us_per_iteration, library="none",
         card=card, **{k: v for k, v in kernels["H"].items()
                       if k not in NAMING})

    # the main path of H, with its count at 0
    pc.stencil_cg.launches = 0
    solves = []
    for S_r, b_r in [(St, b_full)] + [(r["St"], r["b"]) for r in realizations]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it, res = pc.stencil_cg(S_r, b_r, MAXIT, RTOL)
        torch.cuda.synchronize()
        solves.append((S_r, b_r, x, int(it), float(res),
                       1e3 * (time.perf_counter() - t0)))
    kernels["H"]["launches"] = pc.stencil_cg.launches
    emit("main_path_h", launches={"H": pc.stencil_cg.launches})
    for k, (S_r, b_r, x, it, res, ms) in enumerate(solves):
        ref = ref_cg if k == 0 else cg(S_r, b_r, maxit=MAXIT, rtol=RTOL)
        check(it < MAXIT and res <= RTOL * float(torch.linalg.vector_norm(b_r)),
              f"stencil_cg solve {k}: it {it}, residual {res}")
        tr, tr_ref = true_relres(S_r, b_r, x), true_relres(S_r, b_r, ref.x)
        check(tr <= max(1e-5, 2 * tr_ref),
              f"stencil_cg solve {k}: true residual {tr} / reference {tr_ref}")
        emit("solve_stencil_cg", system="bench" if k == 0 else f"realization {k}",
             it=it, it_solvers_cg=int(ref.it), x_rel_err=rel(x, ref.x),
             true_relres=tr, true_relres_reference=tr_ref, ms=ms,
             us_per_iteration=1e3 * ms / max(it - 1, 1), card=card)


def large_system(nnode=1000000):
    """bench.py's system at 1000 x 1000 (the coefficient from numpy seed 0):
    the StencilOp and the full right-hand side."""
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.ops.stencil import build_stencil_op, to_full_vector
    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                        lambda x, y: -1.0 + 0.0 * x,
                                        lambda x, y: 0.0 * x)
    A, b = fem.do_isotropic_elliptic_assembly(asm, np.exp(
        SIGMA * np.random.default_rng(0).normal(size=mesh.nnode)))
    h = int(round(np.sqrt(mesh.nnode)))
    return build_stencil_op(A, maps, (h, h)), to_full_vector(maps, b, mesh.nnode)


def run_large(card):
    """Kernel B at 1000 x 1000 (kernel_b_large: against its plain version,
    timed L2-cold), then kernels H, C and D there, where a band's planes do
    not fit in shared memory beside its vectors and are read from global
    memory: each against its plain version over 1 and 8 iterations (as at
    500 x 500), a fixed-count solve twice bit for bit, and the time an
    iteration (211 less 11 iterations, tol² = 0)."""
    from krylov_spdes_tpu_torch.ops import fused_cg as fc
    from krylov_spdes_tpu_torch.ops import pallas_cg as pc
    St, b = large_system()
    ps = fc.build_padded_stencil(St)
    bp = fc.pad_vec(ps, b)
    # kernel B at this size: against its plain version, timed L2-cold
    check(ps.K == 5, f"kernel_b_large: K = {ps.K}")
    p = fc.pad_vec(ps, torch.randn(St.n, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)))
    beta = torch.tensor(0.3, device="cuda")
    errs, _ = check_sweep("kernel_b_large", fc, ps, bp, p, beta)
    copies = lambda: (dataclasses.replace(ps, planes=ps.planes.clone()),  # noqa: E731
                      bp.clone(), p.clone(), beta.clone())
    ms, ms_call, how = timings(cold(fc.cg_sweep, copies), 100)
    bnd, by = bound_ms((ps.K + 4) * ps.R * ps.C * 4, 21 * St.n)
    check(ms >= bnd, f"kernel_b_large: {ms} ms is below its bound {bnd} ms")
    emit("kernel_b_large", H=St.H, W=St.W, K=ps.K, rel_err=errs,
         tolerance=1e-5, bit_equal=True, ms_l2_cold=ms, ms_per_call=ms_call,
         timing=how, bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
         plan=dataclasses.asdict(fc.sweep_plan_for(ps, bp)), card=card)
    minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    zero = bp.new_zeros(())
    cases = (
        ("kernel_h_large", pc.plan_for(b, St.H, St.W),
         lambda m: pc.stencil_cg(St, b, m, 0.0),
         lambda m: pc.stencil_cg_plain(St, b, m, 0.0), {}),
        ("kernel_c_large", fc.plan_for(ps, bp, False),
         lambda m: fc.whole_cg(ps, bp, m, zero),
         lambda m: fc.whole_cg_plain(ps, bp, m, zero), {"K": ps.K}),
        ("kernel_d_large", fc.plan_for(ps, bp, True),
         lambda m: fc.whole_pcg(ps, minv, bp, m, zero),
         lambda m: fc.whole_pcg_plain(ps, minv, bp, m, zero), {"K": ps.K}))
    few, many = 11, 211
    for phase, plan, kern, plain, extra in cases:
        check(not plan.planes, f"{phase}: plan {plan}")
        errs, _ = over_1_and_8(phase, kern, plain)
        x1, it1, _ = kern(many)
        x2, it2, _ = kern(many)
        check(int(it1) == int(it2) == many and torch.equal(x1, x2),
              f"{phase}: a solve does not repeat bit for bit")
        t_few = cuda_ms(lambda: kern(few), 3)
        t_many = cuda_ms(lambda: kern(many), 3)
        emit(phase, H=St.H, W=St.W, **extra, rel_err=errs,
             tolerance=OVER_1_AND_8, repeats_bit_for_bit=True,
             plan=dataclasses.asdict(plan), barriers_per_iteration=CG_BARRIERS,
             us_per_iteration_events=1e3 * (t_many - t_few) / (many - few),
             card=card)


def clone_state(s):
    """A sampler state (single or batched) with copies of its generators, so
    that a step can be run again from the same random stream."""
    def copy(gen):
        out = torch.Generator(device=gen.device)
        out.set_state(gen.get_state())
        return out
    gen = [copy(g) for g in s.gen] if isinstance(s.gen, list) else copy(s.gen)
    return dataclasses.replace(s, gen=gen)


def host_ms(fn, reps=5):
    """Host-clock ms per call of fn(), synchronised, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def tf32_off():
    return not (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest")


def dd_chain(card, phase, plan, part, state, nvec, spdim, maxit, warm, steps):
    """seed_dd_chain, `warm` untimed steps and `steps` timed ones; checks
    `it` < maxit and the mean recycled `it` below the seed's. Returns the
    final (state, W) and, for the last step, (state before, W before)."""
    from krylov_spdes_tpu_torch import dd_chains
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    W, it0, _ = dd_chains.seed_dd_chain(plan, part, state, nvec, spdim, maxit)
    sync()
    seed_ms = 1e3 * (time.perf_counter() - t0)
    check(int(it0) < maxit, f"{phase}: the seed solve hit maxit")
    step = dd_chains.make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim,
                                        maxit=maxit)
    rows, before = [], None
    for k in range(warm + steps):
        before = (clone_state(state), W)
        sync()
        t0 = time.perf_counter()
        state, W, it, cnt = step(state, W)
        sync()
        rows.append(dict(it=int(it), proposals=int(cnt),
                         ms=1e3 * (time.perf_counter() - t0),
                         timed=k >= warm))
        check(int(it) < maxit, f"{phase}: step {k} hit maxit")
        check(tf32_off(), f"{phase}: TF32 is on after step {k}")
        check(bool(torch.isfinite(W).all()), f"{phase}: W' is not finite")
    mean_it = float(np.mean([r["it"] for r in rows]))
    check(mean_it < int(it0), f"{phase}: mean recycled it {mean_it} not below "
                              f"the seed's {int(it0)}")
    emit(phase, ndom=plan.ndom, nI=plan.nI, nG=plan.nG, n_gamma=plan.n_gamma,
         nvec=nvec, spdim=spdim, maxit=maxit, seed_it=int(it0),
         seed_ms=seed_ms, steps=rows, mean_recycled_it=mean_it,
         median_ms_per_step=float(np.median(
             [r["ms"] for r in rows if r["timed"]])), card=card)
    return state, W, before, step


def run_dd_slice(card, mesh250, kernels, dev="cuda"):
    """The Schur-DD flagship chain: DD refill -> condensation ->
    Neumann-Neumann -> recycled eigDef-PCG on Γ, single and batched."""
    from krylov_spdes_tpu_torch import chains, dd_chains, entry, fem
    from krylov_spdes_tpu_torch.fem import dd_stencil, schur
    from krylov_spdes_tpu_torch.samplers import samplers
    from krylov_spdes_tpu_torch.solvers.cg import pcg
    from krylov_spdes_tpu_torch.solvers.defcg import _deflation_setup, _eigdef_impl
    from krylov_spdes_tpu_torch.solvers.eig_common import thick_restart_basis

    sync = torch.cuda.synchronize
    f_src = lambda x, y: -1.0 + 0.0 * x   # noqa: E731
    u_dir = lambda x, y: 0.0 * x          # noqa: E731
    ndom, nvec, maxit = DD_NDOM, DD_NVEC, DD_MAXIT
    spdim = max(3 * ndom, 2 * nvec + 1)

    def one_state(lam, psi, key=0):
        return chains.chain_state(chains.prepare_chain_states(
            lam, psi, 1, base_key=key), 0)

    # ---- dd_protocol: bench.py's DD configuration ----------------------------
    t0 = time.perf_counter()
    mesh = fem.get_mesh(DD_NNODE)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, part, plan = dd_stencil.prepare_dd_stencil_assembly(
        mesh, maps, f_src, u_dir, ndom)
    lam, psi = sine_basis(mesh.points)
    emit("dd_setup", nnode=mesh.nnode, ndom=ndom, hM=plan.hM, wM=plan.wM,
         nI=plan.nI, nG=plan.nG, n_gamma=plan.n_gamma,
         seconds=time.perf_counter() - t0)
    check(plan.kflat.is_cuda and plan.kflat.dtype == torch.float32,
          "the DD plan lives on the card in float32")
    state, W, (s_prev, W_prev), step = dd_chain(
        card, "dd_protocol", plan, part, one_state(lam, psi), nvec, spdim,
        maxit, warm=4, steps=5)

    # ---- dd_repeat: one step twice from the same state and W ------------------
    out = [step(clone_state(s_prev), W_prev) for _ in range(2)]
    check(int(out[0][2]) == int(out[1][2]) and out[0][3] == out[1][3],
          f"dd_repeat: it {int(out[0][2])} / {int(out[1][2])}")
    check(torch.equal(out[0][1], out[1][1]) and torch.equal(out[0][0].g,
                                                            out[1][0].g),
          "dd_repeat: W' differs between two runs of one step")
    emit("dd_repeat", it=int(out[0][2]), w_bit_equal=True, card=card)

    # ---- TF32 stays off inside a step even when the caller turned it on ------
    seen = []
    W_c, _, M_c = dd_chains.seed_dd_chain(plan, part, s_prev, nvec, spdim,
                                          maxit, constant_precond=True)

    def probe(r):
        seen.append(torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
        return M_c(r)

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, _, it_c, _ = dd_chains.make_dd_chain_step(
            plan, part, nvec=nvec, spdim=spdim, maxit=maxit,
            M_const=probe)(clone_state(s_prev), W_c)
        restored = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(seen and not any(seen) and restored,
          f"dd_tf32: TF32 on inside a step ({sum(seen)} of {len(seen)} "
          f"applies), restored {restored}")
    check(int(it_c) < maxit, "dd_tf32: the constant-preconditioner step hit maxit")
    emit("dd_tf32", applies_seen=len(seen), tf32_on_inside=False,
         it_constant_precond=int(it_c), card=card)

    # ---- dd_parts: the parts of one step, each alone --------------------------
    g = s_prev.g
    coeff = torch.exp(g)
    subs = dd_stencil._tile_inputs(plan, coeff)[1]
    D, E = dd_stencil._interior_blocks(plan, subs)
    S, b_s, _ = dd_stencil.condense_dd_stencil(plan, coeff)
    Sd = schur.assemble_local_schurs(S)
    kept = schur._masked_pinv(Sd, S.gmask, return_kept=True)[1]
    A = schur.assembled_schur_operator(S, Sd=Sd)
    M = schur.prepare_neumann_neumann_schur_precond(S, Sd=Sd)
    q = torch.linalg.qr(torch.randn(spdim, spdim, device=dev))[0]
    T = (q * torch.linspace(0.1, 10.0, spdim, device=dev)) @ q.T
    # kept eigenvalues of the pinv (rule: λ > √eps·max|λ|, eps of the working
    # type). A floating tile's local Schur complement has the constants as
    # its null space, a tile on the Dirichlet boundary has none: that is what
    # the rule keeps when the same realization is condensed in float64 (the
    # blocks must be float64 too: the null mode of blocks rounded to float32
    # sits at ~1e-7·max|λ|, above float64's √eps). In float32 √eps = 3.5e-4
    # also drops genuine small eigenvalues where the coefficient's contrast
    # inside a tile is large; it must never keep more than float64 does,
    # and is reported beside it
    n_gd = S.gmask.sum(dim=1).to(torch.int64)
    plan64 = dd_stencil.prepare_dd_stencil_assembly(
        mesh, maps, f_src, u_dir, ndom, dtype=torch.float64)[2]
    S64 = dd_stencil.condense_dd_stencil(plan64, coeff.double())[0]
    P64, kept64 = schur._masked_pinv(schur.assemble_local_schurs(S64),
                                     S64.gmask, return_kept=True)
    del plan64, S64
    check(bool((kept <= kept64).all()) and bool((kept >= 1).all())
          and bool((n_gd - kept64 <= 1).all()),
          f"dd_parts: pinv kept {kept.tolist()} (float64 rule "
          f"{kept64.tolist()}) of {n_gd.tolist()}")
    # what the float32 rule costs: the same float32 solve (this realization,
    # the recycled basis W) with the NN preconditioner from the float32 pinv
    # and from the float64 pinv of the float64 blocks, rounded to float32
    M64 = partial(schur._nn_apply, P64.float(), S.gammad_to_gamma, S.gmask,
                  S.gamma_gather, 1.0 / S.gamma_cnt)
    it_rule = {k: int(_eigdef_impl(
        A, Mk, b_s, torch.zeros_like(b_s), W_prev, nvec, spdim, maxit,
        chains.effective_rtol(torch.float32), True, True)[1])
        for k, Mk in (("float32", M), ("float64", M64))}
    check(max(it_rule.values()) < maxit, f"dd_parts: solves {it_rule}")
    emit("dd_parts", card=card, it_by_pinv_rule=it_rule,
         draw_ms=host_ms(lambda: samplers.draw(clone_state(s_prev))),
         refill_ms=host_ms(lambda: dd_stencil._tile_inputs(plan, coeff)),
         interior_blocks_ms=host_ms(
             lambda: dd_stencil._interior_blocks(plan, subs)),
         factorisation_ms=host_ms(lambda: schur.bt_factor_batched(D, E)),
         condense_ms=host_ms(
             lambda: dd_stencil.condense_dd_stencil(plan, coeff)),
         assemble_local_schurs_ms=host_ms(
             lambda: schur.assemble_local_schurs(S)),
         masked_pinv_ms=host_ms(lambda: schur._masked_pinv(Sd, S.gmask)),
         schur_apply_ms=host_ms(lambda: A(b_s), 20),
         schur_apply_matrix_free_ms=host_ms(lambda: S.matvec(b_s)),
         nn_apply_ms=host_ms(lambda: M(b_s), 20),
         deflation_setup_ms=host_ms(lambda: _deflation_setup(
             A, W_prev, torch.zeros_like(b_s), b_s)),
         thick_restart_basis_ms=host_ms(
             lambda: int(thick_restart_basis(T, nvec, spdim)[2])),
         pinv_kept_per_tile=kept.tolist(),
         pinv_kept_per_tile_float64_rule=kept64.tolist(),
         n_gammad=n_gd.tolist(), spdim=spdim, nvec=nvec)
    emit("dd_device_share", card=card,
         **device_share(lambda: step(clone_state(s_prev), W_prev)))
    del subs, D, E, S, Sd, A, M, M64, P64

    # ---- dd_batched: B = 4 on the protocol mesh --------------------------------
    states = chains.prepare_chain_states(lam, psi, N_BATCH, base_key=10)
    sync()
    t0 = time.perf_counter()
    Wb, its0 = dd_chains.seed_dd_chains_batched(plan, part, states, nvec,
                                                spdim, maxit)
    sync()
    seed_ms = 1e3 * (time.perf_counter() - t0)
    bstep = dd_chains.make_batched_dd_chain_step(plan, part, nvec=nvec,
                                                 spdim=spdim, maxit=maxit)
    rows = []
    for k in range(2):
        # the single-chain step from the same state, and from W and 4 copies
        # of W changed in their last bit: in float32 a solve that needs 35
        # iterations moves by several under such a change, so the batched
        # count is held within 2 (the JAX tests' own limit between the two
        # layouts, in float64) of the range these span. The batched step
        # from the same 4 copies is held to the same limit: if its counts
        # move as the single-chain step's do, the spread is rounding and not
        # the batched layout
        W_copies = [perturbed(Wb[c], 4) for c in range(N_BATCH)]
        single = [[int(step(chains.chain_state(clone_state(states), c), Wc)[2])
                   for Wc in W_copies[c]] for c in range(N_BATCH)]
        batched = [bstep(clone_state(states), torch.stack(
            [W_copies[c][j] for c in range(N_BATCH)]))[2].tolist()
            for j in range(1, 5)]
        sync()
        t0 = time.perf_counter()
        states, Wb, its, cnt = bstep(states, Wb)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        its = its.tolist()
        check(max(its) < maxit, f"dd_batched: step {k} hit maxit")
        batched = [list(col) for col in zip(its, *batched)]
        check(all(min(s) - 2 <= it <= max(s) + 2
                  for bs, s in zip(batched, single) for it in bs),
              f"dd_batched step {k}: its {batched} / single-chain {single}")
        rows.append(dict(its=its, single_chain_its=[s[0] for s in single],
                         single_chain_its_last_bit_changes_of_w=single,
                         its_last_bit_changes_of_w=batched,
                         proposals=cnt.tolist(), ms=ms,
                         us_per_iteration=1e3 * ms / max(max(its) - 1, 1)))
    check(np.mean(rows[-1]["its"]) < float(its0.float().mean()),
          "dd_batched: recycled its not below the seeds'")
    emit("dd_batched", B=N_BATCH, seed_its=its0.tolist(), seed_ms=seed_ms,
         steps=rows, tolerance="the batched step's it, from W and from 4 "
         "last-bit changes of W, within 2 of the range of the single-chain "
         "step's it from the same 5", card=card)

    # ---- dd_general: partitioner + routing plan, dense interiors ---------------
    t0 = time.perf_counter()
    epart_g, _ = fem.mesh_partition(mesh.cells, mesh.points, ndom,
                                    mesh.cell_neighbors, use_native=True)
    part_g = fem.set_subdomains(mesh.cells, epart_g, maps, ndom)
    plan_g = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart_g, part_g,
                                     maps, f_src, u_dir)
    emit("dd_general_setup", nI=plan_g.nI, nG=plan_g.nG,
         n_gamma=plan_g.n_gamma, elements_per_part=np.bincount(
             epart_g, minlength=ndom).tolist(),
         seconds=time.perf_counter() - t0)
    dd_chain(card, "dd_general", plan_g, part_g, one_state(lam, psi), nvec,
             spdim, maxit, warm=0, steps=2)
    run_certified_slice(card, mesh, maps, part_g, plan_g, lam, psi, kernels)
    del plan_g, part_g
    run_precond_apply(card)
    sync()
    t0 = time.perf_counter()
    fn, (s_e, W_e) = entry.entry()
    s_e2, W_e2, it_e, cnt_e = fn(s_e, W_e)
    sync()
    check(1 < it_e < 60 and bool(torch.isfinite(W_e2).all()) and W_e2.is_cuda,
          f"dd_entry: it {it_e}")
    emit("dd_entry", it=int(it_e), proposals=int(cnt_e), n_gamma=W_e.shape[0],
         ms_build_seed_step=1e3 * (time.perf_counter() - t0), card=card)
    del plan, part, states, Wb
    torch.cuda.empty_cache()

    # ---- dd_full: the 500 x 500 grid, 8 x 8 tiles ------------------------------
    t0 = time.perf_counter()
    maps = fem.get_dirichlet_inds(mesh250.points, mesh250.point_markers)
    _, part, plan = dd_stencil.prepare_dd_stencil_assembly(
        mesh250, maps, f_src, u_dir, DD_FULL_NDOM)
    lam, psi = sine_basis(mesh250.points)
    emit("dd_full_setup", nnode=mesh250.nnode, ndom=DD_FULL_NDOM, hM=plan.hM,
         wM=plan.wM, nI=plan.nI, nG=plan.nG, n_gamma=plan.n_gamma,
         a_ig_mb=plan.ndom * plan.nI * plan.nG * 4 / 1e6,
         seconds=time.perf_counter() - t0)
    spdim_f = DD_FULL_SPDIM
    torch.cuda.reset_peak_memory_stats()
    state, W, (s_prev, W_prev), step = dd_chain(
        card, "dd_full", plan, part, one_state(lam, psi), nvec, spdim_f,
        maxit, warm=0, steps=3)
    # the last step's Γ solution (the same solve again: a step repeats bit
    # for bit), back-substituted and merged, against the monolithic system
    coeff = torch.exp(state.g)
    S, b_s, b_I = dd_stencil.condense_dd_stencil(plan, coeff)
    Sd = schur.assemble_local_schurs(S)
    x_g, it_g, _, W_again = _eigdef_impl(
        schur.assembled_schur_operator(S, Sd=Sd),
        schur.prepare_neumann_neumann_schur_precond(S, Sd=Sd), b_s,
        torch.zeros_like(b_s), W_prev, nvec, spdim_f, maxit,
        chains.effective_rtol(torch.float32), True, True)
    check(torch.equal(W_again, W), "dd_full: the step's solve did not repeat")
    u_I = schur.get_subdomain_solutions(S, x_g, b_I)
    u = schur.merge_subdomain_solutions(part, maps, mesh250.points, u_dir,
                                        x_g, u_I)
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    St, b = fem.make_stencil_operator(plan.splan, coeff)
    dinv = 1.0 / St.diagonal()
    # a float32 solution cannot have a float64 residual below its own
    # float32 floor u32·‖|A||u|‖/‖b‖ (rounding u alone costs that much), and
    # the DD solution (direct interior solves, the interface at 1e-5) must
    # come within twice that floor: a wrong back-substitution or merge in a
    # few tiles gives a residual of order 1. The plain float32 Jacobi-PCG of
    # the same monolithic system at the chain's tolerance is printed beside
    # it (its recurrence residual parts from the true one long before 1e-5)
    ref = pcg(St, b, M=lambda v: dinv * v, maxit=CHAIN_MAXIT,
              rtol=chains.effective_rtol(torch.float32))
    tr, tr_ref = true_relres(St, b, u), true_relres(St, b, ref.x)
    floor = f32_floor(St, b, u)
    check(tr <= 2 * floor, f"dd_full: true residual of the merged DD "
                           f"solution {tr} / its float32 floor {floor}")
    emit("dd_full_solution", it=int(it_g), true_relres=tr, f32_floor=floor,
         limit="2 x the float32 floor of the merged solution",
         true_relres_plain_float32_pcg=tr_ref,
         rel_diff_to_plain_solve=rel(u, ref.x), it_plain_pcg=int(ref.it),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)


# ---------------------------------------------------------------------------
# Certified 1e-7 beyond the stencil and the preconditioner family: the
# certified arms of Examples 06, 07 and 09 on the general DD plan, and each
# preconditioner's apply on the card against its float64 build on the CPU
# ---------------------------------------------------------------------------

def synchronizer(dev):
    return torch.cuda.synchronize if dev == "cuda" else (lambda: None)


def with_tf32_requested(fn):
    """fn() with the caller's TF32 setting on: a certified solve must switch
    it off inside."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def probed(M, seen):
    """M, recording at each apply whether TF32 was on."""
    def apply(r):
        seen.append(torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
        return M(r)
    return apply


def pair64(pair):
    return pair[0].double() + pair[1].double()


def sparse_true_relres(A, b, pair):
    """‖b − A x‖/‖b‖ in float64 through the CSR segment sums (csr_spmv), a
    path apart from the ELL residual that certified the solve."""
    from krylov_spdes_tpu_torch.ops.sparse import csr_spmv
    b64 = b.double()
    r = b64 - csr_spmv(A.with_data(A.data.double()), pair64(pair))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def stencil_true_relres(St, b, pair):
    """‖b − A x‖/‖b‖ in float64 through torch's CSR product (csr_of)."""
    b64 = b.double()
    r = b64 - csr_of(St).to(torch.float64) @ pair64(pair)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def dd_true_relres(plan, S, blocks, uI_pair, uG_pair):
    """‖(r_I, r_Γ)‖/‖(b_I, b_Γ)‖ of the full DD system in float64, the Γ
    sum by index_add_ (apart from the pullback sum that certified it)."""
    A_II, A_IG, A_GGd, b_I, b_G = [t.double() for t in blocks]
    im, gm = plan.imask.double(), plan.gmask.double()
    g2g = S.gammad_to_gamma
    uI, uG = pair64(uI_pair), pair64(uG_pair)
    A_II = A_II * im[:, :, None] * im[:, None, :]
    A_IG = A_IG * im[:, :, None] * gm[:, None, :]
    A_GG = A_GGd * gm[:, :, None] * gm[:, None, :]
    b_I = b_I * im
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731
    xd = uG[g2g] * gm
    rI = (b_I - mv(A_II, uI) - mv(A_IG, xd)) * im
    sd = (mv(A_IG.transpose(-1, -2), uI) + mv(A_GG, xd)) * gm
    rG = b_G.clone().index_add_(0, g2g.reshape(-1), -sd.reshape(-1))
    bnorm = torch.sqrt(torch.sum(b_I * b_I) + torch.sum(b_G * b_G))
    return float(torch.sqrt(torch.sum(rI * rI) + torch.sum(rG * rG)) / bnorm)


def check_certified(phase, r, true_relres, seen):
    check(not r.breakdown, f"{phase}: breakdown (refines {r.refines})")
    check(true_relres <= CERT_RTOL,
          f"{phase}: float64 true residual {true_relres} above {CERT_RTOL}")
    check(seen and not any(seen), f"{phase}: TF32 on inside the solve "
                                  f"({sum(seen)} of {len(seen)} applies)")


def run_certified_slice(card, mesh, maps, part, plan, lam, psi, kernels,
                        dev="cuda", nreal06=EX06_REALIZATIONS,
                        nreal07=EX07_REALIZATIONS, nsmp=EX09_SAMPLES):
    """ex06_certified, ex07_certified, ex09_certified on the general DD plan
    of dd_general (mesh, maps, part, plan), float32 on `dev`."""
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.fem import schur
    from krylov_spdes_tpu_torch.ops import stencil_kernel as sk
    from krylov_spdes_tpu_torch.ops.df32 import build_gamma_pullback
    from krylov_spdes_tpu_torch.ops.stencil import (build_stencil_op,
                                                    to_full_vector)
    from krylov_spdes_tpu_torch.precond import (
        amg_precond, block_jacobi_precond, prepare_block_jacobi_plan,
        prepare_lorasc_precond)
    from krylov_spdes_tpu_torch.precond.dd_preconds import (
        _dense_gamma_solve, assemble_gamma_matrix)
    from krylov_spdes_tpu_torch.precond.stencil_amg import stencil_amg_precond
    from krylov_spdes_tpu_torch.samplers import samplers
    from krylov_spdes_tpu_torch.solvers import (defpcg, eigdefpcg, eigpcg, pcg,
                                                refined_dd_pcg, refined_pcg,
                                                refined_pcg_sparse,
                                                refined_recycled_solve)
    sync = synchronizer(dev)
    f_src = lambda x, y: -1.0 + 0.0 * x   # noqa: E731
    u_dir = lambda x, y: 0.0 * x          # noqa: E731
    ndom, n_gamma = part.ndom, part.n_gamma
    nvec_lorasc = min(25, n_gamma // 2 or 1)
    cert = dict(rtol=CERT_RTOL, inner_rtol=CERT_INNER_RTOL)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_dir, device=dev)
    ones = torch.ones(mesh.nnode, dtype=torch.float32, device=dev)
    A0, _ = fem.do_isotropic_elliptic_assembly(asm, ones)
    blocks0 = fem.assemble_dd_values(plan, ones)
    S0 = schur.prepare_schur_operator(plan, part, *blocks0[:3])

    # ---- ex06_certified (ex06_pcg_stochastic.py:57-128) ------------------------
    t_phase = time.perf_counter()
    m1 = int(round(np.sqrt(mesh.nnode)))
    St0 = build_stencil_op(A0, maps, (m1, m1))
    bj_plan = prepare_block_jacobi_plan(A0, max(2, ndom))

    def lorasc(coeff, **kw):
        blocks = fem.assemble_dd_values(plan, coeff)
        S = schur.prepare_schur_operator(plan, part, *blocks[:3])
        return prepare_lorasc_precond(S, part, maps, nvec=nvec_lorasc,
                                      eps_threshold=0.01, **kw)

    def build(name, A, coeff):
        sync()
        t0 = time.perf_counter()
        if name == "amg":
            M = amg_precond(A)
        elif name == "samg":
            M = stencil_amg_precond(St0.with_csr_data(A.data))
        elif name == "bj":
            M = block_jacobi_precond(A, max(2, ndom), plan=bj_plan)
        else:
            M = lorasc(coeff)
        sync()
        return M, 1e3 * (time.perf_counter() - t0)

    strategies = ("amg", "lorasc", "bj", "samg")
    const = {s: build(s, A0, ones) for s in strategies}
    smp = samplers.prepare_mc_sampler(lam, psi, key=0, device=dev)
    rows, samg_launches, samg_its = [], 0, 0
    for ireal in range(nreal06):
        smp, _ = samplers.draw(smp)
        coeff = torch.exp(smp.g)
        A, b = fem.do_isotropic_elliptic_assembly(asm, coeff)
        bnorm = float(torch.linalg.vector_norm(b))
        for s in strategies:
            for mode in ("const", "rebuilt"):
                M, build_ms = const[s] if mode == "const" else build(s, A,
                                                                     coeff)
                seen = []
                sync()
                t0 = time.perf_counter()
                if s == "samg":
                    Ak = St0.with_csr_data(A.data)
                    bk = to_full_vector(maps, b, mesh.nnode)
                    sk.stencil_spmv.launches = 0
                    r = with_tf32_requested(lambda: refined_pcg(
                        Ak, bk, M=probed(M, seen), **cert))
                    sync()
                    samg_launches += sk.stencil_spmv.launches
                    samg_its += int(r.it)
                    forms = {"host": r}
                    tr = stencil_true_relres(Ak, bk, r.x_df32)
                else:
                    forms = {st: with_tf32_requested(
                        lambda st=st: refined_pcg_sparse(
                            A, b, M=probed(M, seen), single_trace=st,
                            **cert)) for st in (True, False)}
                    sync()
                    r = forms[True]
                    check(all(int(f.it) == int(r.it)
                              and f.refines == r.refines
                              and float(f.res_norm[0]) == float(r.res_norm[0])
                              for f in forms.values()),
                          f"ex06_certified {s}: the single_trace forms differ")
                    tr = sparse_true_relres(A, b, r.x_df32)
                solve_ms = 1e3 * (time.perf_counter() - t0) / len(forms)
                check_certified(f"ex06_certified {s}_{mode} real {ireal}", r,
                                tr, seen)
                rows.append(dict(real=ireal, arm=f"{s}_{mode}", it=int(r.it),
                                 refines=r.refines,
                                 certified_relres=float(r.res_norm[0]) / bnorm,
                                 true_relres=tr, build_ms=build_ms,
                                 solve_ms=solve_ms, forms=len(forms)))
        if ireal == 0:
            # the same LORASC build on the randomized range finder (at
            # n_Γ ≈ 1.5k "auto" takes the exact pairs)
            sync()
            t0 = time.perf_counter()
            M_rand = lorasc(coeff, low_rank_correction="randomized")
            sync()
            rand_ms = 1e3 * (time.perf_counter() - t0)
            seen = []
            r = with_tf32_requested(lambda: refined_pcg_sparse(
                A, b, M=probed(M_rand, seen), **cert))
            check_certified("ex06_certified lorasc_randomized", r,
                            sparse_true_relres(A, b, r.x_df32), seen)
            it_rand = int(r.it)
    check(samg_launches == samg_its,
          f"ex06_certified: {samg_launches} launches of kernel A for the "
          f"samg arm's {samg_its} inner iterations")
    kernels["A"]["launches"] += samg_launches
    it_of = {(row["real"], row["arm"]): row["it"] for row in rows}
    emit("ex06_certified", nnode=mesh.nnode, ndom=ndom, n_gamma=n_gamma,
         realizations=nreal06, rows=rows, lorasc_randomized=dict(
             it=it_rand, it_exact=it_of[(0, "lorasc_rebuilt")],
             build_ms=rand_ms),
         rebuilt_below_const={s: [it_of[(i, f"{s}_rebuilt")]
                                  <= it_of[(i, f"{s}_const")]
                                  for i in range(nreal06)] for s in strategies},
         kernel_a_launches_samg=samg_launches,
         seconds=time.perf_counter() - t_phase, card=card)

    # ---- ex07_certified (ex07_pcg_schur_stochastic.py:119-152) ----------------
    t_phase = time.perf_counter()
    Pnn0 = schur.prepare_neumann_neumann_schur_precond(S0)
    pull = build_gamma_pullback(S0.gammad_to_gamma, S0.gmask, S0.n_gamma)
    smp = samplers.prepare_mc_sampler(lam, psi, key=0, device=dev)
    rows, repeat = [], None
    for ireal in range(nreal07):
        smp, _ = samplers.draw(smp)
        blocks = fem.assemble_dd_values(plan, torch.exp(smp.g))
        S = schur.prepare_schur_operator(plan, part, *blocks[:3])
        Sd = schur.assemble_local_schurs(S)
        inner = schur.assembled_schur_operator(S, Sd)
        sync()
        t0 = time.perf_counter()
        arms = [("nn_const", Pnn0),
                ("nn_rebuilt", schur.prepare_neumann_neumann_schur_precond(
                    S, Sd=Sd)),
                ("gamma_chol", partial(_dense_gamma_solve,
                                       torch.linalg.cholesky(
                                           assemble_gamma_matrix(S))))]
        sync()
        build_ms = 1e3 * (time.perf_counter() - t0)

        def solve(Mp, seen):
            return with_tf32_requested(lambda: refined_dd_pcg(
                plan, S, inner, blocks[3], blocks[4], *blocks[:3],
                M=probed(Mp, seen), pull=pull, **cert))

        for name, Mp in arms:
            seen = []
            sync()
            t0 = time.perf_counter()
            r = solve(Mp, seen)
            sync()
            solve_ms = 1e3 * (time.perf_counter() - t0)
            tr = dd_true_relres(plan, S, blocks, r.u_I, r.x_df32)
            check_certified(f"ex07_certified {name} real {ireal}", r, tr, seen)
            rows.append(dict(real=ireal, arm=name, it=int(r.it),
                             refines=r.refines,
                             certified_relres=float(r.res_norm[0]) / r.bnorm,
                             true_relres=tr, solve_ms=solve_ms,
                             build_ms=build_ms if name != "nn_const" else 0.0))
            if ireal == 0 and name == "nn_rebuilt":
                again = solve(Mp, [])
                same = (int(again.it) == int(r.it) and all(
                    torch.equal(a, c) for a, c in zip(
                        again.x_df32 + again.u_I, r.x_df32 + r.u_I)))
                check(same, "ex07_certified: a certified DD solve run twice "
                            "gave another it or other bits of x_df32")
                repeat = dict(arm=name, it=int(again.it), bit_equal=same)
    emit("ex07_certified", nnode=mesh.nnode, ndom=ndom, n_gamma=n_gamma,
         realizations=nreal07, rows=rows, repeat=repeat,
         rebuilt_below_const=[
             rows[3 * i + 1]["it"] <= rows[3 * i]["it"] for i in range(nreal07)],
         seconds=time.perf_counter() - t_phase, card=card)

    # ---- ex09_certified (ex09_defpcg_mcmc.py:57-170) ---------------------------
    t_phase = time.perf_counter()
    nvec = int(1.25 * ndom)
    spdim = max(3 * ndom, 2 * nvec + 1)
    sync()
    t0 = time.perf_counter()
    M0 = prepare_lorasc_precond(S0, part, maps, nvec=nvec_lorasc,
                                eps_threshold=0.01)
    sync()
    m0_ms = 1e3 * (time.perf_counter() - t0)
    methods = ("pcg", "eigpcg", "eigdefpcg", "defpcg")
    its = {m: [] for m in methods}
    ranks = {m: [] for m in methods}
    W = {m: None for m in methods}
    smp = samplers.prepare_mcmc_sampler(lam, psi, key=0, device=dev)
    rows = []
    for s in range(nsmp):
        if s > 0:
            smp, _ = samplers.draw(smp)
        A, b = fem.do_isotropic_elliptic_assembly(asm, torch.exp(smp.g))
        bnorm = float(torch.linalg.vector_norm(b))
        for m in methods:
            seen = []
            kw = dict(M=probed(M0, seen), maxit=EX09_MAXIT,
                      rtol=CERT_INNER_RTOL)
            if m == "eigpcg" or (m == "eigdefpcg" and W[m] is None):
                first = lambda: eigpcg(A, b, nvec=nvec, spdim=spdim, **kw)  # noqa: E731
            elif m == "eigdefpcg":
                first = lambda: eigdefpcg(A, b, W=W[m], spdim=spdim, **kw)  # noqa: E731
            elif m == "defpcg" and W["eigpcg"] is not None:
                first = lambda: defpcg(A, b, W=W["eigpcg"], **kw)  # noqa: E731
            else:
                first = lambda: pcg(A, b, **kw)  # noqa: E731
            sync()
            t0 = time.perf_counter()
            if m == "pcg":
                r = with_tf32_requested(lambda: refined_pcg_sparse(
                    A, b, M=kw["M"], inner_maxit=EX09_MAXIT, **cert))
            else:
                r = with_tf32_requested(lambda: refined_recycled_solve(
                    A, b, first, M=kw["M"], inner_maxit=EX09_MAXIT, **cert))
            sync()
            solve_ms = 1e3 * (time.perf_counter() - t0)
            tr = sparse_true_relres(A, b, r.x_df32)
            check_certified(f"ex09_certified {m} sample {s}", r, tr, seen)
            its[m].append(int(r.it))
            if r.W is not None:
                ranks[m].append(int(np.linalg.matrix_rank(
                    r.W.double().cpu().numpy())))
                W[m] = r.W
            rows.append(dict(sample=s, method=m, it=int(r.it),
                             refines=r.refines,
                             certified_relres=float(r.res_norm[0]) / bnorm,
                             true_relres=tr, solve_ms=solve_ms))
    mean_pcg = float(np.mean(its["pcg"][1:]))
    mean_eigdef = float(np.mean(its["eigdefpcg"][1:]))
    check(mean_eigdef < mean_pcg,
          f"ex09_certified: eigdefpcg's mean it {mean_eigdef} over samples "
          f"2-{nsmp} is not below pcg's {mean_pcg}")
    emit("ex09_certified", nnode=mesh.nnode, ndom=ndom, n_gamma=n_gamma,
         samples=nsmp, nvec=nvec, spdim=spdim, m0="lorasc1",
         m0_build_ms=m0_ms, its=its, rows=rows,
         rank_W=ranks, rank_limit=0.9 * nvec,
         mean_it_samples_2_on=dict(pcg=mean_pcg, eigdefpcg=mean_eigdef),
         seconds=time.perf_counter() - t_phase, card=card)


def run_precond_apply(card, dev="cuda", nnode=PA_NNODE, ndom=PA_NDOM):
    """Each preconditioner built on `dev` in float32 and applied to one
    seeded r, against the same construction on the CPU in float64 from the
    same float64 inputs."""
    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.fem import schur
    from krylov_spdes_tpu_torch.ops.stencil import build_stencil_op
    from krylov_spdes_tpu_torch.precond import (
        amg_precond, block_jacobi_precond, chebyshev_precond, get_cholesky16,
        get_cholesky32, prepare_ddlr_precond, prepare_lorasc_precond,
        prepare_nn_induced_precond)
    from krylov_spdes_tpu_torch.precond.stencil_amg import stencil_amg_precond
    sync = synchronizer(dev)
    t_phase = time.perf_counter()
    f_src = lambda x, y: -1.0 + 0.0 * x   # noqa: E731
    u_dir = lambda x, y: 0.0 * x          # noqa: E731
    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = fem.mesh_partition(mesh.cells, mesh.points, ndom,
                                  mesh.cell_neighbors, use_native=True)
    part = fem.set_subdomains(mesh.cells, epart, maps, ndom)
    cpu64 = dict(device="cpu", dtype=torch.float64)
    card32 = dict(device=dev, dtype=torch.float32)
    lam, psi = sine_basis(mesh.points)
    xi = np.random.default_rng(0).normal(size=lam.shape[0])
    coeff = np.exp(psi @ (np.sqrt(lam) * xi))        # one realization's field

    def on_card(t):
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: on_card(getattr(t, f.name))
                for f in dataclasses.fields(t) if f.init
                and torch.is_tensor(getattr(t, f.name))})
        return t.to(dev, torch.float32 if t.is_floating_point() else t.dtype)

    # the float64 inputs, on the CPU; the card's are these rounded
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_dir, **cpu64)
    A64, _ = fem.do_isotropic_elliptic_assembly(asm, coeff)
    A32 = on_card(A64)
    m1 = int(round(np.sqrt(mesh.nnode)))
    St64 = build_stencil_op(A64, maps, (m1, m1))
    St32 = on_card(St64)
    plans = {k: fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part,
                                        maps, f_src, u_dir, **kw)
             for k, kw in (("cpu", cpu64), ("card", card32))}
    blocks64 = fem.assemble_dd_values(plans["cpu"], torch.as_tensor(coeff))
    blocks32 = [on_card(b) for b in blocks64]
    S64 = schur.prepare_schur_operator(plans["cpu"], part, *blocks64[:3])
    S32 = schur.prepare_schur_operator(plans["card"], part, *blocks32[:3])
    n_gamma = part.n_gamma
    nvec = min(25, n_gamma // 2 or 1)
    ell = int(ndom + 0.1 * n_gamma)
    H0 = torch.randn(n_gamma, ell, generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64)
    # Chebyshev's λmax(D⁻¹A), given to both builds (their power iterations
    # would start from two generators' draws)
    from scipy.sparse import diags
    from scipy.sparse.linalg import eigsh
    csr = A64.to_scipy()
    dh = diags(1.0 / np.sqrt(csr.diagonal()))
    lmax_est = float(eigsh(dh @ csr @ dh, k=1, which="LA")[0][0])

    builds = {
        "amg": (lambda A, St, S, bl, pl: amg_precond(A), "A"),
        "stencil_amg": (lambda A, St, S, bl, pl: stencil_amg_precond(St),
                        "St"),
        "block_jacobi": (lambda A, St, S, bl, pl: block_jacobi_precond(
            A, ndom), "A"),
        "cholesky32": (lambda A, St, S, bl, pl: get_cholesky32(A), "A"),
        "cholesky16": (lambda A, St, S, bl, pl: get_cholesky16(A), "A"),
        "chebyshev": (lambda A, St, S, bl, pl: chebyshev_precond(
            A, lmax_est=lmax_est), "A"),
        "lorasc_exact": (lambda A, St, S, bl, pl: prepare_lorasc_precond(
            S, part, maps, nvec=nvec, low_rank_correction="exact"), "A"),
        "lorasc_randomized": (lambda A, St, S, bl, pl: prepare_lorasc_precond(
            S, part, maps, nvec=nvec, low_rank_correction="randomized",
            H0=H0), "A"),
        "ddlr": (lambda A, St, S, bl, pl: prepare_ddlr_precond(
            S, part, maps, bl[0], pl.imask, nvec=nvec), "A"),
        "nn_induced": (lambda A, St, S, bl, pl: prepare_nn_induced_precond(
            S, part, maps), "A"),
    }
    rng = np.random.default_rng(1)
    r = {"A": torch.as_tensor(rng.normal(size=maps.n_free)),
         "St": torch.as_tensor(rng.normal(size=mesh.nnode))}
    rows = []
    for name, (make, space) in builds.items():
        t0 = time.perf_counter()
        M64 = make(A64, St64, S64, blocks64, plans["cpu"])
        z64 = M64(r[space])
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        sync()
        t0 = time.perf_counter()
        M32 = make(A32, St32, S32, blocks32, plans["card"])
        sync()
        build_ms = 1e3 * (time.perf_counter() - t0)
        z32 = M32(r[space].to(dev, torch.float32))
        check(z32.device.type == dev and z32.dtype == torch.float32,
              f"precond_apply {name}: z on {z32.device}, {z32.dtype}")
        err = float(torch.linalg.vector_norm(z32.double().cpu() - z64)
                    / torch.linalg.vector_norm(z64))
        tol = PA_TOL.get(name, PA_TOL["float32"])
        rows.append(dict(name=name, rel_diff=err, limit=tol,
                         build_ms=build_ms,
                         apply_ms=host_ms(lambda: M32(
                             r[space].to(dev, torch.float32)))
                         if dev == "cuda" else None,
                         cpu_float64_ms=cpu_ms))
    emit("precond_apply", nnode=mesh.nnode, ndom=ndom, n_gamma=n_gamma,
         nvec=nvec, rows=rows, seconds=time.perf_counter() - t_phase,
         card=card)
    for row in rows:
        check(row["rel_diff"] <= row["limit"],
              f"precond_apply {row['name']}: relative difference "
              f"{row['rel_diff']} to the float64 build above {row['limit']}")


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
    errs, max_abs = check_sweep("kernel B", fc, ps, bp, p, beta)
    bnd, by = bound_ms((ps.K + 4) * RC * 4, 21 * n)
    copies = lambda: (dataclasses.replace(ps, planes=ps.planes.clone()),  # noqa: E731
                      bp.clone(), p.clone(), beta.clone())
    # every device operation of a call is timed (names None): the one launch
    kernels["B"] = dict(
        name="cg_sweep", route="cuda",
        source="krylov_spdes_tpu_torch/csrc/fused_cg.cu",
        replaces="krylov_spdes_tpu/ops/fused_cg.py:207",
        max_abs_err=max_abs, bound_ms=bnd, bound_by=by,
        **timed(cold(fc.cg_sweep, copies), 200, None,
                cold(fc.cg_sweep_plain, copies), 50))
    per_call, ops = device_ops(lambda: fc.cg_sweep(ps, bp, p, beta), 20)
    check(per_call == 1 and all(SWEEP_KERNEL in o for o in ops),
          f"kernel B: {per_call} device operations a call: {ops}")
    warm, warm_call, _ = timings(lambda: fc.cg_sweep(ps, bp, p, beta), 200)
    emit("kernel_b_parent", **PARENT_B)
    emit("kernel_b", rel_err=errs, tolerance=1e-5, card=card,
         launches_per_call=per_call, ms_l2_cold=kernels["B"]["ms"],
         ms_l2_warm=warm, ms_per_call_l2_warm=warm_call,
         bound_share=bnd / kernels["B"]["ms"],
         plan=dataclasses.asdict(fc.sweep_plan_for(ps, bp)),
         **{k: v for k, v in kernels["B"].items() if k not in NAMING})

    # ---- 4. kernels C and D: whole solves ------------------------------------
    tol2 = torch.tensor(RTOL, device="cuda") ** 2 * torch.sum(bp * bp)
    minv = fc._jacobi_minv(ps, fc._unblock_planes(ps), None)
    zero = bp.new_zeros(())
    us_it = {}
    for key, name, kern, plain, args, per_it, line in (
            ("C", "whole_cg", fc.whole_cg, fc.whole_cg_plain, (bp,), 27, 473),
            ("D", "whole_pcg", fc.whole_pcg, fc.whole_pcg_plain, (minv, bp),
             31, 564)):
        errs, _ = over_1_and_8(
            f"kernel {key}", lambda m: kern(ps, *args, m, zero),
            lambda m: plain(ps, *args, m, zero))
        xk, itk, resk = kern(ps, *args, MAXIT, tol2)
        xp, itp, resp = plain(ps, *args, MAXIT, tol2)
        itk, itp = int(itk), int(itp)
        check(float(resk) ** 2 <= float(tol2) and float(resp) ** 2 <= float(tol2),
              f"kernel {key}: a solve missed its tolerance")
        check(it_ok(itk, "cg" if key == "C" else "pcg"),
              f"kernel {key}: it {itk} (plain {itp}) outside the envelope")
        err_x = rel(xk, xp)
        check(err_x <= 1e-3, f"kernel {key}: x rel err {err_x}")
        x2, it2, _ = kern(ps, *args, MAXIT, tol2)
        check(int(it2) == itk and torch.equal(x2, xk),
              f"kernel {key}: a solve does not repeat bit for bit")
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
        us_it[key] = 1e3 * kernels[key]["ms"] / (itk - 1)
        plan_cd = fc.plan_for(ps, bp, key == "D")
        check(plan_cd.grid <= torch.cuda.get_device_properties(0).multi_processor_count,
              f"kernel {key}: more blocks than SMs: {plan_cd}")
        emit(f"kernel_{key.lower()}", it=itk, it_plain=itp, x_rel_err=err_x,
             rel_err=errs, tolerance=OVER_1_AND_8, repeats_bit_for_bit=True,
             us_per_iteration=us_it[key],
             us_per_iteration_events=1e3 * kernels[key]["ms_per_call"] / (itk - 1),
             plan=dataclasses.asdict(plan_cd),
             barriers_per_iteration=CG_BARRIERS, card=card,
             **{k: v for k, v in kernels[key].items() if k not in NAMING})

    # fixed cost of one whole-solve iteration of kernel C (two all-gathers,
    # a few block syncs): 11 against 211 iterations with tol² = 0, never met
    # (in float64, so that the residual recurrence does not underflow), on
    # 64 blocks of one row (64 x 64) and on 132 of 2-3 rows (368 x 368)
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
             plan=dataclasses.asdict(fc.plan_for(ps_s, bp_s, False)),
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
    it_f, sec_f = solves["fused_pcg"][1], solves["fused_pcg"][3]
    check(launches["B"] == it_f - 1,
          f"main_path: {launches['B']} launches of B for fused_pcg's {it_f} "
          "iterations")
    emit("main_path", launches=launches, fused_pcg_it=it_f,
         fused_pcg_ms=1e3 * sec_f,
         fused_pcg_us_per_iteration=1e6 * sec_f / max(it_f - 1, 1))

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

    for key, n_launch in launches.items():
        kernels[key]["launches"] = n_launch
    run_kernel_h(card, St, b_full, ref["cg"], realizations, kernels,
                 us_it["C"])
    del realizations, solves, ref
    run_large(card)
    run_chain_slice(card, mesh, plan, kernels)
    del plan, ps, St, A, asm
    torch.cuda.empty_cache()
    run_dd_slice(card, mesh, kernels)

    # ---- 13. kernel list -------------------------------------------------------
    for key, k in kernels.items():
        check(k["launches"] > 0,
              f"kernel {key} was not launched on its main path")
        check(k["ms"] >= k["bound_ms"],
              f"kernel {key}: {k['ms']} ms is below its bound "
              f"{k['bound_ms']} ms: the bound or the timing is wrong")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[key][k] for k in order}
                                  for key in "ABCDEFGH"]}), flush=True)


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
