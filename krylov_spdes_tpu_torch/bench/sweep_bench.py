"""Time kernel B (`ops/fused_cg.py::cg_sweep`, one CG sweep) on one GPU:
against its strip height, and a checkout's `cg_sweep` call with all the
device work it launches.

    python3 krylov_spdes_tpu_torch/bench/sweep_bench.py [--tree DIR]
        [--sizes 500,1000] [--rows 1,2,3,4,6,8]

The operands are bench.py's system (coefficient exp(0.3·N(0,1)), numpy seed
0) on an H x H grid for each size, float32, K = 5 (the symmetric form
build_padded_stencil picks), r = b, p from torch seed 0, β = 0.3. For each
launch plan: the device time a call from torch.profiler, summed over every
device operation the call makes (kernels and memsets), with the operands
cold in the L2 (each call takes the next of enough copies to span 200 MB)
and warm (the same operands every call); the CUDA-event time a call with
the host's overhead; the device operations a call and their names; the
bound (each input read once, each output written once, at 3.35 TB/s).
Each plan's pn and Ap are checked bit-equal to the plain version.

--tree DIR imports the port's package from another checkout (for example
the parent commit unpacked with `git archive`) and times only that tree's
own `cg_sweep`; without it the checkout this file is in is used, and each
strip height of --rows is timed beside the default plan (--rows "" for the
default alone). At size 500 it also times fused_pcg's solve of the bench
system (host clock, the faster of two). One JSON line per case.
"""

import argparse
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

L2_EVICT_BYTES = 200e6
HBM_BYTES_PER_S = 3.35e12


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps):
    """(ms, operations, names): device time and device operations a call,
    over every operation with device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in found) / reps / 1e3,
            sum(e.count for e in found) / reps, sorted(e.key for e in found))


def cold(fn, make_args):
    first = make_args()
    size = sum(a.numel() * a.element_size() for a in first[1:]) + \
        first[0].planes.numel() * first[0].planes.element_size()
    sets = [first] + [make_args() for _ in range(math.ceil(L2_EVICT_BYTES / size))]
    held = [None] * len(sets)
    turn = itertools.cycle(range(len(sets)))

    def call():
        i = next(turn)
        held[i] = fn(*sets[i])
    return call


def bench_system(nnode, fem, fc, stencil):
    mesh = fem.get_mesh(nnode)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                        lambda x, y: -1.0 + 0.0 * x,
                                        lambda x, y: 0.0 * x)
    A, b = fem.do_isotropic_elliptic_assembly(asm, np.exp(
        0.3 * np.random.default_rng(0).normal(size=mesh.nnode)))
    h = int(round(np.sqrt(mesh.nnode)))
    St = stencil.build_stencil_op(A, maps, (h, h))
    ps = fc.build_padded_stencil(St)
    b_full = stencil.to_full_vector(maps, b, mesh.nnode)
    bp = fc.pad_vec(ps, b_full)
    g = torch.Generator(device="cuda").manual_seed(0)
    p = fc.pad_vec(ps, torch.randn(h * h, generator=g, device="cuda"))
    return ps, bp, p, torch.tensor(0.3, device="cuda"), b_full


def solve_ms(fc, ps, b_full):
    """fused_pcg on the bench system (maxit 2000, rtol 1e-6, as chip_smoke
    solves it): its `it` and the host-clock ms of the faster of two solves,
    each ended by a synchronize."""
    best = None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, it, _ = fc.fused_pcg(ps, b_full, maxit=2000, rtol=1e-6)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        best = ms if best is None else min(best, ms)
    return int(it), best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--sizes", default="500,1000")
    ap.add_argument("--rows", default="1,2,3,4,6,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_bench: no CUDA device")
    sys.path.insert(0, args.tree)
    import dataclasses

    from krylov_spdes_tpu_torch import fem
    from krylov_spdes_tpu_torch.ops import fused_cg as fc
    from krylov_spdes_tpu_torch.ops import stencil
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    ours = hasattr(fc, "sweep_plan")
    for size in map(int, args.sizes.split(",")):
        ps, r, p, beta, b_full = bench_system(size * size, fem, fc, stencil)
        if size == 500:
            it, ms = solve_ms(fc, ps, b_full)
            print(json.dumps({"tree": args.tree, "H": ps.H, "solve": "fused_pcg",
                              "it": it, "ms": ms,
                              "us_per_iteration": 1e3 * ms / max(it - 1, 1),
                              "card": card}), flush=True)
        pn0, ap0, _ = fc.cg_sweep_plain(ps, r, p, beta)
        bound = 1e3 * (ps.K + 4) * ps.R * ps.C * 4 / HBM_BYTES_PER_S
        cases = [("default", fc.cg_sweep)]
        if ours:
            for rows in (int(x) for x in args.rows.split(",") if x):
                plan = fc.sweep_plan_for(ps, r, rows=rows)
                cases.append((plan, lambda ps, r, p, beta, plan=plan:
                              fc._sweep(ps, r, p, beta, plan)))
        for plan, fn in cases:
            pn, apv, _ = fn(ps, r, p, beta)
            ok = bool(torch.equal(pn, pn0) and torch.equal(apv, ap0))

            def copies():
                return (dataclasses.replace(ps, planes=ps.planes.clone()),
                        r.clone(), p.clone(), beta.clone())
            ms_cold, ops, names = device_ms(cold(fn, copies), 200)
            ms_warm, _, _ = device_ms(lambda: fn(ps, r, p, beta), 200)
            if plan == "default" and ours:
                plan = fc.sweep_plan_for(ps, r)
            print(json.dumps({
                "tree": args.tree, "H": ps.H, "W": ps.W, "C": ps.C, "K": ps.K,
                "plan": plan if isinstance(plan, str) else dataclasses.asdict(plan),
                "bit_equal": ok, "ms_l2_cold": ms_cold, "ms_l2_warm": ms_warm,
                "ms_per_call_events": events_ms(cold(fn, copies), 200),
                "device_ops_per_call": ops, "device_ops": names,
                "bound_ms": bound, "bound_share_cold": bound / ms_cold,
                "card": card}), flush=True)


if __name__ == "__main__":
    main()
