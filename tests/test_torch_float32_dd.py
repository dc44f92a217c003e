"""PyTorch port, the Schur-DD step in float32 against the JAX package in
float32, on the CPU: the two float32 questions about the DD step.

1. `_masked_pinv` (fem/schur.py): its rule keeps λ > √eps·max|λ|, with
   float32's √eps = 3.5e-4, which also drops genuine small eigenvalues of
   a tile's local Schur complement where the coefficient's contrast is
   large. On the same float32 blocks (get_mesh(4000), 8 tiles, lognormal
   fields from a numpy seed) the port keeps, tile for tile, what the JAX
   package's `_masked_pinv` keeps (read from the spectrum of its P) and
   what its rule gives on its own eigenvalues; no eigenvalue sits within
   float32 rounding of the threshold there (nearest 4.7% away at σ = 2).
2. The batched DD step's `its`: the JAX package's batched and
   single-chain steps in float32 (a subprocess with x64 off, as on a
   float32 device) from the same states and bases meet within 2, the JAX
   tests' own limit between the layouts; the port's, in float32 from the
   JAX states, draws and bases, meet within 2 as well, and each within 2
   of the JAX count. Where they part by more than 2 on the card, the
   field's float32 solve itself moves by more than 2 under last-bit
   changes of W, in the JAX package too: on such a field from an H100
   run (tests/dd_float32_case.npz), JAX in float32 spans more than 2 over
   W and 4 last-bit copies of W, and the port's counts on the CPU land
   within 2 of that range.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem import schur as jschur

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import chains as tch
from krylov_spdes_tpu_torch import dd_chains as tdc
from krylov_spdes_tpu_torch.bench.bench_chain import sine_basis
from krylov_spdes_tpu_torch.fem import dd_stencil, schur
from krylov_spdes_tpu_torch.samplers.samplers import set_xi
from krylov_spdes_tpu_torch.solvers.defcg import _eigdef_impl
from torch_bench_cases import ROOT

torch.set_num_threads(1)
CPU32 = dict(device="cpu", dtype=torch.float32)
SQRT_EPS32 = float(np.sqrt(np.finfo(np.float32).eps))


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_zero(x, y):
    return 0.0 * x


@pytest.mark.parametrize("sigma", [0.3, 2.0])
def test_masked_pinv_keeps_what_jax_keeps_in_float32(sigma):
    mesh = tfem.get_mesh(4000)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    _, _, plan = tfem.prepare_dd_stencil_assembly(mesh, maps, f_src, u_zero,
                                                  8, **CPU32)
    coeff = np.exp(sigma * np.random.default_rng(1).normal(size=mesh.nnode))
    S = dd_stencil.condense_dd_stencil(plan, torch.tensor(coeff,
                                                          **CPU32))[0]
    Sd = schur.assemble_local_schurs(S)
    assert Sd.dtype == torch.float32
    kept = schur._masked_pinv(Sd, S.gmask, return_kept=True)[1].numpy()
    # the JAX package's pinv of the same blocks: its P has 1/λ (≥
    # 1/max λ) on the kept eigenvectors and rounding (≤ ~√eps/max λ) on
    # the dropped ones
    P_j = np.asarray(jschur._masked_pinv(jnp.asarray(Sd.numpy()),
                                         jnp.asarray(S.gmask.numpy())))
    assert P_j.dtype == np.float32
    lam64 = np.linalg.eigvalsh(Sd.numpy().astype(np.float64))
    cut = 0.1 / np.abs(lam64).max(-1, keepdims=True)
    kept_j = (np.linalg.eigvalsh(P_j.astype(np.float64)) > cut).sum(-1)
    lam_j = np.asarray(jnp.linalg.eigh(jnp.asarray(Sd.numpy()))[0])
    rule_j = (lam_j > SQRT_EPS32 * np.abs(lam_j).max(-1, keepdims=True))
    np.testing.assert_array_equal(kept, kept_j)
    np.testing.assert_array_equal(kept, rule_j.sum(-1))
    # no eigenvalue within float32 rounding of the threshold
    lam_t = torch.linalg.eigvalsh(Sd).double().numpy()
    margin = np.abs(lam_t / (SQRT_EPS32 * np.abs(lam_t).max(-1,
                                                            keepdims=True))
                    - 1)
    assert margin.min() > 1e-3
    # these 8 tiles all touch the boundary (no null mode): float64's rule
    # keeps every interface row; float32's drops the small ones at σ = 2
    n_gd = S.gmask.sum(1).numpy().astype(int)
    keep64 = lam64 > np.sqrt(np.finfo(np.float64).eps) * np.abs(lam64).max(
        -1, keepdims=True)
    np.testing.assert_array_equal(keep64.sum(-1), n_gd)
    assert (kept < n_gd).any() == (sigma == 2.0)


NNODE, NDOM, NVEC, SPDIM, NCHAINS, STEPS, MAXIT = 8000, 8, 8, 24, 3, 2, 500

JAX_RUN = f"""
import dataclasses, json, sys
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, {ROOT!r})
from krylov_spdes_tpu import dd_chains as jdc
from krylov_spdes_tpu.chains import prepare_chain_states
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.dd_stencil import prepare_dd_stencil_assembly
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu_torch.bench.bench_chain import sine_basis
mesh = get_mesh({NNODE}, seed=0)
maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
_, part, plan = prepare_dd_stencil_assembly(
    mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x, {NDOM})
assert plan.kflat.dtype == jnp.float32
lam, psi = sine_basis(mesh.points)
states = prepare_chain_states(lam.astype(np.float32),
                              psi.astype(np.float32), {NCHAINS},
                              base_key=10)
W, _ = jdc.seed_dd_chains_batched(plan, part, states, {NVEC}, {SPDIM},
                                  {MAXIT})
kw = dict(nvec={NVEC}, spdim={SPDIM}, maxit={MAXIT})
bstep = jdc.make_batched_dd_chain_step(plan, part, **kw)
step1 = jdc.make_dd_chain_step(plan, part, **kw)
out = []
for _ in range({STEPS}):
    single = [int(step1(dataclasses.replace(
        states, xi=states.xi[c], g=states.g[c], key=states.key[c]),
        W[c])[2]) for c in range({NCHAINS})]
    rec = dict(xi=np.asarray(states.xi).tolist(),
               g=np.asarray(states.g).tolist(), W=np.asarray(W).tolist())
    states, W, its, cnt = bstep(states, W)
    rec.update(its_batched=np.asarray(its).tolist(), its_single=single,
               xi_next=np.asarray(states.xi).tolist(),
               cnt=np.asarray(cnt).tolist())
    out.append(rec)
print(json.dumps(out))
"""


def _queue_draw(queue):
    """A draw that gives the next (ξ, proposals) of `queue`."""
    def draw(state):
        xi, cnt = queue.pop(0)
        return set_xi(state, np.asarray(xi)), cnt
    return draw


def test_batched_dd_its_meet_single_chain_in_float32(monkeypatch):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0",
               KRYLOV_JAX_CACHE="off",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    run = subprocess.run([sys.executable, "-c", JAX_RUN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    steps = json.loads(run.stdout.splitlines()[-1])

    mesh = tfem.get_mesh(NNODE, seed=0)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    _, part, plan = tfem.prepare_dd_stencil_assembly(mesh, maps, f_src,
                                                     u_zero, NDOM, **CPU32)
    lam, psi = sine_basis(mesh.points)
    t = lambda a: torch.tensor(np.asarray(a), **CPU32)  # noqa: E731
    proto = tch.prepare_chain_states(t(lam), t(psi), NCHAINS, **CPU32)
    kw = dict(nvec=NVEC, spdim=SPDIM, maxit=MAXIT)
    bstep = tdc.make_batched_dd_chain_step(plan, part, **kw)
    step1 = tdc.make_dd_chain_step(plan, part, **kw)
    for k, s in enumerate(steps):
        # JAX's own float32 layouts
        its_b, its_s = s["its_batched"], s["its_single"]
        assert max(abs(a - b) for a, b in zip(its_b, its_s)) <= 2, (k, s)
        states = dataclasses.replace(proto, xi=t(s["xi"]), g=t(s["g"]))
        W = t(s["W"])
        draws = [(x, n) for x, n in zip(s["xi_next"], s["cnt"])]
        monkeypatch.setattr(tch, "_draw_mcmc", _queue_draw(list(draws)))
        its_bt = bstep(states, W)[2].tolist()
        monkeypatch.setattr(tdc, "_draw_mcmc", _queue_draw(list(draws)))
        its_st = [int(step1(tch.chain_state(states, c), W[c])[2])
                  for c in range(NCHAINS)]
        assert max(its_bt + its_st) < MAXIT
        assert max(abs(a - b) for a, b in zip(its_bt, its_st)) <= 2, (
            k, its_bt, its_st)
        assert max(abs(a - b) for a, b in zip(its_bt, its_b)) <= 2, (
            k, its_bt, its_b)


# A field of bench.py's DD protocol (get_mesh(32000), 30 tiles, nvec 30,
# spdim 90) where the card's float32 interface solve moved by more than 2
# under last-bit changes of W: one of the 4 batched chains (base_key 10)
# after a step, its W, and the ξ of 4 copies W·(1 + 2⁻²³ξ), written by
# krylov_spdes_tpu_torch/bench/dd_float32.py on an H100
CASE = os.path.join(ROOT, "tests", "dd_float32_case.npz")

JAX_CASE = f"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, {ROOT!r})
from krylov_spdes_tpu.chains import effective_rtol
from krylov_spdes_tpu.dd_chains import dd_solve_operands
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.dd_stencil import prepare_dd_stencil_assembly
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.schur import (
    assemble_local_schurs, assembled_schur_operator,
    prepare_neumann_neumann_schur_precond)
from krylov_spdes_tpu.solvers.defcg import _eigdef_impl
d = np.load({CASE!r})
nnode, ndom, nvec, spdim, maxit = (int(d[k]) for k in
                                   ("nnode", "ndom", "nvec", "spdim", "maxit"))
mesh = get_mesh(nnode, seed=0)
maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
_, part, plan = prepare_dd_stencil_assembly(
    mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x, ndom)
assert plan.kflat.dtype == jnp.float32

@jax.jit
def solve(g, W):
    S, b, _ = dd_solve_operands(plan, part, jnp.exp(g))
    Sd = assemble_local_schurs(S)
    return _eigdef_impl(assembled_schur_operator(S, Sd=Sd),
                        prepare_neumann_neumann_schur_precond(S, Sd=Sd), b,
                        jnp.zeros_like(b), W, nvec, spdim, maxit,
                        effective_rtol(jnp.float32), True, True)[1]

W = d["W"]
copies = [W] + [W * (np.float32(1) + np.float32(2.0 ** -23)
                     * xi.astype(np.float32)) for xi in d["xi"]]
print(json.dumps([int(solve(jnp.asarray(d["g"]), jnp.asarray(c)))
                  for c in copies]))
"""


def test_dd_it_spread_in_float32_is_the_jax_packages_own():
    """The batched DD step's float32 `its` left the single-chain step's by
    more than 2 on the card (ROADMAP §3): on such a field the JAX package
    in float32, from the same W and the same 4 last-bit copies, spans more
    than 2 itself, so no layout can be held closer there; the port's
    float32 solves on the CPU from the same 5 bases land within 2 of the
    JAX range."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0",
               KRYLOV_JAX_CACHE="off")
    run = subprocess.run([sys.executable, "-c", JAX_CASE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    its_j = json.loads(run.stdout.splitlines()[-1])
    assert max(its_j) - min(its_j) > 2, its_j

    d = np.load(CASE)
    nnode, ndom, nvec, spdim, maxit = (int(d[k]) for k in (
        "nnode", "ndom", "nvec", "spdim", "maxit"))
    mesh = tfem.get_mesh(nnode, seed=0)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    _, part, plan = tfem.prepare_dd_stencil_assembly(mesh, maps, f_src,
                                                     u_zero, ndom, **CPU32)
    A, M, b = tdc._dd_system(plan, part, torch.tensor(d["g"]))
    W = torch.tensor(d["W"])
    its_t = [int(_eigdef_impl(A, M, b, torch.zeros_like(b), Wc, nvec, spdim,
                              maxit, tch.effective_rtol(torch.float32),
                              True, True)[1])
             for Wc in [W] + [W * (1 + 2.0 ** -23 * torch.tensor(
                 xi, dtype=torch.float32)) for xi in d["xi"]]]
    assert max(its_t) < maxit
    assert min(its_j) - 2 <= min(its_t) and max(its_t) <= max(its_j) + 2, (
        its_t, its_j)
