"""Schur-DD recycled MCMC chains: the framework's flagship composition.

Port of the one-chip layouts of `krylov_spdes_tpu/dd_chains.py`. The
reference's north-star workload runs MCMC chains of correlated stiffness
systems and solves each sample with a recycled deflated solver over
domain-decomposition operators
(Example09_DefPcgMcmcStochasticEllipticPde_Functions.jl:139-509 composed with
Example07_PcgSchurStochasticEllipticPde.jl:86-424). One chain step:

    RW-Metropolis KL draw  ->  exp(g)  ->  batched DD block refill
    ->  batched interior factorisation  ->  Schur condensation  ->  NN
    preconditioner  ->  recycled eigDef-PCG on the interface system  ->
    new deflation basis W'

every tensor staying on the plan's device. The solver loops are host loops
(one flag read back an iteration), as in chains.py. Two layouts:

- `make_dd_chain_step`          one chain.
- `make_batched_dd_chain_step`  N chains with the chain axis written out as
  a batch dimension and a restart schedule shared across chains
  (solvers/batched.py).

The chain stops on the float32 recurrence residual (`effective_rtol`), as
the JAX chain does; the certified variant (`refined_dd_pcg`) and the
layouts sharded over several devices are not part of this module yet.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .chains import (_draw_batched, chain_state, effective_rtol)
from .fem.dd import DDPartition, assemble_dd_values
from .fem.dd_stencil import DDStencilPlan, condense_dd_stencil
from .fem.schur import (_masked_pinv, _nn_apply, _schur_matvec_assembled,
                        assemble_local_schurs, assembled_schur_operator,
                        get_schur_rhs, prepare_neumann_neumann_schur_precond,
                        prepare_schur_operator)
from .samplers.samplers import SamplerState, _draw_mc, _draw_mcmc
from .solvers.batched import _batched_eigdef_impl
from .solvers.defcg import _eigdef_impl
from .solvers.eigcg import _eigpcg_impl


# ---------------------------------------------------------------------------
# Single-chain layout
# ---------------------------------------------------------------------------

def dd_solve_operands(plan, part: DDPartition, coeff_nodes):
    """Refill + condense one realization: (S, b_schur, b_I). `plan` is a
    DDAssemblyPlan (general routing refill) or a DDStencilPlan (structured-
    mesh refill, fem/dd_stencil.py). A batch of fields (B, nnode) gives
    every block a leading B axis."""
    if isinstance(plan, DDStencilPlan):
        # block-tridiagonal fast path: dense interiors never materialize
        return condense_dd_stencil(plan, coeff_nodes)
    A_II, A_IG, A_GGd, b_I, b_G = assemble_dd_values(plan, coeff_nodes)
    S = prepare_schur_operator(plan, part, A_II, A_IG, A_GGd)
    return S, get_schur_rhs(S, b_I, b_G), b_I


def _dd_system(plan, part, g, M_const=None):
    """The interface system of the field g: the assembled Schur apply A, the
    NN preconditioner M (M_const when given) and b_schur."""
    S, b_s, _ = dd_solve_operands(plan, part, torch.exp(g))
    Sd = assemble_local_schurs(S)
    A = assembled_schur_operator(S, Sd=Sd)
    M = (prepare_neumann_neumann_schur_precond(S, Sd=Sd) if M_const is None
         else M_const)
    return A, M, b_s


def _dd_chain_step_core(plan, part, state, W, M_const, nvec, spdim, maxit,
                        rtol):
    """One unbatched DD chain step: draw -> refill -> condense -> NN ->
    recycled eigDef-PCG on the interface system.

    The CG loop applies the ASSEMBLED local Schur blocks (one batched
    (ndom, nG, nG) product per matvec, reference :761's assembled flavor):
    the condensation interior solves run ONCE per sample instead of once per
    iteration, and the NN preconditioner shares the same Sd blocks."""
    state, cnt = (_draw_mcmc if state.kind != "mc" else _draw_mc)(state)
    A, M, b_s = _dd_system(plan, part, state.g, M_const)
    x, it, res, Wn = _eigdef_impl(A, M, b_s, torch.zeros_like(b_s), W, nvec,
                                  spdim, maxit, rtol, True, True)
    return state, Wn, it, cnt


def seed_dd_chain(plan, part: DDPartition, state: SamplerState, nvec: int,
                  spdim: int, maxit: int = 500, rtol: float | None = None,
                  constant_precond: bool = False):
    """First solve of a chain with eigPCG on the Schur system to harvest the
    initial deflation basis (Example09's s=1 seeding). Returns (W, it, M):
    M is the seed realization's NN preconditioner when ``constant_precond``
    (the reference Example07/09 "constant" arm), else None."""
    rtol = effective_rtol(plan.kflat.dtype, rtol)
    A, M, b_s = _dd_system(plan, part, state.g)
    x, it, res, W = _eigpcg_impl(A, M, b_s, torch.zeros_like(b_s), nvec,
                                 spdim, maxit, rtol)
    return W, it, (M if constant_precond else None)


def make_dd_chain_step(plan, part: DDPartition, nvec: int = 20,
                       spdim: int = 61, maxit: int = 500,
                       rtol: float | None = None, M_const=None):
    """Returns `step(state, W) -> (state, W', iters, proposals)`.

    W must be an (n_gamma, nvec) basis (seed with `seed_dd_chain`).
    M_const=None rebuilds the NN Schur preconditioner from each realization's
    own blocks (Example07's "rebuilt" arm: one batched pinv per sample);
    pass the seed preconditioner for the constant arm."""
    rtol = effective_rtol(plan.kflat.dtype, rtol)

    def step(state: SamplerState, W):
        return _dd_chain_step_core(plan, part, state, W, M_const, nvec,
                                   spdim, maxit, rtol)

    return step


def run_dd_chains(plan, part: DDPartition, states_list, nsmp: int,
                  nvec: int = 20, spdim: int = 61, maxit: int = 500,
                  rtol: float | None = None, constant_precond: bool = False):
    """Host-loop multi-chain runner (example/benchmark surface). Takes a list
    of per-chain SamplerStates; returns (states, iters (nchains, nsmp),
    proposals (nchains, nsmp))."""
    nchains = len(states_list)
    iters = np.zeros((nchains, nsmp), dtype=np.int64)
    props = np.ones((nchains, nsmp), dtype=np.int64)
    out_states = []
    step_rebuild = make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim,
                                      maxit=maxit, rtol=rtol)
    for ic, state in enumerate(states_list):
        W, it0, M = seed_dd_chain(plan, part, state, nvec, spdim, maxit,
                                  rtol, constant_precond=constant_precond)
        iters[ic, 0] = int(it0)
        step = (make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim,
                                   maxit=maxit, rtol=rtol, M_const=M)
                if constant_precond else step_rebuild)
        for s in range(1, nsmp):
            state, W, it, cnt = step(state, W)
            iters[ic, s] = int(it)
            props[ic, s] = int(cnt)
        out_states.append(state)
    return out_states, iters, props


# ---------------------------------------------------------------------------
# Natively-batched multi-chain layout (chains.make_batched_chain_step's DD
# sibling: N chains cost about one chain's launch latency plus N× the vector
# work; the restart schedule stays scalar across the batch)
# ---------------------------------------------------------------------------

def _batched_dd_operands(plan, part, states):
    """Refill + condensation + NN pinv for a batch of realizations, the
    chain axis leading every block. Returns (A, M, b_s): batched callables
    and the (B, n_gamma) right-hand sides."""
    S, b_s, _ = dd_solve_operands(plan, part, torch.exp(states.g))
    Sd = assemble_local_schurs(S)                         # (B, ndom, nG, nG)
    PiSd = _masked_pinv(Sd, S.gmask)
    A = partial(_schur_matvec_assembled, Sd, S.gammad_to_gamma, S.gmask,
                S.gamma_gather)
    M = partial(_nn_apply, PiSd, S.gammad_to_gamma, S.gmask,
                S.gamma_gather, 1.0 / S.gamma_cnt)
    return A, M, b_s


def make_batched_dd_chain_step(plan, part: DDPartition, nvec: int = 20,
                               spdim: int = 61, maxit: int = 500,
                               rtol: float | None = None):
    """step(states, W) -> (states, W', its (B,), proposals (B,)).

    `states` from `chains.prepare_chain_states` (shared basis);
    W (B, n_gamma, nvec). Per chain: Metropolis draw -> DD refill ->
    condensation (batched dense algebra over (B, ndom, ...)) -> batched-NN
    recycled eigDef-PCG with a shared scalar restart schedule."""
    rtol = effective_rtol(plan.kflat.dtype, rtol)

    def step(states: SamplerState, W):
        states, cnt = _draw_batched(states)
        A, M, b_s = _batched_dd_operands(plan, part, states)
        x, its, res, Wn = _batched_eigdef_impl(
            A, None, b_s, torch.zeros_like(b_s), W, nvec, spdim, maxit, rtol,
            Mop=M)
        return states, Wn, its, torch.tensor(cnt, dtype=torch.int32)

    return step


def seed_dd_chains_batched(plan, part: DDPartition, states: SamplerState,
                           nvec: int, spdim: int, maxit: int = 500,
                           rtol: float | None = None):
    """eigPCG first solves on the interface systems (one-time seeding), one
    chain after the other: each chain's eigPCG stops at its own `it`.
    Returns (W (B, n_gamma, nvec), its (B,))."""
    out = [seed_dd_chain(plan, part, chain_state(states, c), nvec, spdim,
                         maxit, rtol) for c in range(len(states.gen))]
    return (torch.stack([W for W, _, _ in out]),
            torch.tensor([it for _, it, _ in out], dtype=torch.int32))
