"""MCMC sampling chains with recycled deflated solves: the framework's
flagship workload.

Port of `krylov_spdes_tpu/chains.py`. One chain step = RW-Metropolis draw
-> exp(field) -> dense stencil assembly -> eigDef-PCG with the recycled
deflation basis, every tensor staying on the device of the plan. The solver
loops are host loops (one flag read back per iteration); the chain axis of
the batched step is a batch dimension written out.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import config
from .fem.stencil_assembly import (StencilAssemblyPlan,
                                   make_stencil_operator, stencil_assemble)
from .ops.stencil import stencil_matvec_batched
from .samplers.samplers import (SamplerState, _draw_mc, _draw_mcmc,
                                make_generator, prepare_mcmc_sampler,
                                synthesize)
from .solvers.base import as_precond_op
from .solvers.batched import _batched_eigdef_impl
from .solvers.defcg import _eigdef_impl
from .solvers.eigcg import _eigpcg_impl


def effective_rtol(dtype, rtol=None):
    """The reference's 1e-7 target (float64) is below the float32
    attainable-residual floor at production sizes: float32 chains stall at
    maxit. Parity runs are float64; float32 runs default to 1e-5."""
    if rtol is not None:
        return rtol
    return max(config.rtol, 1e-5) if dtype == torch.float32 else config.rtol


def _precond_for(St, M):
    """M="jacobi" builds the diagonal preconditioner from the freshly
    assembled operator's diagonal."""
    if M == "jacobi":
        dinv = 1.0 / St.diagonal()
        return lambda r: dinv * r
    return as_precond_op(M)


def _default_basis_dtype(plan, basis_dtype):
    """bf16-rounded basis operands by default on float32 plans, as in the
    JAX package; float64 (parity) plans keep the full-precision basis.
    "none" disables."""
    if basis_dtype == "none":
        return None
    if basis_dtype is None:
        return torch.bfloat16 if plan.factors.dtype == torch.float32 else None
    return basis_dtype


def _chain_step_core(plan, state, W, M, nvec, spdim, maxit, rtol,
                     basis_dtype):
    """One unbatched chain step: draw -> assemble -> recycled eigDef-PCG."""
    state, cnt = (_draw_mcmc if state.kind != "mc" else _draw_mc)(state)
    St, b = make_stencil_operator(plan, torch.exp(state.g))
    x0 = torch.zeros_like(b)
    if M == "jacobi":
        # diagonal M -> fused low-traffic eigDef-PCG body
        x, it, res, Wn = _eigdef_impl(St.matvec, as_precond_op(None), b, x0,
                                      W, nvec, spdim, maxit, rtol, True, True,
                                      1.0 / St.diagonal(), basis_dtype)
    else:
        x, it, res, Wn = _eigdef_impl(St.matvec, _precond_for(St, M), b, x0,
                                      W, nvec, spdim, maxit, rtol, True, True)
    return state, Wn, it, cnt


def make_chain_step(plan: StencilAssemblyPlan, M="jacobi", nvec: int = 20,
                    spdim: int = 61, maxit: int = 500,
                    rtol: float | None = None, basis_dtype=None):
    """Returns `step(state, W) -> (state, W', iters, proposals)`. W must be
    a (n_full, nvec) basis (seed with `seed_chain`).
    M: "jacobi" (per-realization diagonal, default), None, or a callable
    (constant across realizations).
    basis_dtype: rounding of the deflation-projection operands (default:
    bf16 on float32 plans, full precision on float64; "none" disables)."""
    rtol = effective_rtol(plan.factors.dtype, rtol)
    basis_dtype = _default_basis_dtype(plan, basis_dtype)

    def step(state: SamplerState, W):
        return _chain_step_core(plan, state, W, M, nvec, spdim, maxit, rtol,
                                basis_dtype)

    return step


def seed_chain(plan: StencilAssemblyPlan, state: SamplerState, M="jacobi",
               nvec: int = 20, spdim: int = 61, maxit: int = 500,
               rtol: float | None = None):
    """First solve of a chain with eigPCG to harvest the initial W
    (Example09's s=1 seeding). Returns (W, it)."""
    rtol = effective_rtol(plan.factors.dtype, rtol)
    St, b = make_stencil_operator(plan, torch.exp(state.g))
    x, it, res, W = _eigpcg_impl(St.matvec, _precond_for(St, M), b,
                                 torch.zeros_like(b), nvec, spdim, maxit, rtol)
    return W, it


def prepare_chain_states(lam, psi, nchains: int, base_key: int = 0,
                         kind: str = "mcmc", device=None, dtype=None):
    """Batched sampler states SHARING one copy of the KL basis: only
    (ξ, g, gen) carry the chain axis (xi (B, m), g (B, nnode), gen a list of
    B generators seeded base_key, base_key + 1, ...)."""
    assert kind == "mcmc"
    proto = prepare_mcmc_sampler(lam, psi, key=base_key, device=device,
                                 dtype=dtype)
    gens = [make_generator(base_key + c, proto.psi.device)
            for c in range(nchains)]
    xi = torch.stack([torch.randn(proto.m, generator=gen,
                                  dtype=proto.psi.dtype,
                                  device=proto.psi.device) for gen in gens])
    g = torch.stack([synthesize(proto.sqrt_lam, proto.psi, v) for v in xi])
    return dataclasses.replace(proto, xi=xi, g=g, gen=gens)


def chain_state(states: SamplerState, c: int) -> SamplerState:
    """Chain c of a batched state, the basis still shared."""
    return dataclasses.replace(states, xi=states.xi[c], g=states.g[c],
                               gen=states.gen[c])


def _stack_states(states: SamplerState, chains) -> SamplerState:
    return dataclasses.replace(
        states, xi=torch.stack([s.xi for s in chains]),
        g=torch.stack([s.g for s in chains]), gen=[s.gen for s in chains])


def run_chains(plan: StencilAssemblyPlan, states, nsmp: int, M="jacobi",
               nvec: int = 20, spdim: int = 61, maxit: int = 500):
    """Runs several chains, one chain after the other. `states` from
    `prepare_chain_states`. Returns (final states, iteration table
    (nchains, nsmp))."""
    step = make_chain_step(plan, M=M, nvec=nvec, spdim=spdim, maxit=maxit)
    finals, table = [], []
    for c in range(len(states.gen)):
        s = chain_state(states, c)
        W, it = seed_chain(plan, s, M=M, nvec=nvec, spdim=spdim, maxit=maxit)
        its = [it]
        for _ in range(nsmp - 1):
            s, W, it, cnt = step(s, W)
            its.append(it)
        finals.append(s)
        table.append(its)
    return _stack_states(states, finals), torch.tensor(table,
                                                       dtype=torch.int32)


def _draw_batched(states: SamplerState):
    draw = _draw_mcmc if states.kind != "mc" else _draw_mc
    out = [draw(chain_state(states, c)) for c in range(len(states.gen))]
    return _stack_states(states, [s for s, _ in out]), [n for _, n in out]


def batched_system(plan, g):
    """The systems of the fields g (B, n) for the batched solver: the
    operator A: (B, n) -> (B, n), the Jacobi diagonal mdiag (B, n) (already
    inverted) and the right-hand sides b (B, n)."""
    out = [stencil_assemble(plan, torch.exp(gc)) for gc in g]
    planes = torch.stack([p for p, _ in out])
    b = torch.stack([b for _, b in out])
    mdiag = 1.0 / (planes[:, 0] + plan.dir_diag[None]).reshape(b.shape[0], -1)
    A = lambda v: stencil_matvec_batched(planes, plan.dir_diag, v)  # noqa: E731
    return A, mdiag, b


def make_batched_chain_step(plan: StencilAssemblyPlan, nvec: int = 20,
                            spdim: int = 61, maxit: int = 500,
                            rtol: float | None = None, basis_dtype=None):
    """Natively-batched multi-chain step: the restart schedule stays scalar
    across chains (see solvers/batched.py), so N chains cost about one
    chain's launch latency plus N× the vector work.

    step(states, W) -> (states, W', its (B,), proposals (B,)).
    `states` from `prepare_chain_states` (shared basis); W (B, n_full, nvec).
    """
    rtol = effective_rtol(plan.factors.dtype, rtol)
    basis_dtype = _default_basis_dtype(plan, basis_dtype)

    def step(states: SamplerState, W):
        states, cnt = _draw_batched(states)
        A, mdiag, b = batched_system(plan, states.g)
        x, its, res, Wn = _batched_eigdef_impl(
            A, mdiag, b, torch.zeros_like(b), W, nvec, spdim, maxit, rtol,
            basis_dtype)
        return states, Wn, its, torch.tensor(cnt, dtype=torch.int32)

    return step


def seed_chains_batched(plan: StencilAssemblyPlan, states: SamplerState,
                        nvec: int = 20, spdim: int = 61, maxit: int = 500,
                        rtol: float | None = None):
    """Seed every chain's deflation basis with an eigPCG first solve
    (one-time cost; Example09's s=1 seeding). Returns (W (B, n, nvec), its)."""
    out = [seed_chain(plan, chain_state(states, c), M="jacobi", nvec=nvec,
                      spdim=spdim, maxit=maxit, rtol=rtol)
           for c in range(len(states.gen))]
    return (torch.stack([W for W, _ in out]),
            torch.tensor([it for _, it in out], dtype=torch.int32))


def run_chains_batched(plan: StencilAssemblyPlan, states, nsmp: int,
                       nvec: int = 20, spdim: int = 61, maxit: int = 500,
                       rtol: float | None = None, basis_dtype=None):
    """Runs several chains through the natively-batched solver
    (solvers/batched.py): eigPCG seeding, then nsmp-1 recycled batched
    steps. Returns (final states, iteration table (nchains, nsmp))."""
    W, it0 = seed_chains_batched(plan, states, nvec=nvec, spdim=spdim,
                                 maxit=maxit, rtol=rtol)
    step = make_batched_chain_step(plan, nvec=nvec, spdim=spdim, maxit=maxit,
                                   rtol=rtol, basis_dtype=basis_dtype)
    its = [it0]
    for _ in range(nsmp - 1):
        states, W, it, cnt = step(states, W)
        its.append(it.cpu())
    return states, torch.stack(its, dim=1)
