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
(one flag read back an iteration), as in chains.py. Four layouts:

- `make_dd_chain_step`          one chain.
- `make_batched_dd_chain_step`  N chains with the chain axis written out as
  a batch dimension and a restart schedule shared across chains
  (solvers/batched.py).
- `make_sharded_dd_chain_step`  the chain axis over the ranks of a mesh
  (P4, Example17_Pll's process-per-chain): each rank runs the sequential
  step on its chains.
- `make_dom_sharded_dd_chain_step`  the full 2D (dom × chain) layout (P3 +
  P5): the batched DD blocks and the element-contribution scatter itself
  are split over the `dom` ranks, and every Γ-level reduction, the DD halo
  exchange the reference only sketched
  (Fem/EllipticPdePllDomainDecomposition.jl:1-19), is a `psum` over them
  (`parallel/sharding.py`). The JAX package's psum twins of the Schur and
  NN applies (`_schur_mv_psum`, `_schur_mv_assembled_psum`, `_nn_psum`)
  are `fem/schur.py`'s applies on an operator that carries the psum.

The sharded layouts take the whole state on every rank and return it whole
on every rank. The chain stops on the float32 recurrence residual
(`effective_rtol`), as the JAX chain does; the certified variant is
`solvers.refined_dd_pcg`.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from .chains import (_draw_batched, chain_state, effective_rtol,
                     gather_chains)
from .fem.dd import (DDAssemblyPlan, DDPartition, OrderedScatter,
                     assemble_dd_values)
from .fem.dd_stencil import DDStencilPlan, condense_dd_stencil
from .fem.schur import (SchurOperator, _masked_pinv, _nn_apply,
                        _schur_matvec_assembled, assemble_local_schurs,
                        assembled_schur_operator, factorize_interiors,
                        gamma_gather_table, get_schur_rhs,
                        prepare_neumann_neumann_schur_precond,
                        prepare_schur_operator)
from .parallel.sharding import Mesh, all_gather_cat, psum
from .samplers.samplers import SamplerState, _draw_mc, _draw_mcmc
from .solvers.base import f32_exact
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


# ---------------------------------------------------------------------------
# Chain-parallel layout (P4): the chain axis over the mesh's ranks
# ---------------------------------------------------------------------------

def make_sharded_dd_chain_step(mesh: Mesh, plan, part: DDPartition,
                               nvec: int = 20, spdim: int = 61,
                               maxit: int = 500, rtol: float | None = None,
                               axis: str = "chain"):
    """Chain parallelism for the DD flagship: each rank along `axis` runs
    the sequential recycled DD step on its block of chains.

    states: `chains.prepare_chain_states` output, the same on every rank,
    with nchains divisible by the axis size; W: (nchains, n_gamma, nvec).
    Returns step(states, W) -> (states, W', its, proposals), whole on every
    rank."""
    rtol = effective_rtol(plan.kflat.dtype, rtol)

    def step(states: SamplerState, W):
        mine = range(len(states.gen))[mesh.block(axis, len(states.gen))]
        local = [_dd_chain_step_core(plan, part, chain_state(states, c), W[c],
                                     None, nvec, spdim, maxit, rtol)
                 for c in mine]
        return gather_chains(mesh, axis, states, local)

    return step


# ---------------------------------------------------------------------------
# Dom-sharded assembly plan (P3): the element-contribution scatter split by
# the subdomain that owns each contribution, padded to a common length a
# shard
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedDDPlan:
    """Per-shard DD assembly and Schur index data, leading axis = n_shards.

    Shard s owns subdomains [s·dpl, (s+1)·dpl). `tgt` holds LOCAL flat
    destinations into the shard's (dpl·nI·nI | dpl·nI·nG | dpl·nG·nG) block
    store; padding entries point one past the end. The JAX package's
    scatter drops them; here every scatter has one spare slot there, which
    is sliced off (`DDShard`). `bG_*` contributions scatter into the GLOBAL
    Γ vector and are summed across shards with a psum; `bG_fixed` is whole
    on every rank and added once after the psum. Index tables are int64."""
    cells: torch.Tensor       # (nel, 3), whole
    kflat: torch.Tensor       # (n_shards, cmax)
    eflat: torch.Tensor       # (n_shards, cmax)
    tgt: torch.Tensor         # (n_shards, cmax) local flat index (pad = total)
    bI_fac: torch.Tensor      # (n_shards, bimax)
    bI_slot: torch.Tensor     # (n_shards, bimax) local d*nI+i (pad = dpl*nI)
    bI_elem: torch.Tensor     # (n_shards, bimax)
    bG_fac: torch.Tensor      # (n_shards, bgmax)
    bG_slot: torch.Tensor     # (n_shards, bgmax) GLOBAL Γ index (pad n_gamma)
    bG_elem: torch.Tensor     # (n_shards, bgmax)
    bI_fixed: torch.Tensor    # (n_shards, dpl, nI)
    bG_fixed: torch.Tensor    # (n_gamma,), whole
    imask: torch.Tensor       # (n_shards, dpl, nI)
    gmask: torch.Tensor       # (n_shards, dpl, nG)
    g2g: torch.Tensor         # (n_shards, dpl, nG) global Γ index (0 pad)
    gamma_cnt: torch.Tensor   # (n_gamma,), whole
    n_shards: int
    dpl: int                  # doms per shard
    nI: int
    nG: int
    n_gamma: int


def _pad_rows(rows, pad_val, dtype):
    """Stack ragged 1-D arrays into (n_shards, max_len) with pad_val."""
    mx = max(1, max(r.shape[0] for r in rows))
    out = np.full((len(rows), mx), pad_val, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def shard_dd_assembly_plan(plan: DDAssemblyPlan, part: DDPartition,
                           n_shards: int) -> ShardedDDPlan:
    """Host-side split of a DDAssemblyPlan into n_shards dom-contiguous
    shards (ndom must divide evenly). The per-contribution owning subdomain
    comes off the plan's (tgt_dom, tgt_loc) pairs; the segment is
    positional (fem/dd.py layout)."""
    ndom, nI, nG = plan.ndom, plan.nI, plan.nG
    assert ndom % n_shards == 0, (ndom, n_shards)
    dpl = ndom // n_shards
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    kflat, eflat = host(plan.kflat), host(plan.eflat)

    n = kflat.shape[0]
    dom, rem = host(plan.tgt_dom), host(plan.tgt_loc)
    seg = np.repeat([0, 1, 2], [plan.n_ii, plan.n_ig, n - plan.n_ii
                                - plan.n_ig])
    shard, dloc = dom // dpl, dom % dpl
    l1 = dpl * nI * nI
    l2 = l1 + dpl * nI * nG
    loc = np.choose(seg, [dloc * nI * nI + rem, l1 + dloc * nI * nG + rem,
                          l2 + dloc * nG * nG + rem])
    total_local = dpl * (nI * nI + nI * nG + nG * nG)
    # the JAX package's index width: a plan it could not hold is refused
    assert total_local < 2 ** 31, \
        (total_local, "per-shard flat layout overflows int32; raise n_shards")

    def split(owner, cols, pads):
        """Each column's entries of each shard, padded."""
        return [_pad_rows([c[owner == s] for s in range(n_shards)], p, dt)
                for c, (p, dt) in zip(cols, pads)]

    kfl, efl, tfl = split(shard, (kflat, eflat, loc),
                          ((0.0, kflat.dtype), (0, np.int64),
                           (total_local, np.int64)))
    # b_I lift contributions: slot = d*nI + i
    bslot = host(plan.bI_slot)
    bdom = bslot // nI
    bI_fac, bI_slot, bI_elem = split(
        bdom // dpl, (host(plan.bI_fac), (bdom % dpl) * nI + bslot % nI,
                      host(plan.bI_elem)),
        ((0.0, kflat.dtype), (dpl * nI, np.int64), (0, np.int64)))
    # b_Γ lift contributions: global Γ slots, split round-robin (summed by
    # the psum anyway: the shard only sets the load balance)
    gslot = host(plan.bG_slot)
    bG_fac, bG_slot, bG_elem = split(
        np.arange(gslot.shape[0]) % n_shards,
        (host(plan.bG_fac), gslot, host(plan.bG_elem)),
        ((0.0, kflat.dtype), (plan.n_gamma, np.int64), (0, np.int64)))

    dev, dt = plan.kflat.device, plan.kflat.dtype
    val = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                    device=dev)
    rs = lambda t: t.reshape(n_shards, dpl, *t.shape[1:])  # noqa: E731
    g2g = np.maximum(part.gammad_to_gamma, 0)
    return ShardedDDPlan(
        cells=plan.cells, kflat=val(kfl), eflat=idx(efl), tgt=idx(tfl),
        bI_fac=val(bI_fac), bI_slot=idx(bI_slot), bI_elem=idx(bI_elem),
        bG_fac=val(bG_fac), bG_slot=idx(bG_slot), bG_elem=idx(bG_elem),
        bI_fixed=rs(plan.bI_fixed), bG_fixed=plan.bG_fixed,
        imask=rs(plan.imask), gmask=rs(plan.gmask), g2g=rs(idx(g2g)),
        gamma_cnt=val(part.gamma_cnt), n_shards=n_shards, dpl=dpl, nI=nI,
        nG=nG, n_gamma=plan.n_gamma)


@dataclasses.dataclass
class DDShard:
    """Shard s of a ShardedDDPlan, on the rank that owns it: its rows of
    the tables with their fixed-order scatters (each one slot longer than
    its target, for the padding), its Γ gather table, and the tables every
    rank holds whole."""
    sp: ShardedDDPlan
    kflat: torch.Tensor
    eflat: torch.Tensor
    bI_fac: torch.Tensor
    bI_elem: torch.Tensor
    bG_fac: torch.Tensor
    bG_elem: torch.Tensor
    bI_fixed: torch.Tensor
    imask: torch.Tensor
    gmask: torch.Tensor
    g2g: torch.Tensor
    blocks: OrderedScatter    # into the (total + 1) flat block store
    bI: OrderedScatter        # into (dpl·nI + 1)
    bG: OrderedScatter        # into (n_gamma + 1)
    gather: torch.Tensor      # gamma_gather_table of the shard's slots

    @classmethod
    def of(cls, sp: ShardedDDPlan, s: int) -> "DDShard":
        total = sp.dpl * (sp.nI * sp.nI + sp.nI * sp.nG + sp.nG * sp.nG)
        return cls(
            sp=sp, kflat=sp.kflat[s], eflat=sp.eflat[s], bI_fac=sp.bI_fac[s],
            bI_elem=sp.bI_elem[s], bG_fac=sp.bG_fac[s], bG_elem=sp.bG_elem[s],
            bI_fixed=sp.bI_fixed[s], imask=sp.imask[s], gmask=sp.gmask[s],
            g2g=sp.g2g[s], blocks=OrderedScatter.of(sp.tgt[s], total + 1),
            bI=OrderedScatter.of(sp.bI_slot[s], sp.dpl * sp.nI + 1),
            bG=OrderedScatter.of(sp.bG_slot[s], sp.n_gamma + 1),
            gather=gamma_gather_table(sp.g2g[s], sp.gmask[s], sp.n_gamma))


# --- local (per-shard) Schur algebra with the psum halo exchange -----------

def _local_assemble(sh: DDShard, coeff_e, psum):
    """Per-shard block refill: local (A_II, A_IG, A_GGd, b_I) and the
    GLOBAL b_G (psum over the shards)."""
    sp = sh.sp
    dpl, nI, nG = sp.dpl, sp.nI, sp.nG
    vals = coeff_e[sh.eflat] * sh.kflat
    o1 = dpl * nI * nI
    o2 = o1 + dpl * nI * nG
    o3 = o2 + dpl * nG * nG
    flat = sh.blocks.sum(vals)
    A_II = flat[:o1].reshape(dpl, nI, nI)
    A_IG = flat[o1:o2].reshape(dpl, nI, nG)
    A_GGd = flat[o2:o3].reshape(dpl, nG, nG)
    b_I = sh.bI_fixed + sh.bI.sum(coeff_e[sh.bI_elem] * sh.bI_fac)[
        :dpl * nI].reshape(dpl, nI)
    bg_part = sh.bG.sum(coeff_e[sh.bG_elem] * sh.bG_fac)[:sp.n_gamma]
    return A_II, A_IG, A_GGd, b_I, sp.bG_fixed + psum(bg_part)


@f32_exact
def _local_condense(sh: DDShard, coeff, psum):
    """coeff -> (A operator, M preconditioner, b_schur) with the dom axis
    local and every Γ reduction a psum: the shard's blocks as a Schur
    operator that carries the psum, through `fem/schur.py`'s condensation,
    assembled apply and NN apply."""
    sp = sh.sp
    coeff_e = torch.mean(coeff[sp.cells], dim=-1)
    A_II, A_IG, A_GGd, b_I, b_G = _local_assemble(sh, coeff_e, psum)
    gm = sh.gmask
    S = SchurOperator(
        A_II_L=factorize_interiors(A_II, sh.imask),
        A_IG=A_IG * sh.imask[:, :, None] * gm[:, None, :],
        A_GGd=A_GGd * gm[:, :, None] * gm[:, None, :],
        gammad_to_gamma=sh.g2g, gmask=gm, gamma_cnt=sp.gamma_cnt,
        n_gamma=sp.n_gamma, gamma_gather=sh.gather, psum=psum)
    b_s = get_schur_rhs(S, b_I, b_G)
    # the local Schur blocks, shared by the assembled operator AND the NN
    # pinv: the interior solves run once here, not per CG iteration
    Sd = assemble_local_schurs(S)
    return (assembled_schur_operator(S, Sd),
            prepare_neumann_neumann_schur_precond(S, Sd), b_s)


def make_dom_sharded_dd_chain_step(mesh: Mesh, plan: DDAssemblyPlan,
                                   part: DDPartition, nvec: int = 20,
                                   spdim: int = 61, maxit: int = 500,
                                   rtol: float | None = None,
                                   dom_axis: str = "dom",
                                   chain_axis: str = "chain"):
    """The full 2D flagship layout: chains over `chain_axis`, the batched DD
    blocks and the assembly scatter over `dom_axis`, the Γ exchange a psum.
    The ranks of a dom group draw the same proposals from the same
    generator state and apply the same summed Γ vectors, so they run one
    solve in step.

    Returns (step, seed) where
      step(states, W) -> (states, W', its, proposals)   [one recycled sample]
      seed(states)    -> (W, its)                        [eigPCG seeding]
    states from `chains.prepare_chain_states`, the same on every rank;
    nchains divisible by the chain axis; ndom by the dom axis. W:
    (nchains, n_gamma, nvec). Results are whole on every rank."""
    rtol = effective_rtol(plan.kflat.dtype, rtol)
    sp = shard_dd_assembly_plan(plan, part, mesh.axis_size(dom_axis))
    sh = DDShard.of(sp, mesh.index(dom_axis))
    psum_dom = partial(psum, mesh=mesh, axis=dom_axis)

    def mine(states):
        return range(len(states.gen))[mesh.block(chain_axis,
                                                 len(states.gen))]

    def step(states: SamplerState, W):
        local = []
        for c in mine(states):
            st = chain_state(states, c)
            st, cnt = (_draw_mcmc if st.kind != "mc" else _draw_mc)(st)
            A, M, b_s = _local_condense(sh, torch.exp(st.g), psum_dom)
            x, it, res, Wn = _eigdef_impl(A, M, b_s, torch.zeros_like(b_s),
                                          W[c], nvec, spdim, maxit, rtol,
                                          True, True)
            local.append((st, Wn, it, cnt))
        return gather_chains(mesh, chain_axis, states, local)

    def seed(states: SamplerState):
        Ws, its = [], []
        for c in mine(states):
            A, M, b_s = _local_condense(sh, torch.exp(states.g[c]), psum_dom)
            x, it, res, W = _eigpcg_impl(A, M, b_s, torch.zeros_like(b_s),
                                         nvec, spdim, maxit, rtol)
            Ws.append(W)
            its.append(int(it))
        its = torch.tensor(its, dtype=torch.int32, device=states.xi.device)
        return (all_gather_cat(torch.stack(Ws), mesh, chain_axis),
                all_gather_cat(its, mesh, chain_axis))

    return step, seed
