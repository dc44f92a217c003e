"""PyTorch port, the sharded chain steps (chains.make_sharded_chain_step,
dd_chains.make_sharded_dd_chain_step, make_dom_sharded_dd_chain_step)
against the port's single-chain steps. float64 on the CPU.

The sharded steps run on ranks spawned by `parallel.launch` over gloo
(rendezvous in a file under tmp_path, a timeout of their own; the helper
module tests/torch_rank_fns.py imports no JAX), from the same seeds as the
references, which run here. A rank's chains draw from their own generators,
so the sharded and single-chain steps make the same proposals; the second
step shows that every chain's generator state came back whole.

Tolerances, as the JAX package holds its own layouts
(tests/test_sharded.py, tests/test_dd_chains.py): the stencil chain has no
sum across ranks, so `it` is equal, g within 1e-12 and W equal as a
subspace to 1e-9. The dom-sharded DD step sums Γ over ranks in another
order than the single-chain step, so `it` may move by one where a residual
lands on the tolerance, and W′ is held as a projector to a Frobenius gap
of 2 (unrelated subspaces measure ~3.5) and to what it is for: the next
step from either basis costs the same iterations ±1.
"""

import numpy as np
import pytest
import torch

from krylov_spdes_tpu_torch import chains as tch
from krylov_spdes_tpu_torch import dd_chains as tdc
from krylov_spdes_tpu_torch.fem.native import load_native
from krylov_spdes_tpu_torch.parallel import launch

import torch_rank_fns as ranks

torch.set_num_threads(1)
CPU64 = ranks.CPU64
TIMEOUT = 240.0      # seconds a launch may take before its ranks are killed


def _projector_gap(Wa, Wb):
    Qa, _ = np.linalg.qr(np.asarray(Wa))
    Qb, _ = np.linalg.qr(np.asarray(Wb))
    return np.linalg.norm(Qa @ Qa.T - Qb @ Qb.T)


def test_sharded_chain_step_matches_single_chain(tmp_path):
    """(e) 4 chains (seed 9) on 2 ranks, two steps, against make_chain_step
    chain by chain: equal `it` and proposals, g within 1e-12, W as a
    subspace within 1e-9; the second step continues each chain's
    generator, and every rank returns every chain's generator state as
    make_chain_step leaves it."""
    nchains, seed, nvec, spdim = 4, 9, 6, 16
    plan, lam, psi = ranks.stencil_chain_problem()
    states = tch.prepare_chain_states(lam, psi, nchains, base_key=seed,
                                      **CPU64)
    W0, _ = tch.seed_chains_batched(plan, states, nvec=nvec, spdim=spdim,
                                    maxit=500)
    out = launch(ranks.chain_rank, 2,
                 args=(W0.numpy(), nchains, seed, nvec, spdim, 2),
                 backend="gloo", device="cpu", timeout=TIMEOUT,
                 init_method=f"file://{tmp_path}/rdv")
    step = tch.make_chain_step(plan, nvec=nvec, spdim=spdim, maxit=500)
    for c in range(nchains):
        st, W = tch.chain_state(states, c), W0[c]
        for k in (1, 2):
            st, W, it, cnt = step(st, W)
            for o in out:
                assert int(o[f"it{k}"][c]) == int(it), (k, c)
                assert int(o[f"cnt{k}"][c]) == int(cnt), (k, c)
                np.testing.assert_allclose(o[f"g{k}"][c], st.g.numpy(),
                                           rtol=0, atol=1e-12)
                assert _projector_gap(o[f"W{k}"][c], W.numpy()) < 1e-9
        for o in out:
            np.testing.assert_array_equal(o["gen"][c],
                                          st.gen.get_state().numpy())
    for o in out[1:]:
        np.testing.assert_array_equal(o["W2"], out[0]["W2"])


@pytest.fixture(scope="module")
def dd_runs(tmp_path_factory):
    """Both sharded DD layouts on a dom 2 × chain 2 mesh of 4 ranks, on
    tests/test_dd_chains.py's problem and windows (nvec 6, spdim 16, maxit
    400, rtol 1e-9), and the problem for the references."""
    load_native()           # the partitioner, built before the ranks load it
    opts = dict(maxit=400, rtol=1e-9)
    out = launch(ranks.dd_chain_rank, 4, args=(4, 6, 16, opts),
                 backend="gloo", device="cpu", timeout=TIMEOUT,
                 init_method=f"file://{tmp_path_factory.mktemp('dd')}/rdv")
    return ranks.dd_chain_problem(), out, opts


def _check_dd_layout(problem, out, opts, key, prefix, seeded):
    """The layout's two steps against make_dd_chain_step chain by chain:
    `it` ±1, proposals equal, g within 1e-12, W′ within a projector gap of
    2, and the next step from the layout's W′ ±1; every rank returns every
    chain's generator where the single-chain steps leave it."""
    plan, part, lam, psi = problem
    nvec, spdim = 6, 16
    states = tch.prepare_chain_states(lam, psi, 4, base_key=key, **CPU64)
    step1 = tdc.make_dd_chain_step(plan, part, nvec=nvec, spdim=spdim, **opts)
    o = out[0]
    for c in range(4):
        st = tch.chain_state(states, c)
        Wc, itc, _ = tdc.seed_dd_chain(plan, part, st, nvec, spdim, **opts)
        if seeded:
            assert abs(int(itc) - int(o[f"{prefix}_it0"][c])) <= 1
        W = torch.as_tensor(o[f"{prefix}_W0"][c])
        st1, Wn, it, cnt = step1(st, W)
        assert abs(int(it) - int(o[f"{prefix}_it1"][c])) <= 1
        assert int(cnt) == int(o[f"{prefix}_cnt1"][c])
        np.testing.assert_allclose(o[f"{prefix}_g1"][c], st1.g.numpy(),
                                   rtol=0, atol=1e-12)
        assert _projector_gap(o[f"{prefix}_W1"][c], Wn.numpy()) <= 2.0
        # the next step from the layout's own basis
        _, _, it2, cnt2 = step1(st1, torch.as_tensor(o[f"{prefix}_W1"][c]))
        assert abs(int(it2) - int(o[f"{prefix}_it2"][c])) <= 1
        assert int(cnt2) == int(o[f"{prefix}_cnt2"][c])
        np.testing.assert_array_equal(o[f"{prefix}_gen"][c],
                                      st1.gen.get_state().numpy())
    for other in out[1:]:
        for name in ("W1", "W2", "g2", "it2", "gen"):
            np.testing.assert_array_equal(other[f"{prefix}_{name}"],
                                          o[f"{prefix}_{name}"])


def test_dom_sharded_dd_step_matches_single_chain(dd_runs):
    """(f) make_dom_sharded_dd_chain_step (dom 2 × chain 2, base_key 5):
    its eigPCG seed and two steps against the single-chain seed and step;
    every rank returns the same chains."""
    problem, out, opts = dd_runs
    _check_dd_layout(problem, out, opts, 5, "dom", seeded=True)
    assert all(o["psum_calls"] > 0 for o in out)


def test_chain_sharded_dd_step_matches_single_chain(dd_runs):
    """(f) make_sharded_dd_chain_step along the chain axis of the same
    mesh (base_key 9, per-chain eigPCG seeds) against the single-chain
    step."""
    problem, out, opts = dd_runs
    _check_dd_layout(problem, out, opts, 9, "chain", seeded=False)
