"""PyTorch port, the recycled MCMC chain (chains.py), the slice as a whole,
against the JAX package. float64 on the CPU.

torch's random stream is not jax.random's, so the parity test injects the
JAX chain's latent vectors realization by realization (the port's draw is
replaced by `set_xi` of the ξ the JAX chain reached); the port's own sampler
is driven in the tests that only ask the iterations to drop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu import chains as jch
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.stencil_assembly import prepare_stencil_assembly
from krylov_spdes_tpu.samplers import samplers as js

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import chains as tch
from krylov_spdes_tpu_torch import convert, kl
from krylov_spdes_tpu_torch.samplers import samplers as ts

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_zero(x, y):
    return 0.0 * x


def _sine_basis(points, kmax=3, decay=0.3):
    """The spectral stand-in for a KL basis that tests/test_batched.py uses:
    kmax² sine modes with λ = exp(−decay·(a² + b²))."""
    xs, ys = points[:, 0], points[:, 1]
    modes, lams = [], []
    for a in range(1, kmax + 1):
        for b in range(1, kmax + 1):
            modes.append(np.sin(np.pi * a * xs) * np.sin(np.pi * b * ys) * 2)
            lams.append(np.exp(-decay * (a * a + b * b)))
    return np.asarray(lams), np.stack(modes, 1)


def _plans(nn, seed=0):
    mesh = get_mesh(nn, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    plan_j = prepare_stencil_assembly(mesh, maps, f_src, u_zero)
    mesh_t = tfem.get_mesh(nn, seed=seed)
    maps_t = tfem.get_dirichlet_inds(mesh_t.points, mesh_t.point_markers)
    plan_t = tfem.prepare_stencil_assembly(mesh_t, maps_t, f_src, u_zero,
                                           **CPU64)
    return mesh, plan_j, mesh_t, plan_t


def _projector_gap(Wa, Wb):
    Qa, _ = np.linalg.qr(np.asarray(Wa))
    Qb, _ = np.linalg.qr(np.asarray(Wb))
    return np.max(np.abs(Qa @ Qa.T - Qb @ Qb.T))


def test_effective_rtol():
    assert tch.effective_rtol(torch.float64) == 1e-7
    assert tch.effective_rtol(torch.float32) == 1e-5
    assert tch.effective_rtol(torch.float32, 1e-8) == 1e-8


@pytest.mark.parametrize("M,nn", [("jacobi", 900), (None, 400)])
def test_chain_matches_jax_on_injected_realizations(M, nn, monkeypatch):
    """seed_chain then three recycled steps on the realizations of the JAX
    chain: `it` equal at every step, proposals counted as injected, and the
    harvested W′ the same subspace (projector gap 1e-6: the two packages'
    eigh/svd differ in sign and rotation, never in span). M="jacobi" runs
    the fused diagonal body, M=None the generic one.

    Unpreconditioned CG on these systems is chaotic in float64: changing b
    in its last bit moves the port's own residual history by 30% from
    iteration 30 on (the Dirichlet rows' unit diagonal beside O(1e-3..1)
    stiffness rows; Jacobi removes it). So the M=None case is held to the
    window tests/test_chains.py gives the JAX package's own two paths (`it`
    within 3) and its bases, harvested from solves that stop at other
    iterations, to a projector gap of 1e-2 (measured 4e-4)."""
    nvec, spdim, maxit = 8, 20, 900
    slack, gap = (0, 1e-6) if M == "jacobi" else (3, 1e-2)
    mesh, plan_j, _, plan_t = _plans(nn)
    lam, psi = _sine_basis(mesh.points)

    s_j = js.prepare_mcmc_sampler(jnp.asarray(lam), jnp.asarray(psi), key=11)
    W_j, it_j = jch.seed_chain(plan_j, s_j, M=M, nvec=nvec, spdim=spdim,
                               maxit=maxit)
    step_j = jch.make_chain_step(plan_j, M=M, nvec=nvec, spdim=spdim,
                                 maxit=maxit)
    s_t = convert.sampler_state(**convert.numpy_fields(s_j), seed=11, **CPU64)
    np.testing.assert_allclose(s_t.g.numpy(), np.asarray(s_j.g), rtol=1e-13)
    W_t, it_t = tch.seed_chain(plan_t, s_t, M=M, nvec=nvec, spdim=spdim,
                               maxit=maxit)
    assert abs(int(it_t) - int(it_j)) <= slack, (int(it_t), int(it_j))
    assert _projector_gap(W_t.numpy(), W_j) < gap
    step_t = tch.make_chain_step(plan_t, M=M, nvec=nvec, spdim=spdim,
                                 maxit=maxit)

    injected = {}
    monkeypatch.setattr(
        tch, "_draw_mcmc",
        lambda state: (ts.set_xi(state, injected["xi"]), injected["cnt"]))
    its_j, its_t = [int(it_j)], [int(it_t)]
    for _ in range(3):
        s_j, W_j, it_j, cnt_j = step_j(s_j, W_j)
        injected.update(xi=np.array(s_j.xi), cnt=int(cnt_j))
        s_t, W_t, it_t, cnt_t = step_t(s_t, W_t)
        assert cnt_t == int(cnt_j)
        np.testing.assert_allclose(s_t.g.numpy(), np.asarray(s_j.g),
                                   rtol=1e-12, atol=1e-14)
        its_j.append(int(it_j))
        its_t.append(int(it_t))
        assert _projector_gap(W_t.numpy(), W_j) < gap
    assert max(abs(a - b) for a, b in zip(its_t, its_j)) <= slack, (its_t,
                                                                   its_j)
    assert max(its_t[1:]) < its_t[0]          # recycling pays on both sides


def test_chain_recycling_reduces_iterations():
    """tests/test_chains.py's headline through the port's own KL front end
    and sampler: solve_kl → prepare_chain_states → run_chains."""
    _, _, mesh_t, plan_t = _plans(900)
    cov = kl.make_cov("sexp", 1.0, 0.3)
    Mm = tfem.get_mass_matrix(mesh_t.cells, mesh_t.points, **CPU64)
    lam, psi = kl.solve_kl(mesh_t.cells, mesh_t.points, cov, 15, Mm,
                           relative=0.99, method="dense")
    states = tch.prepare_chain_states(lam, psi, 3, **CPU64)
    assert states.psi.ndim == 2               # one shared copy of the basis
    assert states.xi.shape == (3, lam.shape[0])
    states, its = tch.run_chains(plan_t, states, nsmp=4, nvec=10, spdim=26,
                                 maxit=1000)
    its = its.numpy()
    assert its.shape == (3, 4)
    assert (its < 1000).all(), its
    assert (its[:, 1:].mean(axis=1) < its[:, 0]).all(), its
    assert not np.allclose(states.xi[0].numpy(), states.xi[1].numpy())


def test_chain_states_reproducible_from_the_seed():
    mesh, _, _, _ = _plans(400, seed=4)
    lam, psi = _sine_basis(mesh.points)
    a = tch.prepare_chain_states(lam, psi, 3, base_key=5, **CPU64)
    b = tch.prepare_chain_states(lam, psi, 3, base_key=5, **CPU64)
    c = tch.prepare_chain_states(lam, psi, 3, base_key=6, **CPU64)
    np.testing.assert_array_equal(a.xi.numpy(), b.xi.numpy())
    np.testing.assert_array_equal(a.g.numpy(), b.g.numpy())
    # chain c of base_key 5 is chain c − 1 of base_key 6: one seed a chain
    np.testing.assert_array_equal(a.xi[1:].numpy(), c.xi[:2].numpy())
    s1 = tch.chain_state(a, 1)
    assert s1.xi.shape == (lam.shape[0],) and s1.psi is a.psi


def test_batched_chain_step_iterations_drop_and_match_single_chains():
    """make_batched_chain_step (tests/test_batched.py:101-129): iterations
    drop along the chain, and each chain's count equals the single-chain
    step's on the same realization and basis (float64: the batched solver
    is the same arithmetic with a chain axis)."""
    B, nvec, spdim, maxit = 2, 8, 24, 2000
    mesh, _, _, plan_t = _plans(1600)
    lam, psi = _sine_basis(mesh.points)
    states = tch.prepare_chain_states(lam, psi, B, **CPU64)
    W, it0 = tch.seed_chains_batched(plan_t, states, nvec=nvec, spdim=spdim,
                                     maxit=maxit)
    assert W.shape == (B, mesh.nnode, nvec) and it0.dtype == torch.int32
    step = tch.make_batched_chain_step(plan_t, nvec=nvec, spdim=spdim,
                                       maxit=maxit)
    single = tch.make_chain_step(plan_t, nvec=nvec, spdim=spdim, maxit=maxit)
    its = [it0.numpy()]
    for _ in range(3):
        # the single chains first, on clones of the generators' states
        ref = []
        for c in range(B):
            s = tch.chain_state(states, c)
            gen = torch.Generator(device="cpu")
            gen.set_state(s.gen.get_state())
            s = ts.SamplerState(**{**vars(s), "gen": gen})
            _, _, it_c, cnt_c = single(s, W[c])
            ref.append((int(it_c), cnt_c))
        states, W, it, cnt = step(states, W)
        assert it.tolist() == [r[0] for r in ref]
        assert cnt.tolist() == [r[1] for r in ref]
        its.append(it.numpy())
    its = np.stack(its)
    assert np.all(its[-1] < its[0]), its


def test_run_chains_batched_table():
    mesh, _, _, plan_t = _plans(900)
    lam, psi = _sine_basis(mesh.points)
    states = tch.prepare_chain_states(lam, psi, 2, **CPU64)
    states, its = tch.run_chains_batched(plan_t, states, 3, nvec=4, spdim=12,
                                         maxit=900)
    assert its.shape == (2, 3)
    assert (its < 900).all() and (its[:, 1:] < its[:, :1]).all(), its


def test_chain_entry_points_want_the_card_by_default():
    """Called without a device on a host without a card, the entry points
    raise; they do not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    mesh, _, _, _ = _plans(400, seed=4)
    lam, psi = _sine_basis(mesh.points)
    with pytest.raises((RuntimeError, AssertionError)):
        tch.prepare_chain_states(lam, psi, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        ts.prepare_mcmc_sampler(lam, psi)
