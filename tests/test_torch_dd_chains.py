"""PyTorch port, the Schur-DD recycled chain (dd_chains.py, entry.py), the
slice as a whole, against the JAX package. float64 on the CPU.

torch's random stream is not jax.random's, so the parity tests inject the
JAX chain's latent vectors realization by realization (the port's draw is
replaced by `set_xi` of the ξ the JAX chain reached, with its proposal
count), as tests/test_torch_chains.py does; the port's own sampler is driven
in the tests that compare the port's layouts with each other.

Tolerances: with the NN preconditioner the interface solves take 10-25
iterations and stop on a steep residual curve, so `it` is equal or differs
by one where a residual lands on the tolerance (the JAX tests' own window
between their layouts, tests/test_dd_chains.py:135). W′ is compared as a
projector, since eigh and svd differ between LAPACK builds in sign and in
rotations inside clusters, never in span. The seed's basis (eigPCG) agrees
to 1e-3 where `it` is equal (measured 8e-5). A recycled step's does not: the
NN-preconditioned spectrum clusters near 1, so which directions of the
cluster the harvest keeps turns on the last digits (measured gaps up to 0.6
at equal `it`), and the JAX package's own layouts differ as much. Those are
held to the JAX tests' bound (a Frobenius gap of 2, against ~3.5 for
unrelated subspaces) and to what the basis is for: the next step from
either basis costs the same iterations ±1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu import dd_chains as jdc
from krylov_spdes_tpu.chains import prepare_chain_states as j_chain_states
from krylov_spdes_tpu.fem import dd as jdd
from krylov_spdes_tpu.fem import dd_stencil as jds
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.partition import mesh_partition as j_mesh_partition
from krylov_spdes_tpu.samplers import samplers as js

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import chains as tch
from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch import dd_chains as tdc
from krylov_spdes_tpu_torch import entry as tentry
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.samplers import samplers as ts
from krylov_spdes_tpu_torch.solvers import cg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
OPTS = dict(maxit=400, rtol=1e-9)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_zero(x, y):
    return 0.0 * x


def _sine_basis(points, kmax=3, decay=0.3):
    xs, ys = points[:, 0], points[:, 1]
    modes, lams = [], []
    for a in range(1, kmax + 1):
        for b in range(1, kmax + 1):
            modes.append(np.sin(np.pi * a * xs) * np.sin(np.pi * b * ys) * 2)
            lams.append(np.exp(-decay * (a * a + b * b)))
    return np.asarray(lams), np.stack(modes, 1)


def _projector_gap(Wa, Wb):
    Qa, _ = np.linalg.qr(np.asarray(Wa))
    Qb, _ = np.linalg.qr(np.asarray(Wb))
    return np.linalg.norm(Qa @ Qa.T - Qb @ Qb.T)


def _assert_same_step(it_t, it_j, W_t, W_j, seed=False):
    it_t, it_j = int(it_t), int(it_j)
    assert abs(it_t - it_j) <= 1, (it_t, it_j)
    gap = _projector_gap(W_t.numpy(), W_j)
    assert gap < (1e-3 if seed and it_t == it_j else 2.0), (gap, it_t, it_j)


_built = {}


def build(kind):
    """Both packages' plans of one problem: "general" is the partitioner +
    routing plan at 420 nodes / 8 subdomains (use_native passed explicitly
    on both sides), "stencil" the tiled plan at 900 nodes / 6 tiles. The
    port's plan is its own, the partition tables equal by
    tests/test_torch_dd*.py."""
    if kind in _built:
        return _built[kind]
    if kind == "general":
        nnode, ndom = 420, 8
        mesh = get_mesh(nnode, jitter=0.2, seed=3)
        maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
        epart, _ = j_mesh_partition(mesh.cells, mesh.points, ndom,
                                    mesh.cell_neighbors, use_native=True)
        part_j = jdd.set_subdomains(mesh.cells, epart, maps, ndom)
        plan_j = jdd.prepare_dd_assembly(mesh.cells, mesh.points, epart,
                                         part_j, maps, f_src, u_zero)
        mesh_t = tfem.get_mesh(nnode, jitter=0.2, seed=3)
        maps_t = tfem.get_dirichlet_inds(mesh_t.points, mesh_t.point_markers)
        epart_t, _ = tfem.mesh_partition(mesh_t.cells, mesh_t.points, ndom,
                                         mesh_t.cell_neighbors,
                                         use_native=True)
        part_t = tfem.set_subdomains(mesh_t.cells, epart_t, maps_t, ndom)
        plan_t = tfem.prepare_dd_assembly(mesh_t.cells, mesh_t.points,
                                          epart_t, part_t, maps_t, f_src,
                                          u_zero, **CPU64)
    else:
        nnode, ndom = 900, 6
        mesh = get_mesh(nnode, jitter=0.2, seed=0)
        maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
        _, part_j, plan_j = jds.prepare_dd_stencil_assembly(
            mesh, maps, f_src, u_zero, ndom)
        mesh_t = tfem.get_mesh(nnode, jitter=0.2, seed=0)
        maps_t = tfem.get_dirichlet_inds(mesh_t.points, mesh_t.point_markers)
        _, part_t, plan_t = tfem.prepare_dd_stencil_assembly(
            mesh_t, maps_t, f_src, u_zero, ndom, **CPU64)
    lam, psi = _sine_basis(mesh.points)
    _built[kind] = dict(mesh=mesh, maps=maps, part_j=part_j, plan_j=plan_j,
                        mesh_t=mesh_t, maps_t=maps_t, part_t=part_t,
                        plan_t=plan_t, lam=lam, psi=psi)
    return _built[kind]


def _inject(monkeypatch, module, queue):
    """Replace `module._draw_mcmc` by a draw that takes the next (ξ,
    proposals) of `queue`."""
    def draw(state):
        xi, cnt = queue.pop(0)
        return ts.set_xi(state, xi), cnt
    monkeypatch.setattr(module, "_draw_mcmc", draw)


@pytest.mark.parametrize("kind", ["general", "stencil"])
def test_seed_and_steps_match_jax_on_injected_realizations(kind, monkeypatch):
    """seed_dd_chain then three make_dd_chain_step steps on the JAX chain's
    realizations, for both plan kinds."""
    p = build(kind)
    nvec, spdim = 6, 16
    s_j = js.prepare_mcmc_sampler(jnp.asarray(p["lam"]), jnp.asarray(p["psi"]),
                                  key=7)
    W_j, it_j, _ = jdc.seed_dd_chain(p["plan_j"], p["part_j"], s_j, nvec,
                                     spdim, **OPTS)
    step_j = jdc.make_dd_chain_step(p["plan_j"], p["part_j"], nvec=nvec,
                                    spdim=spdim, **OPTS)
    s_t = convert.sampler_state(**convert.numpy_fields(s_j), seed=7, **CPU64)
    W_t, it_t, M = tdc.seed_dd_chain(p["plan_t"], p["part_t"], s_t, nvec,
                                     spdim, **OPTS)
    assert M is None and W_t.shape == (p["part_t"].n_gamma, nvec)
    _assert_same_step(it_t, it_j, W_t, W_j, seed=True)
    step_t = tdc.make_dd_chain_step(p["plan_t"], p["part_t"], nvec=nvec,
                                    spdim=spdim, **OPTS)
    queue = []
    _inject(monkeypatch, tdc, queue)
    its_t = [int(it_t)]
    for _ in range(3):
        # both sides step from the JAX basis carried across, so that a ±1
        # of one step does not compound into the next
        W_in = convert.deflation_basis(np.asarray(W_j), **CPU64)
        s_j, W_j, it_j, cnt_j = step_j(s_j, W_j)
        queue.append((np.array(s_j.xi), int(cnt_j)))
        s_t, W_t, it_t, cnt_t = step_t(s_t, W_in)
        assert cnt_t == int(cnt_j)
        np.testing.assert_allclose(s_t.g.numpy(), np.asarray(s_j.g),
                                   rtol=1e-12, atol=1e-14)
        _assert_same_step(it_t, it_j, W_t, W_j)
        its_t.append(int(it_t))
    assert max(its_t) < OPTS["maxit"]
    # what the basis is for: the next step from the port's own W′ costs
    # what it costs the JAX chain from its own
    s_j, _, it_j, cnt_j = step_j(s_j, W_j)
    queue.append((np.array(s_j.xi), int(cnt_j)))
    _, _, it_t, _ = step_t(s_t, W_t)
    assert abs(int(it_t) - int(it_j)) <= 1, (int(it_t), int(it_j))


@pytest.mark.parametrize("constant", [False, True], ids=["rebuilt", "constant"])
def test_run_dd_chains_matches_jax(constant, monkeypatch):
    """run_dd_chains with the per-sample rebuilt NN preconditioner and with
    the seed's kept constant: the iteration table against a JAX chain run
    step by step (±1 per entry), proposals as injected; recycling pays."""
    from krylov_spdes_tpu.fem.assembly import get_mass_matrix
    from krylov_spdes_tpu.kl.covariance import make_cov
    from krylov_spdes_tpu.kl.single import solve_kl
    p = build("general")
    nvec, spdim, nsmp = 8, 20, 6
    opts = dict(maxit=600, rtol=1e-8)
    # the basis and key of tests/test_dd_chains.py::
    # test_dd_chain_recycling_helps, whose criterion closes this test
    lam, psi = solve_kl(p["mesh"].cells, p["mesh"].points,
                        make_cov("sexp", 1.0, 0.3), 12,
                        get_mass_matrix(p["mesh"].cells, p["mesh"].points),
                        relative=0.98)
    s_j = js.prepare_mcmc_sampler(lam, psi, key=11)
    s_t = convert.sampler_state(**convert.numpy_fields(s_j), seed=11, **CPU64)
    W_j, it_j, M_j = jdc.seed_dd_chain(p["plan_j"], p["part_j"], s_j, nvec,
                                       spdim, constant_precond=constant,
                                       **opts)
    assert (M_j is not None) == constant
    step_j = jdc.make_dd_chain_step(p["plan_j"], p["part_j"], nvec=nvec,
                                    spdim=spdim, M_const=M_j, **opts)
    its_j, queue = [int(it_j)], []
    for _ in range(nsmp - 1):
        s_j, W_j, it_j, cnt_j = step_j(s_j, W_j)
        its_j.append(int(it_j))
        queue.append((np.array(s_j.xi), int(cnt_j)))
    cnts_j = [c for _, c in queue]
    _inject(monkeypatch, tdc, queue)
    out, iters, props = tdc.run_dd_chains(
        p["plan_t"], p["part_t"], [s_t], nsmp, nvec=nvec, spdim=spdim,
        constant_precond=constant, **opts)
    assert iters.shape == (1, nsmp) and props.shape == (1, nsmp)
    assert np.abs(iters[0] - np.asarray(its_j)).max() <= 1, (iters, its_j)
    assert props[0, 1:].tolist() == cnts_j
    np.testing.assert_allclose(out[0].g.numpy(), np.asarray(s_j.g),
                               rtol=1e-12, atol=1e-14)
    if not constant:      # a stale preconditioner costs iterations
        assert iters[0, 3:].mean() < iters[0, 0]


def test_dd_chain_solution_matches_monolithic_solve():
    """tests/test_dd_chains.py:70 in the port: the interface solution of a
    chain step's realization against the dense monolithic solve."""
    p = build("general")
    s = ts.prepare_mcmc_sampler(p["lam"], p["psi"], key=7, **CPU64)
    W, it0, _ = tdc.seed_dd_chain(p["plan_t"], p["part_t"], s, 6, 16,
                                  maxit=400, rtol=1e-10)
    step = tdc.make_dd_chain_step(p["plan_t"], p["part_t"], nvec=6, spdim=16,
                                  maxit=400, rtol=1e-10)
    s2, W2, it, cnt = step(s, W)
    assert 1 < int(it) < 400 and cnt >= 1 and torch.isfinite(W2).all()
    S, b_s, b_I = tdc.dd_solve_operands(p["plan_t"], p["part_t"],
                                        torch.exp(s2.g))
    x_g = cg(S, b_s, maxit=p["part_t"].n_gamma + 10, rtol=1e-12).x
    asm = tfem.prepare_elliptic_assembly(p["mesh_t"].cells, p["mesh_t"].points,
                                         p["maps_t"], f_src, u_zero, **CPU64)
    A, b = tfem.do_isotropic_elliptic_assembly(asm, torch.exp(s2.g))
    u_free = torch.linalg.solve(A.todense(), b).numpy()
    g_idx = p["maps_t"].free_g2l[p["part_t"].gamma_l2g]
    np.testing.assert_allclose(x_g.numpy(), u_free[g_idx], rtol=1e-7,
                               atol=1e-9)
    u_I = tschur.get_subdomain_solutions(S, x_g, b_I)
    u = tschur.merge_subdomain_solutions(p["part_t"], p["maps_t"],
                                         p["mesh_t"].points, u_zero, x_g, u_I)
    np.testing.assert_allclose(u[p["maps_t"].free_l2g], u_free, rtol=1e-7,
                               atol=1e-9)


def _clone_chain(states, c):
    """Chain c of a batched state with a copy of its generator."""
    s = tch.chain_state(states, c)
    gen = torch.Generator(device="cpu")
    gen.set_state(s.gen.get_state())
    return dataclasses.replace(s, gen=gen)


@pytest.mark.parametrize("kind", ["general", "stencil"])
def test_batched_step_matches_sequential(kind):
    """make_batched_dd_chain_step against the single-chain step from the
    same states and bases, for both plan kinds: the same Metropolis
    trajectories, per-chain `its` within ±2 (the JAX tests' own limit:
    the batched solver shares one restart schedule across chains), W′ as a
    projector; and again on a second step from the batched W′."""
    p = build(kind)
    nvec, spdim, B = 6, 16, 3
    states = tch.prepare_chain_states(p["lam"], p["psi"], B, base_key=21,
                                      **CPU64)
    W, its0 = tdc.seed_dd_chains_batched(p["plan_t"], p["part_t"], states,
                                         nvec, spdim, **OPTS)
    assert W.shape == (B, p["part_t"].n_gamma, nvec)
    assert its0.dtype == torch.int32 and (its0 > 1).all()
    step_b = tdc.make_batched_dd_chain_step(p["plan_t"], p["part_t"],
                                            nvec=nvec, spdim=spdim, **OPTS)
    step_1 = tdc.make_dd_chain_step(p["plan_t"], p["part_t"], nvec=nvec,
                                    spdim=spdim, **OPTS)
    for _ in range(2):
        ref = [step_1(_clone_chain(states, c), W[c]) for c in range(B)]
        states, W_b, its, cnts = step_b(states, W)
        assert its.dtype == torch.int32 and (its < OPTS["maxit"]).all()
        for c, (s1, Wn, it, cnt) in enumerate(ref):
            np.testing.assert_allclose(s1.g.numpy(), states.g[c].numpy(),
                                       rtol=1e-12, atol=1e-12)
            assert cnt == int(cnts[c])
            assert abs(int(it) - int(its[c])) <= 2, (c, int(it), its.tolist())
            assert _projector_gap(Wn.numpy(), W_b[c].numpy()) < 2.0
        W = W_b


def test_batched_step_matches_jax_batched_step(monkeypatch):
    """The batched step against the JAX package's batched step on its
    realizations (injected per chain), from the JAX bases: ±2."""
    p = build("general")
    nvec, spdim, B = 6, 16, 3
    st_j = j_chain_states(jnp.asarray(p["lam"]), jnp.asarray(p["psi"]), B,
                          base_key=21)
    W_j, its0_j = jdc.seed_dd_chains_batched(p["plan_j"], p["part_j"], st_j,
                                             nvec, spdim, **OPTS)
    step_j = jdc.make_batched_dd_chain_step(p["plan_j"], p["part_j"],
                                            nvec=nvec, spdim=spdim, **OPTS)
    st_j2, W_j2, its_j, cnts_j = step_j(st_j, W_j)

    states = tch.prepare_chain_states(p["lam"], p["psi"], B, **CPU64)
    states = dataclasses.replace(
        states, xi=torch.tensor(np.asarray(st_j.xi)),
        g=torch.tensor(np.asarray(st_j.g)))
    W_t, its0_t = tdc.seed_dd_chains_batched(p["plan_t"], p["part_t"], states,
                                             nvec, spdim, **OPTS)
    assert np.abs(its0_t.numpy() - np.asarray(its0_j)).max() <= 1
    queue = [(np.asarray(st_j2.xi[c]), int(cnts_j[c])) for c in range(B)]
    _inject(monkeypatch, tch, queue)
    step_t = tdc.make_batched_dd_chain_step(p["plan_t"], p["part_t"],
                                            nvec=nvec, spdim=spdim, **OPTS)
    states2, W_t2, its_t, cnts_t = step_t(
        states, convert.deflation_basis(np.asarray(W_j), **CPU64))
    assert cnts_t.tolist() == np.asarray(cnts_j).tolist()
    np.testing.assert_allclose(states2.g.numpy(), np.asarray(st_j2.g),
                               rtol=1e-12, atol=1e-14)
    assert np.abs(its_t.numpy() - np.asarray(its_j)).max() <= 2, (
        its_t.tolist(), np.asarray(its_j).tolist())
    for c in range(B):
        assert _projector_gap(W_t2[c].numpy(), W_j2[c]) < 2.0


def test_entry_step_runs_and_matches_the_jax_entry(monkeypatch):
    """entry(): the twin of `__graft_entry__.entry()` (320-node jittered
    mesh, 8 subdomains through the C++ partitioner, dense KL with 10 modes,
    nvec 4, spdim 12, maxit 60). Same interface size and KL spectrum; one
    step on the JAX step's realization from the JAX basis: `it` ±1."""
    import __graft_entry__ as graft
    step_j, (state_j, W_j) = graft.entry()
    step_t, (state_t, W_t) = tentry.entry(**CPU64)
    assert W_t.shape == tuple(W_j.shape)
    np.testing.assert_allclose(state_t.sqrt_lam.numpy(),
                               np.asarray(state_j.sqrt_lam), rtol=1e-8)
    # the port's own state and basis
    s3, W3, it3, cnt3 = step_t(state_t, W_t)
    assert 1 < it3 < 60 and cnt3 >= 1 and torch.isfinite(W3).all()
    s_j2, W_j2, it_j, cnt_j = step_j(state_j, W_j)
    queue = [(np.asarray(s_j2.xi), int(cnt_j))]
    _inject(monkeypatch, tdc, queue)
    # the KL modes' signs are the eigensolver's: carry the JAX state across
    s_t = convert.sampler_state(**convert.numpy_fields(state_j), **CPU64)
    s_t2, W_t2, it_t, cnt_t = step_t(
        s_t, convert.deflation_basis(np.asarray(W_j), **CPU64))
    assert cnt_t == int(cnt_j)
    _assert_same_step(it_t, it_j, W_t2, W_j2)


def test_dd_entry_points_want_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        tentry.entry()
    mesh = tfem.get_mesh(400)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    with pytest.raises((RuntimeError, AssertionError)):
        tfem.prepare_dd_stencil_assembly(mesh, maps, f_src, u_zero, 4)
