"""PyTorch port, samplers (samplers/samplers.py) against the JAX package.

torch's random stream is not jax.random's, so parity is checked on injected
numbers: the normals and uniforms that the JAX sampler draws from its key
are replayed through the port's draw, which must make the same accept/reject
decisions, count the same proposals and land on the same ξ. The port's own
stream is checked for reproducibility and statistics. float64 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.samplers import samplers as js

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.samplers import samplers as ts

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _basis(m=12, n=80, seed=0):
    rng = np.random.default_rng(seed)
    lam = np.sort(rng.random(m))[::-1].copy() + 0.05
    psi = rng.normal(size=(n, m))
    return lam, psi


def _jax_proposals(key, m_mcmc, dtype=jnp.float64):
    """The (normals, uniform) pairs `_draw_mcmc` of the JAX package draws
    from `key`, in order (samplers.py:98-106), and the key after each."""
    while True:
        key, k1, k2 = jax.random.split(key, 3)
        yield (np.asarray(jax.random.normal(k1, (m_mcmc,), dtype)),
               np.asarray(jax.random.uniform(k2, dtype=dtype)), key)


def _replay(state_j, state_t, hybrid_tail=False):
    """Feed the port's draw the numbers the JAX draw consumes."""
    keys = []

    def pairs():
        for normal, u, key in _jax_proposals(state_j.key, state_j.m_mcmc):
            keys.append(key)
            yield torch.tensor(normal), torch.tensor(u)

    gen = pairs()
    if not hybrid_tail:
        return ts._draw_mcmc(state_t, proposals=gen)
    # the tail is drawn from the key left after the accepted proposal, which
    # is known only once the loop has ended: run the loop, then the tail
    first = ts._draw_mcmc(dataclasses.replace(state_t, kind="mcmc"),
                          proposals=gen)
    _, sub = jax.random.split(keys[-1])
    tail = np.asarray(jax.random.normal(
        sub, (state_j.m - state_j.m_mcmc,), jnp.float64))
    return ts._draw_mcmc(state_t, proposals=pairs(), tail=torch.tensor(tail)), first


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_mcmc_draw_matches_jax_on_injected_numbers(seed):
    lam, psi = _basis()
    sj = js.prepare_mcmc_sampler(lam, psi, key=seed)
    st = convert.sampler_state(**convert.numpy_fields(sj), seed=0, **CPU64)
    np.testing.assert_allclose(st.g.numpy(), np.asarray(sj.g), rtol=0,
                               atol=1e-12)
    total = 0
    for _ in range(6):
        sj_new, cnt_j = js.draw(sj)
        st, cnt_t = _replay(sj, st)
        assert cnt_t == int(cnt_j)          # same accept/reject decisions
        np.testing.assert_allclose(st.xi.numpy(), np.asarray(sj_new.xi),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(st.g.numpy(), np.asarray(sj_new.g),
                                   rtol=0, atol=1e-12)
        sj = sj_new
        total += cnt_t
    assert total > 6                        # some proposals were rejected


def test_hybrid_draw_matches_jax_on_injected_numbers():
    lam, psi = _basis(m=10)
    sj = js.prepare_hybrid_sampler(lam, psi, m_mcmc=4, key=5)
    st = convert.sampler_state(**convert.numpy_fields(sj), seed=0, **CPU64)
    assert st.kind == "hybrid" and st.m_mcmc == 4
    for _ in range(3):
        sj_new, cnt_j = js.draw(sj)
        (st, cnt_t), _ = _replay(sj, st, hybrid_tail=True)
        assert cnt_t == int(cnt_j)
        np.testing.assert_allclose(st.xi.numpy(), np.asarray(sj_new.xi),
                                   rtol=0, atol=1e-13)
        sj = sj_new


def test_metropolis_step_arithmetic():
    """Proposal variance 2.38²σ²/m and the prior-only acceptance ratio."""
    xi = torch.tensor([0.5, -1.0, 0.25], dtype=torch.float64)
    normal = torch.tensor([1.0, 0.0, -2.0], dtype=torch.float64)
    sigma2, m = 2.0, 3
    chi, acc = ts.metropolis_step(xi, normal, torch.tensor(0.0), m, sigma2)
    theta = 2.38 ** 2 * sigma2 / m
    np.testing.assert_allclose(chi.numpy(), xi.numpy() + np.sqrt(theta) * normal.numpy(),
                               rtol=1e-15)
    alpha = np.exp((float(xi @ xi) - float(chi @ chi)) / (2 * sigma2))
    assert alpha < 1 and bool(acc)
    assert bool(ts.metropolis_step(xi, normal, torch.tensor(alpha * 0.999,
                                                            dtype=torch.float64), m, sigma2)[1])
    assert not bool(ts.metropolis_step(xi, normal, torch.tensor(alpha * 1.001,
                                                                dtype=torch.float64), m, sigma2)[1])
    # a move towards the origin is always accepted
    assert bool(ts.metropolis_step(xi, -xi / np.sqrt(theta),
                                   torch.tensor(0.999999, dtype=torch.float64), m, sigma2)[1])


def test_synthesize_and_set_xi_match_jax():
    lam, psi = _basis()
    sj = js.prepare_mc_sampler(lam, psi, key=1)
    st = convert.sampler_state(**convert.numpy_fields(sj), **CPU64)
    xi = np.random.default_rng(4).normal(size=lam.shape[0])
    np.testing.assert_allclose(
        ts.synthesize(st.sqrt_lam, st.psi, torch.tensor(xi)).numpy(),
        np.asarray(js.synthesize(sj.sqrt_lam, sj.psi, jnp.asarray(xi))),
        rtol=0, atol=1e-12)
    s2 = ts.set_xi(st, xi)
    np.testing.assert_allclose(s2.g.numpy(),
                               np.asarray(js.set_xi(sj, xi).g), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(s2.xi.numpy(), xi)


@pytest.mark.parametrize("kind", ["mc", "mcmc", "hybrid"])
def test_own_stream_is_reproducible(kind):
    lam, psi = _basis()
    prep = {"mc": ts.prepare_mc_sampler, "mcmc": ts.prepare_mcmc_sampler,
            "hybrid": lambda *a, **k: ts.prepare_hybrid_sampler(*a, m_mcmc=5, **k)}[kind]

    def run(seed):
        s = prep(lam, psi, key=seed, **CPU64)
        out = [s.xi.numpy().copy()]
        for _ in range(5):
            s, cnt = ts.draw(s)
            assert cnt >= 1
            out.append(s.xi.numpy().copy())
            np.testing.assert_allclose(
                s.g.numpy(), (psi @ (np.sqrt(lam) * out[-1])), rtol=1e-12,
                atol=1e-12)
        return np.stack(out)

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def test_entry_points_default_to_the_card():
    lam, psi = _basis()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ts.prepare_mcmc_sampler(lam, psi, key=0)


def test_own_stream_statistics():
    """Moments of the MC sampler and of the MCMC chain's stationary law
    (N(0, σ²I) with σ² = 1), and the acceptance rate of the random-walk
    proposal with the 2.38²/m scaling: 0.2-0.5 (theory ≈ 0.25-0.35 for
    m = 8; the window is wide for a 4000-draw estimate)."""
    m = 8
    lam, psi = np.ones(m), np.eye(m)
    s = ts.prepare_mc_sampler(lam, psi, key=0, **CPU64)
    xs = []
    for _ in range(2000):
        s, _ = ts.draw(s)
        xs.append(s.xi.numpy())
    xs = np.stack(xs)
    assert abs(xs.mean()) < 0.03 and abs(xs.var() - 1.0) < 0.05

    s = ts.prepare_mcmc_sampler(lam, psi, key=1, **CPU64)
    xs, proposals = [], 0
    for _ in range(4000):
        s, cnt = ts.draw(s)
        proposals += cnt
        xs.append(s.xi.numpy())
    xs = np.stack(xs)[500:]
    rate = 4000 / proposals
    assert 0.2 < rate < 0.5, rate
    # autocorrelated chain: loose windows
    assert abs(xs.mean()) < 0.25 and 0.6 < xs.var() < 1.4, (xs.mean(), xs.var())
