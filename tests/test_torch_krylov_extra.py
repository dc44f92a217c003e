"""PyTorch port, the rest of the Krylov family (solvers/lanczos.py,
block_cg.py, pipelined_cg.py, recycler_state.py) against the JAX package in
float64 on the CPU, on tests/test_torch_recycling.py's systems (~600 nodes)
with the same right-hand sides and start vectors.

With the Jacobi preconditioner the solvers agree in `it` and in x to 1e-8.
Unpreconditioned CG on these systems is chaotic in float64 (ROADMAP §3):
the histories of two summation orders part from about iteration 20 on, so
a solve may cross its tolerance an iteration apart; there `it` is held to
± 1 and x to 1e-6 (the solves' tolerance is 1e-7). Lanczos runs a fixed 30
steps with no read-back; its Ritz values and residual estimates agree to
1e-8 and its Ritz vectors up to sign."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.solvers import block_cg as jblock
from krylov_spdes_tpu.solvers.lanczos import lanczos as j_lanczos
from krylov_spdes_tpu.solvers import pipelined_cg as jpipe
from krylov_spdes_tpu.solvers import recycler_state as jrs

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.precond.simple import jacobi_precond
from krylov_spdes_tpu_torch.solvers import (Recycler, block_pcg, lanczos,
                                            pcg, pipelined_pcg,
                                            prepare_recycler)

from test_torch_recycling import make_systems

torch.set_num_threads(1)
K_RHS = 6


@pytest.fixture(scope="module")
def system():
    (A, At, b), = make_systems(nnode=600, n_sys=1, seed=4)
    return A, At, b


def _preconds(A, At, precond):
    if not precond:
        return None, None
    d = 1.0 / np.asarray(A.to_scipy().diagonal())
    return Partial(lambda dd, r: dd * r, jnp.asarray(d)), jacobi_precond(At)


def _same_solve(rt, rj, precond, x_rtol=1e-8):
    xj = np.asarray(rj.x)
    if precond:
        assert int(rt.it) == int(rj.it)
        assert np.linalg.norm(rt.x.numpy() - xj) <= x_rtol * np.linalg.norm(xj)
    else:
        assert abs(int(rt.it) - int(rj.it)) <= 1, (int(rt.it), int(rj.it))
        assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-6 * np.linalg.norm(xj)


@pytest.mark.parametrize("nvec", [12, 30])
@pytest.mark.parametrize("which", ["MD", "LD"])
def test_lanczos_matches_jax(system, which, nvec):
    """The same start vector (JAX's PRNGKey(0) draw). After 12 steps no
    Ritz value has converged and everything agrees: values, residual
    estimates and vectors up to sign. After 30 (the default) the top values
    have converged and, without reorthogonalization, come back as ghost
    copies whose residual estimates and vectors are rounding noise; the
    values still agree to 1e-8."""
    A, At, _ = system
    v0 = jax.random.uniform(jax.random.PRNGKey(0), (A.n_rows,), jnp.float64)
    vj, Yj, rj = j_lanczos(A, nev=5, nvec=nvec, which=which)
    vt, Yt, rt = lanczos(At, nev=5, nvec=nvec, which=which,
                         v0=torch.tensor(np.asarray(v0)))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8)
    if which == "MD":
        assert np.all(np.diff(vt.numpy()) <= 0)
    else:
        assert np.all(np.diff(vt.numpy()) >= 0)
    if nvec == 12:
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6)
        Yj = np.asarray(Yj)
        sign = np.sign(np.sum(Yt.numpy() * Yj, axis=0))
        np.testing.assert_allclose(Yt.numpy() * sign, Yj, atol=1e-8)


def test_lanczos_start_vector_from_generator(system):
    """Without v0 the start vector is drawn uniform from the generator, in
    A's dtype and on its device."""
    _, At, _ = system
    g = torch.Generator(device="cpu").manual_seed(3)
    v0 = torch.rand(At.n_rows, generator=torch.Generator(
        device="cpu").manual_seed(3), dtype=torch.float64)
    a = lanczos(At, nev=3, nvec=12, generator=g)
    b = lanczos(At, nev=3, nvec=12, v0=v0)
    for x, y in zip(a, b):
        assert x.dtype == torch.float64
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("precond", [False, True], ids=["none", "jacobi"])
def test_block_pcg_matches_jax(system, precond):
    A, At, _ = system
    Mj, Mt = _preconds(A, At, precond)
    B = np.random.default_rng(2).normal(size=(A.n_rows, K_RHS))
    rj = jblock.block_pcg(A, jnp.asarray(B), M=Mj)
    rt = block_pcg(At, torch.tensor(B), M=Mt)
    _same_solve(rt, rj, precond)
    it = min(int(rt.it), int(rj.it))
    np.testing.assert_allclose(rt.res_norm.numpy()[:15],
                               np.asarray(rj.res_norm)[:15], rtol=1e-7)
    assert np.all(rt.res_norm.numpy()[int(rt.it):] == 0)
    assert np.all(rt.res_norm.numpy()[it - 1]
                  <= 1e-7 * np.linalg.norm(B, axis=0))
    # the block shares spectral information: no more iterations than the
    # worst single solve (tests/test_block_cg.py)
    worst = max(int(pcg(At, torch.tensor(B[:, j]), M=Mt).it)
                for j in range(K_RHS))
    assert int(rt.it) <= worst


@pytest.mark.parametrize("precond", [False, True], ids=["none", "jacobi"])
def test_pipelined_pcg_matches_jax(system, precond):
    A, At, b = system
    Mj, Mt = _preconds(A, At, precond)
    rj = jpipe.pipelined_pcg(A, jnp.asarray(b), M=Mj)
    rt = pipelined_pcg(At, torch.tensor(b), M=Mt)
    _same_solve(rt, rj, precond)
    np.testing.assert_allclose(rt.history()[:15],
                               np.asarray(rj.res_norm)[:15], rtol=1e-7)
    assert rt.converged(torch.tensor(b))
    # and pcg's convergence up to rounding (tests/test_block_cg.py)
    rp = pcg(At, torch.tensor(b), M=Mt)
    assert abs(int(rt.it) - int(rp.it)) <= max(3, int(rp.it) // 20)


def test_block_operator_must_take_a_block(system):
    """A preconditioner that only takes vectors is refused, not looped."""
    _, At, _ = system
    dinv = 1.0 / torch.ones(At.n_rows, dtype=torch.float64)
    with pytest.raises((TypeError, RuntimeError)):
        block_pcg(At, torch.ones(At.n_rows, K_RHS, dtype=torch.float64),
                  M=lambda r: torch.cat([dinv * r[:, 0], dinv]))


def test_recycler_state_matches_jax(system):
    """prepare_recycler, Recycler.update's rank guard and its sample count
    against the JAX package, on a full-rank and a rank-deficient basis;
    convert.recycler carries a JAX Recycler over."""
    A, At, _ = system
    n, nvec = A.n_rows, 6
    rj = jrs.prepare_recycler(n, nvec)
    rt = prepare_recycler(n, nvec, device="cpu", dtype=torch.float64)
    assert rt.W.shape == (n, nvec) and rt.nvec == rj.nvec == nvec
    assert not torch.any(rt.W) and rt.healthy and rt.sample_idx == 0
    W = np.random.default_rng(1).normal(size=(n, nvec))
    W_def = W.copy()
    W_def[:, 1:] = W_def[:, :1]                 # rank 1 < 0.9·nvec
    for Wn in (W, W_def):
        uj = rj.update(jnp.asarray(Wn))
        ut = rt.update(torch.tensor(Wn))
        assert ut.healthy == bool(uj.healthy)
        assert ut.sample_idx == uj.sample_idx == 1
        assert ut.update(torch.tensor(Wn)).sample_idx == 2
    assert rt.update(torch.tensor(W)).healthy
    assert not rt.update(torch.tensor(W_def)).healthy
    back = convert.recycler(**convert.numpy_fields(rj.update(jnp.asarray(W))),
                            device="cpu", dtype=torch.float64)
    assert isinstance(back, Recycler) and back.sample_idx == 1
    np.testing.assert_array_equal(back.W.numpy(), W)
