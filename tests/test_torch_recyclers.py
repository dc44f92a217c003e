"""PyTorch port, the RR/HR × post/TR/LO-TR recycler family
(solvers/recyclers.py) against the JAX package and against the NumPy oracle
of tests/oracle_rrhr.py, float64 on the CPU.

Both packages get the same b and the same W: the JAX eigPCG's basis of the
previous system of tests/test_torch_recycling.py's sequence (~600 nodes).
With the Jacobi preconditioner the two agree to the last digits: equal
`it`, x within 1e-8, the residual history within 1e-6 and the handed-on
bases with principal cosines ≥ 1 − 1e-8. Unpreconditioned, CG on these
systems is chaotic in float64 (ROADMAP §3): the two packages' dot
products sum in another order, and their histories part by up to 50% from
about iteration 20 on, so a solve crosses its tolerance an iteration
earlier or later and the windows that feed the projection differ. There
the solves are held to `it` ± 1, x to 1e-6 (the solve's own tolerance is
1e-7), the first 15 residuals to 1e-7, and each handed-on basis to what
it is for: deflating the next system with either basis takes counts
within 4 (the rule tests/test_rrhr.py holds the JAX package to against
its oracle).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.solvers.eigcg import eigpcg as j_eigpcg
from krylov_spdes_tpu.solvers import recyclers as jrec

from krylov_spdes_tpu_torch.precond.simple import jacobi_precond
from krylov_spdes_tpu_torch.solvers import recyclers as trec

import oracle_rrhr as orc
from test_torch_recycling import NVEC, SPDIM, cosines, make_systems

tdef = importlib.import_module("krylov_spdes_tpu_torch.solvers.defcg")

torch.set_num_threads(1)
DEFLATED = ["rrdefpcg", "hrdefpcg", "trrrdefpcg", "trhrdefpcg",
            "lotrrrdefpcg", "lotrhrdefpcg"]
BOOTSTRAP = ["rrpcg", "hrpcg", "trrrpcg", "trhrpcg", "lotrrrpcg",
             "lotrhrpcg"]


@functools.lru_cache(maxsize=None)
def _systems(nnode=600, n_sys=4, seed=11):
    return make_systems(nnode=nnode, n_sys=n_sys, seed=seed)


def _dinv(A):
    return 1.0 / np.asarray(A.to_scipy().diagonal())


def _preconds(A, At, precond):
    if not precond:
        return None, None
    return (Partial(lambda dd, r: dd * r, jnp.asarray(_dinv(A))),
            jacobi_precond(At))


@functools.lru_cache(maxsize=None)
def _seed_W(precond):
    """The JAX eigPCG's basis on system 0 (as numpy)."""
    A0, A0t, b0 = _systems()[0]
    Mj, _ = _preconds(A0, A0t, precond)
    return np.asarray(j_eigpcg(A0, b0, M=Mj, nvec=NVEC, spdim=SPDIM).W)


def _solve_both(name, A, At, b, precond, W=None):
    Mj, Mt = _preconds(A, At, precond)
    if W is None:
        kj = kt = dict(nvec=NVEC)
    else:
        kj, kt = dict(W=jnp.asarray(W)), dict(W=torch.tensor(np.asarray(W)))
    rj = getattr(jrec, name)(A, b, M=Mj, spdim=SPDIM, **kj)
    rt = getattr(trec, name)(At, torch.tensor(b), M=Mt, spdim=SPDIM, **kt)
    return rj, rt


def _next_counts(Wt, Wj, At, b, precond):
    """Def-PCG counts on the next system from either basis."""
    Mt = jacobi_precond(At) if precond else None
    return [int(tdef.defpcg(At, torch.tensor(b), W=torch.tensor(
        np.asarray(W)), M=Mt).it) for W in (Wt, Wj)]


def _agree(rt, rj, precond, nxt=None, hist_rtol=1e-6):
    it, xj = int(rj.it), np.asarray(rj.x)
    ht, hj = rt.history(), np.asarray(rj.res_norm)[:it]
    assert rt.W.shape == (xj.shape[0], NVEC) and rt.W.dtype == torch.float64
    assert np.all(np.isfinite(rt.W.numpy()))
    assert np.all(rt.res_norm.numpy()[int(rt.it):] == 0)
    if precond:
        assert int(rt.it) == it
        np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-8,
                                   atol=1e-8 * np.abs(xj).max())
        np.testing.assert_allclose(ht, hj, rtol=hist_rtol)
        s = cosines(rt.W.numpy(), np.asarray(rj.W))
        assert s.min() >= 1 - 1e-8, s
    else:
        assert abs(int(rt.it) - it) <= 1, (int(rt.it), it)
        assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-6 * np.linalg.norm(xj)
        np.testing.assert_allclose(ht[:15], hj[:15], rtol=1e-7)
        A2, A2t, b2 = nxt
        it_t, it_j = _next_counts(rt.W.numpy(), rj.W, A2t, b2, False)
        assert abs(it_t - it_j) <= 4, (it_t, it_j)


@pytest.mark.parametrize("precond", [False, True], ids=["none", "jacobi"])
@pytest.mark.parametrize("name", DEFLATED + BOOTSTRAP)
def test_recycler_matches_jax(name, precond):
    """Each of the twelve on system 1, the deflated six from the JAX
    eigPCG's basis of system 0."""
    systems = _systems()
    A1, A1t, b1 = systems[1]
    W = _seed_W(precond) if name in DEFLATED else None
    rj, rt = _solve_both(name, A1, A1t, b1, precond, W)
    _agree(rt, rj, precond, nxt=systems[2])
    assert rt.history()[-1] <= 1e-7 * np.linalg.norm(b1)


@pytest.mark.parametrize("name", DEFLATED)
def test_recycler_chain_matches_jax(name):
    """A chain of three systems, each package handing its own basis on:
    the same counts, solutions and bases at every step (Jacobi). From the
    second step on the two packages start from bases that differ in their
    last digits (cosines 1 − 3e-13 after LO-TR), and the LO-TR solves'
    residual histories then part by up to 5.6e-6 (measured) late in the
    solve, where the merged basis's conditioning amplifies rounding; their
    histories are held to 1e-4 there, everything else as in step one."""
    systems = _systems()
    Wj = Wt = _seed_W(True)
    for step, (A, At, b) in enumerate(systems[1:]):
        Mj, Mt = _preconds(A, At, True)
        rj = getattr(jrec, name)(A, b, W=jnp.asarray(Wj), M=Mj, spdim=SPDIM)
        rt = getattr(trec, name)(At, torch.tensor(b),
                                 W=torch.tensor(np.asarray(Wt)), M=Mt,
                                 spdim=SPDIM)
        _agree(rt, rj, True, hist_rtol=1e-6 if step == 0 else 1e-4)
        Wj, Wt = np.asarray(rj.W), rt.W.numpy()


@pytest.mark.parametrize("name", DEFLATED + ["trrrpcg"])
def test_recycler_matches_oracle(name):
    """tests/test_rrhr.py's oracle parity, for the port: `it` within 2, x to
    1e-4, and the bases deflate the next system to counts within 4."""
    systems = make_systems(n_sys=3, seed=11)
    (A0, A0t, b0), (A1, A1t, b1), (A2, A2t, b2) = systems
    d = _dinv(A0)
    Mt = jacobi_precond(A0t)
    Mo = lambda r: d * r  # noqa: E731
    if name == "trrrpcg":
        r = trec.trrrpcg(A1t, torch.tensor(b1), M=Mt, nvec=NVEC, spdim=SPDIM)
        x_ref, it_ref, _, W2_ref = orc.trrrpcg(A1.to_scipy(), b1,
                                               np.zeros_like(b1), Mo, NVEC,
                                               SPDIM)
    else:
        W = np.asarray(j_eigpcg(A0, b0, M=Partial(lambda dd, r: dd * r,
                                                  jnp.asarray(d)),
                                nvec=NVEC, spdim=SPDIM).W)
        r = getattr(trec, name)(A1t, torch.tensor(b1), W=torch.tensor(W),
                                M=Mt, spdim=SPDIM)
        x_ref, it_ref, _, W2_ref = getattr(orc, name)(
            A1.to_scipy(), b1, np.zeros_like(b1), W, Mo, SPDIM)
    assert abs(int(r.it) - it_ref) <= 2, (int(r.it), it_ref)
    np.testing.assert_allclose(r.x.numpy(), x_ref, rtol=1e-4, atol=1e-7)
    it_t, it_o = _next_counts(r.W.numpy(), W2_ref, A2t, b2, True)
    assert abs(it_t - it_o) <= 4, (it_t, it_o)


def test_recycler_window_rules():
    """spdim must leave room: > nvec, and ≥ 2 nvec + 1 for LO-TR."""
    _, At, b = _systems()[1]
    W = torch.tensor(_seed_W(True))
    with pytest.raises(ValueError, match="spdim > nvec"):
        trec.trrrdefpcg(At, torch.tensor(b), W=W, spdim=NVEC)
    with pytest.raises(ValueError, match="LO-TR"):
        trec.lotrhrdefpcg(At, torch.tensor(b), W=W, spdim=2 * NVEC)
