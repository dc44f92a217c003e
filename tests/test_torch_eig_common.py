"""PyTorch port, the generalized restart machinery of the RR/HR recyclers
(solvers/eig_common.py: `_masked_gen_eigvecs`, `ritz_basis_gen`,
`thick_restart_basis_gen`) against the JAX package on seeded pencils,
float64 on the CPU: a full window, a partial window (active_dim < s, with
garbage outside the active block) and a rank-deficient double basis, the
cases of tests/test_eig_common.py. Held: the same nev, Ritz values within
1e-10 (relative) and the spans of the returned combinations (cosines of the
principal angles ≥ 1 − 1e-9; eigh's vectors differ in sign, and in a
cluster by a rotation, so columns are never compared one by one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.solvers import eig_common as jec

from krylov_spdes_tpu_torch.solvers import eig_common as tec

torch.set_num_threads(1)


def _spd(s, seed, lo=0.5, hi=4.0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.normal(size=(s, s)))[0]
    return Q @ np.diag(rng.uniform(lo, hi, s)) @ Q.T


def _tridiag(s, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 3.0, s) * scale
    e = rng.uniform(0.1, 0.5, s - 1) * scale
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _pencil(case, s=16):
    """(S, T, active_dim) of a test case."""
    if case == "rank_deficient":
        # an identity block makes both least-dominant bases overlap
        S = np.eye(s)
        S[-1, -1] = 5.0
        return S, np.eye(s), s
    S = _spd(s, 5)
    T = np.eye(s) + 0.1 * _tridiag(s, 6, scale=0.5)
    if case == "partial":
        m = 11
        S[m:, m:] = 99.0          # garbage outside the active block
        T[m:, m:] = -7.0
        return S, T, m
    return S, T, s


def _span_cos(a, b):
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("case", ["full", "partial"])
def test_masked_gen_eigvecs_batched_matches_jax(case):
    """Two masks in one batched call, as LO-TR makes it."""
    S, T, m = _pencil(case)
    s, k = S.shape[0], 4
    i = np.arange(s)
    act = np.stack([i < m, i < m - 1])
    Vj = np.asarray(jec._masked_gen_eigvecs(jnp.asarray(S), jnp.asarray(T),
                                            k, jnp.asarray(act)))
    Vt = tec._masked_gen_eigvecs(_t(S), _t(T), k, torch.tensor(act)).numpy()
    assert Vt.shape == Vj.shape == (2, s, k)
    for bi in range(2):
        # supported on the active coordinates only
        assert np.all(Vt[bi][~act[bi]] == 0)
        assert _span_cos(Vt[bi], Vj[bi]).min() > 1 - 1e-9
        # each batch entry equals the unbatched call on its own mask
        one = tec._masked_gen_eigvecs(_t(S), _t(T), k,
                                      torch.tensor(act[bi])).numpy()
        assert _span_cos(one, Vt[bi]).min() > 1 - 1e-12


@pytest.mark.parametrize("case", ["full", "partial"])
def test_ritz_basis_gen_matches_jax(case):
    from scipy.linalg import eigh
    S, T, m = _pencil(case)
    nvec = 4
    cj = np.asarray(jec.ritz_basis_gen(jnp.asarray(S), jnp.asarray(T), nvec,
                                       jnp.int32(m)))
    ct = tec.ritz_basis_gen(_t(S), _t(T), nvec, m).numpy()
    assert ct.shape == cj.shape == (S.shape[0], nvec)
    assert np.all(ct[m:] == 0)
    assert _span_cos(ct, cj).min() > 1 - 1e-9
    # and the dense generalized eigenvectors of the active block
    w, v = eigh(S[:m, :m], T[:m, :m])
    assert _span_cos(ct[:m], v[:, :nvec]).min() > 1 - 1e-9


@pytest.mark.parametrize("case", ["full", "partial", "rank_deficient"])
def test_thick_restart_basis_gen_matches_jax(case):
    S, T, m = _pencil(case)
    nvec = 4 if case != "rank_deficient" else 3
    vj, QZj, nevj = jec.thick_restart_basis_gen(jnp.asarray(S),
                                                jnp.asarray(T), nvec,
                                                jnp.int32(m))
    vt, QZt, nevt = tec.thick_restart_basis_gen(_t(S), _t(T), nvec, m)
    nev = int(nevj)
    assert int(nevt) == nev
    if case == "rank_deficient":
        assert nev < 2 * nvec
    vj, QZj = np.asarray(vj), np.asarray(QZj)
    vt, QZt = vt.numpy(), QZt.numpy()
    np.testing.assert_allclose(vt[:nev], vj[:nev], rtol=1e-10, atol=1e-14)
    assert np.all(vt[nev:] == 0) and np.all(QZt[:, nev:] == 0)
    assert np.all(QZt[m:] == 0)
    assert _span_cos(QZt[:, :nev], QZj[:, :nev]).min() > 1 - 1e-9


@pytest.mark.parametrize("case", ["full", "partial", "rank_deficient"])
def test_thick_restart_basis_gen_rr_metric_is_the_plain_restart(case):
    """With T = I the generalized restart is eigCG's plain thick restart
    (lotrrrdefpcg.jl:172-174): the same nev and Ritz values."""
    S, _, m = _pencil(case)
    nvec = 3
    vg, QZg, nevg = tec.thick_restart_basis_gen(
        _t(S), torch.eye(S.shape[0], dtype=torch.float64), nvec, m)
    vp, QZp, nevp = tec.thick_restart_basis(_t(S), nvec, m)
    assert int(nevg) == int(nevp)
    k = int(nevg)
    np.testing.assert_allclose(vg[:k].numpy(), vp[:k].numpy(), rtol=1e-9,
                               atol=1e-12)
    assert _span_cos(QZg[:, :k].numpy(), QZp[:, :k].numpy()).min() > 1 - 1e-9
