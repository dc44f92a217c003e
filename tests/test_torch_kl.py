"""PyTorch port, the KL front end (kl/) against the JAX package: covariance
models, the mass matrix, the Galerkin covariance operator, the dense
generalized eigenproblem with its truncation, LOBPCG on the dense operator
and on the row-chunked matrix-free apply (kl/lobpcg.py), the resolution of
method="auto", and field synthesis. float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import get_mass_matrix as j_mass
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.kl import covariance as jcov
from krylov_spdes_tpu.kl import helper as jhelp
from krylov_spdes_tpu.kl import single as jsingle
from krylov_spdes_tpu.kl import synthesis as jsyn

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import kl

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("model", ["sexp", "exp"])
def test_cov_matrix_matches_jax(model):
    rng = np.random.default_rng(0)
    p1, p2 = rng.random((40, 2)), rng.random((30, 2))
    Cj = jcov.cov_matrix(jcov.make_cov(model, 1.3, 0.25), jnp.asarray(p1),
                         jnp.asarray(p2))
    Ct = kl.cov_matrix(kl.make_cov(model, 1.3, 0.25), _t(p1), _t(p2))
    assert Ct.shape == (40, 30)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-13,
                               atol=1e-300)
    with pytest.raises(ValueError):
        kl.make_cov("matern")


def test_mass_matrix_and_covariance_operator_match_jax():
    mesh = get_mesh(80, jitter=0.2, seed=0)
    Mj = j_mass(mesh.cells, mesh.points)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    np.testing.assert_allclose(Mt.todense().numpy(), np.asarray(Mj.todense()),
                               rtol=1e-13, atol=1e-18)
    Cj = jsingle.mass_covariance_operator(Mj, mesh.points,
                                          jcov.make_cov("sexp", 1.0, 0.3))
    Ct = kl.mass_covariance_operator(Mt, mesh.points,
                                     kl.make_cov("sexp", 1.0, 0.3))
    # sums of ~7 products a row, in another order: 1e-12 relative
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-12,
                               atol=1e-18)
    np.testing.assert_allclose(Ct.numpy(), Ct.numpy().T, rtol=1e-12,
                               atol=1e-18)


@pytest.mark.parametrize("nn,L,nev,relative", [(400, 0.5, 30, 0.99),
                                               (300, 0.3, 20, 0.9)])
def test_solve_kl_dense_matches_jax(nn, L, nev, relative):
    """Same truncation (number of modes kept), eigenvalues to 1e-9 relative,
    modes as M-orthonormal subspaces: eigh's vectors differ in sign and,
    inside a cluster, by a rotation, so the M-projectors ΨΨᵀM of the kept
    modes are compared (1e-6; the cut never falls inside a cluster here:
    the test asserts a relative gap of 1e-3 at the cut)."""
    mesh = get_mesh(nn, jitter=0.15, seed=1)
    Mj = j_mass(mesh.cells, mesh.points)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    lam_j, psi_j = jsingle.solve_kl(mesh.cells, mesh.points,
                                    jcov.make_cov("sexp", 1.0, L), nev, Mj,
                                    relative=relative, method="dense")
    lam_t, psi_t = kl.solve_kl(mesh.cells, mesh.points,
                               kl.make_cov("sexp", 1.0, L), nev, Mt,
                               relative=relative, method="dense")
    lam_j, psi_j = np.asarray(lam_j), np.asarray(psi_j)
    assert isinstance(lam_t, np.ndarray) and isinstance(psi_t, np.ndarray)
    assert lam_t.shape == lam_j.shape and psi_t.shape == psi_j.shape
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-9)
    assert np.all(np.diff(lam_t) <= 0) and np.all(lam_t > 0)
    Md = Mt.todense().numpy()
    np.testing.assert_allclose(psi_t.T @ Md @ psi_t, np.eye(lam_t.shape[0]),
                               atol=1e-8)
    # the cut is not inside a cluster: next eigenvalue well below the last
    full_j, _ = jsingle.solve_kl(mesh.cells, mesh.points,
                                 jcov.make_cov("sexp", 1.0, L), nev, Mj,
                                 relative=1.0, method="dense")
    full_j = np.asarray(full_j)
    if full_j.shape[0] > lam_j.shape[0]:
        assert full_j[lam_j.shape[0]] < (1 - 1e-3) * lam_j[-1]
    Pj, Pt = psi_j @ psi_j.T @ Md, psi_t @ psi_t.T @ Md
    assert np.max(np.abs(Pj - Pt)) < 1e-6


def _lobpcg_x0(n, k):
    """The JAX package's LOBPCG start block (PRNGKey(0)), handed over."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, k),
                                        jnp.float64))


def _m_cosines(Pa, Pb, Md):
    def whiten(P):
        L = np.linalg.cholesky(P.T @ Md @ P)
        return np.linalg.solve(L, P.T).T
    return np.linalg.svd(whiten(Pa).T @ Md @ whiten(Pb), compute_uv=False)


@pytest.mark.parametrize("method,nn", [("lobpcg", 1800), ("chunked", 700)])
def test_solve_kl_lobpcg_and_chunked_match_jax(method, nn):
    """LOBPCG on the dense operator, and on the row-chunked matrix-free
    apply, from the JAX package's own start block: the same kept count,
    eigenvalues to 1e-10 and the M-span of the kept modes (cosines ≥
    1 − 1e-8; tests/test_kl.py's test_lobpcg_matches_dense and
    test_chunked_matches_lobpcg at their covariance)."""
    mesh = get_mesh(nn, seed=5)
    Mj = j_mass(mesh.cells, mesh.points)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    lam_j, psi_j = jsingle.solve_kl(mesh.cells, mesh.points,
                                    jcov.make_cov("sexp", 1.0, 0.3), 25, Mj,
                                    relative=0.999, method=method)
    lam_t, psi_t = kl.solve_kl(mesh.cells, mesh.points,
                               kl.make_cov("sexp", 1.0, 0.3), 25, Mt,
                               relative=0.999, method=method,
                               X0=_lobpcg_x0(mesh.nnode, 25 + 8))
    lam_j, psi_j = np.asarray(lam_j), np.asarray(psi_j)
    assert isinstance(lam_t, np.ndarray) and lam_t.shape == lam_j.shape
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-10)
    Md = Mt.todense().numpy()
    assert _m_cosines(psi_t, psi_j, Md).min() > 1 - 1e-8
    np.testing.assert_allclose(psi_t.T @ Md @ psi_t, np.eye(len(lam_t)),
                               atol=1e-8)


def test_chunked_cov_apply_matches_jax():
    """Ĉ Y in row chunks that do not divide n, on a block and on a vector,
    against the JAX package's scan and against the dense Ĉ."""
    rng = np.random.default_rng(4)
    pts = rng.random((300, 2))
    Y = rng.normal(size=(300, 5))
    cj = jsingle.make_chunked_cov_apply(jcov.make_cov("exp", 1.2, 0.3), pts,
                                        jnp.float64, chunk=64)
    ct = kl.single.make_chunked_cov_apply(kl.make_cov("exp", 1.2, 0.3), pts,
                                          torch.float64, chunk=64,
                                          device="cpu")
    dense = kl.cov_matrix(kl.make_cov("exp", 1.2, 0.3), _t(pts), _t(pts))
    for y in (Y, Y[:, 0]):
        out = ct(_t(y))
        assert out.shape == y.shape
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(cj(jnp.asarray(y))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out.numpy(), (dense @ _t(y)).numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_lobpcg_generalized_matches_jax():
    """The top eigenpairs of a dense pencil (C, M) from the same start
    block: eigenvalues to 1e-10, vectors up to sign; from a generator the
    start block is the generator's normal draw."""
    from krylov_spdes_tpu.kl.lobpcg import lobpcg_generalized as j_lobpcg
    rng = np.random.default_rng(2)
    n, nev = 120, 6
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    C = Q @ np.diag(np.geomspace(1.0, 1e-6, n)) @ Q.T
    B = rng.normal(size=(n, n)) / np.sqrt(n)
    M = np.eye(n) + 0.1 * (B @ B.T)

    def ct(X):
        return _t(C) @ X

    def mt(X):
        return _t(M) @ X

    from jax.tree_util import Partial
    lj, Xj = j_lobpcg(Partial(jnp.matmul, jnp.asarray(C)),
                      Partial(jnp.matmul, jnp.asarray(M)), n, nev, iters=30)
    lt, Xt = kl.lobpcg_generalized(ct, mt, n, nev, iters=30,
                                   X0=_lobpcg_x0(n, nev + 8), **CPU64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    sign = np.sign(np.sum(Xt.numpy() * np.asarray(Xj), axis=0))
    np.testing.assert_allclose(Xt.numpy() * sign, np.asarray(Xj), atol=1e-8)
    a = kl.lobpcg_generalized(ct, mt, n, nev, iters=5, generator=torch.
                              Generator(device="cpu").manual_seed(5), **CPU64)
    X0 = torch.randn(n, nev + 8, generator=torch.Generator(
        device="cpu").manual_seed(5), dtype=torch.float64)
    b = kl.lobpcg_generalized(ct, mt, n, nev, iters=5, X0=X0, **CPU64)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


class _Resolved(Exception):
    pass


def test_auto_resolves_to_dense_on_a_small_mesh(monkeypatch):
    """"auto" resolves as in the JAX package (kl/single.py:102-104): dense
    at 300 nodes; lobpcg at 1600 nodes with nev < n/8; chunked above 20k
    nodes, in both packages (the chunked apply is stubbed to stop there).
    An unknown method raises."""
    mesh = get_mesh(300, seed=2)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    cov = kl.make_cov("sexp", 1.0, 0.5)
    lam_a, psi_a = kl.solve_kl(mesh.cells, mesh.points, cov, 20, Mt)
    lam_d, psi_d = kl.solve_kl(mesh.cells, mesh.points, cov, 20, Mt,
                               method="dense")
    np.testing.assert_array_equal(lam_a, lam_d)
    np.testing.assert_array_equal(psi_a, psi_d)

    mesh = get_mesh(1600, seed=0)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    cov = kl.make_cov("sexp", 1.0, 0.3)
    X0 = _lobpcg_x0(mesh.nnode, 10 + 8)
    lam_a, psi_a = kl.solve_kl(mesh.cells, mesh.points, cov, 10, Mt, X0=X0,
                               lobpcg_iters=10)
    lam_l, psi_l = kl.solve_kl(mesh.cells, mesh.points, cov, 10, Mt, X0=X0,
                               lobpcg_iters=10, method="lobpcg")
    np.testing.assert_array_equal(lam_a, lam_l)
    np.testing.assert_array_equal(psi_a, psi_l)
    with pytest.raises(ValueError):
        kl.solve_kl(mesh.cells, mesh.points, cov, 10, Mt, method="arpack")

    def stop(*a, **k):
        raise _Resolved("chunked")

    mesh = get_mesh(20500)
    assert mesh.nnode > 20_000
    monkeypatch.setattr(kl.single, "make_chunked_cov_apply", stop)
    monkeypatch.setattr(jsingle, "make_chunked_cov_apply", stop)
    with pytest.raises(_Resolved):
        kl.solve_kl(mesh.cells, mesh.points, cov, 50,
                    tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64))
    with pytest.raises(_Resolved):
        jsingle.solve_kl(mesh.cells, mesh.points,
                         jcov.make_cov("sexp", 1.0, 0.3), 50,
                         j_mass(mesh.cells, mesh.points))


def test_synthesis_roundtrip_and_jax_parity():
    """set_field and get_kl_coordinates against the JAX package on the same
    ξ (1e-12), the ξ → g → ξ round trip, and draw from a seeded generator."""
    mesh = get_mesh(300, seed=2)
    Mj = j_mass(mesh.cells, mesh.points)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    lam, psi = kl.solve_kl(mesh.cells, mesh.points,
                           kl.make_cov("sexp", 1.0, 0.5), 20, Mt,
                           relative=0.999, method="dense")
    xi = np.random.default_rng(3).normal(size=lam.shape[0])
    g_j = jsyn.set_field(jnp.asarray(lam), jnp.asarray(psi), jnp.asarray(xi))
    g_t = kl.set_field(_t(lam), _t(psi), _t(xi))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-14)
    back_j = jsyn.get_kl_coordinates(g_j, jnp.asarray(lam), jnp.asarray(psi),
                                     Mj)
    back_t = kl.get_kl_coordinates(g_t, _t(lam), _t(psi), Mt)
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(back_t.numpy(), xi, atol=1e-8)

    gen = torch.Generator(device="cpu").manual_seed(7)
    xi1, g1 = kl.draw(_t(lam), _t(psi), gen)
    gen = torch.Generator(device="cpu").manual_seed(7)
    xi2, g2 = kl.draw(_t(lam), _t(psi), gen)
    np.testing.assert_array_equal(xi1.numpy(), xi2.numpy())
    np.testing.assert_array_equal(g1.numpy(),
                                  kl.set_field(_t(lam), _t(psi), xi1).numpy())
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())


def test_trim_and_order_and_helper_match_jax():
    rng = np.random.default_rng(1)
    lam = np.sort(rng.normal(size=9))
    phi = rng.normal(size=(20, 9))
    lj, pj = jsyn.trim_and_order(lam, phi)
    lt, pt = kl.trim_and_order(lam, phi)
    np.testing.assert_array_equal(lt, np.asarray(lj))
    np.testing.assert_array_equal(pt, np.asarray(pj))
    assert np.all(lt > 0) and np.all(np.diff(lt) <= 0)
    for n in (5_000, 100_000, 100_001, 2_000_000):
        assert kl.suggest_parameters(n) == jhelp.suggest_parameters(n)
    assert (kl.get_root_filename("SExp", 1.0, 0.1, 4000)
            == jhelp.get_root_filename("SExp", 1.0, 0.1, 4000))
