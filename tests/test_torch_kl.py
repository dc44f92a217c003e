"""PyTorch port, the KL front end (kl/) against the JAX package: covariance
models, the mass matrix, the Galerkin covariance operator, the dense
generalized eigenproblem with its truncation, and field synthesis. float64 on
the CPU."""

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


def test_solve_kl_unported_methods_raise():
    """lobpcg and the chunked apply wait for the two-level KL; asking for
    them, or for "auto" where it resolves to one of them, raises and never
    quietly runs dense."""
    mesh = get_mesh(1600, seed=0)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    cov = kl.make_cov("sexp", 1.0, 0.3)
    for method in ("lobpcg", "chunked"):
        with pytest.raises(NotImplementedError, match="item 15"):
            kl.solve_kl(mesh.cells, mesh.points, cov, 10, Mt, method=method)
    # 1600 nodes, nev < n/8: "auto" resolves to lobpcg
    with pytest.raises(NotImplementedError, match="lobpcg"):
        kl.solve_kl(mesh.cells, mesh.points, cov, 10, Mt)
    with pytest.raises(ValueError):
        kl.solve_kl(mesh.cells, mesh.points, cov, 10, Mt, method="arpack")


def test_auto_resolves_to_dense_on_a_small_mesh():
    mesh = get_mesh(300, seed=2)
    Mt = tfem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    cov = kl.make_cov("sexp", 1.0, 0.5)
    lam_a, psi_a = kl.solve_kl(mesh.cells, mesh.points, cov, 20, Mt)
    lam_d, psi_d = kl.solve_kl(mesh.cells, mesh.points, cov, 20, Mt,
                               method="dense")
    np.testing.assert_array_equal(lam_a, lam_d)
    np.testing.assert_array_equal(psi_a, psi_d)


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
