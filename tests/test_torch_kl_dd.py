"""PyTorch port, the two-level KL (kl/dd.py, kl/dd_device.py) against the
JAX package, float64 on the CPU, on the small meshes of tests/test_kl_dd.py
and tests/test_kl_device.py with the same partition: the subdomain tables
and local mass matrices, the local eigensolves (dense, and randomized from
the same start block), the reduced covariance, the end-to-end bases, the
two-level draw from the same ξ, and the state converters. Eigenvalues agree
to 1e-10 (the tiny trailing ones to their absolute accuracy, 1e-14 of the
largest), modes up to sign to 1e-8 of their largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.partition import mesh_partition
from krylov_spdes_tpu.kl import covariance as jcov
from krylov_spdes_tpu.kl import dd as jdd
from krylov_spdes_tpu.kl import dd_device as jdev

from krylov_spdes_tpu_torch import convert, kl
from krylov_spdes_tpu_torch.kl import dd as tdd
from krylov_spdes_tpu_torch.kl import dd_device as tdev

import oracle

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _problem(nn=500, ndom=6, seed=2, L=0.3):
    mesh = get_mesh(nn, jitter=0.2, seed=seed)
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    return (mesh, epart, ndom, jcov.make_cov("sexp", 1.0, L),
            kl.make_cov("sexp", 1.0, L))


def _abs_close(a, b, tol=1e-8):
    """Modes up to sign: max ||a| − |b|| ≤ tol·max |b|."""
    a, b = np.abs(np.asarray(a)), np.abs(np.asarray(b))
    assert np.max(np.abs(a - b)) <= tol * np.max(b)


def _lam_close(a, b, rtol=1e-10):
    """Eigenvalues to rtol, the tiny trailing ones to their absolute
    accuracy eps·max λ (1e-14·max λ)."""
    np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-14 * np.max(b))


def test_tables_and_local_mass_match_jax():
    """set_kl_subdomains and build_kl_tables give the JAX package's tables;
    the local mass matrices (host-assembled, and rebuilt on the device from
    the element tables) equal the JAX package's and scatter back to the
    global mass matrix (tests/test_kl_dd.py:17); the converters carry the
    JAX objects over."""
    mesh, epart, ndom, _, _ = _problem(nn=200, ndom=4, seed=0)
    sj = jdd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom)
    st = tdd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom, **CPU64)
    for f in ("nodes", "node_mask", "n_nodes", "centers", "areas", "cnt"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    assert (st.ndom, st.n_max) == (sj.ndom, sj.n_max)
    np.testing.assert_allclose(st.M_local.numpy(), np.asarray(sj.M_local),
                               rtol=1e-14, atol=1e-18)
    Mg = oracle.mass_matrix(mesh.cells, mesh.points).toarray()
    Msum = np.zeros_like(Mg)
    for d in range(ndom):
        g = st.nodes[d, :int(st.n_nodes[d])]
        Msum[np.ix_(g, g)] += st.M_local.numpy()[d, :len(g), :len(g)]
    np.testing.assert_allclose(Msum, Mg, rtol=1e-10, atol=1e-12)

    tj = jdev.build_kl_tables(mesh.cells, mesh.points, epart, ndom)
    tt = tdev.build_kl_tables(mesh.cells, mesh.points, epart, ndom)
    for f in ("ndom", "n_max", "nel_max", "nodes", "node_mask", "li",
              "el_area", "centers", "areas", "cnt"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
    Mdev = tdev._build_mass_chunk(torch.as_tensor(tt.li.astype(np.int64)),
                                  torch.tensor(tt.el_area), tt.n_max)
    Mj = jdev._build_mass_chunk(jnp.asarray(tj.li), jnp.asarray(tj.el_area),
                                tj.n_max)
    np.testing.assert_allclose(Mdev.numpy(), np.asarray(Mj), rtol=1e-14,
                               atol=1e-18)
    np.testing.assert_allclose(Mdev.numpy(), st.M_local.numpy(), rtol=1e-13,
                               atol=1e-18)

    back = convert.kl_subdomains(**convert.numpy_fields(sj), **CPU64)
    np.testing.assert_array_equal(back.M_local.numpy(),
                                  np.asarray(sj.M_local))
    np.testing.assert_array_equal(back.nodes, sj.nodes)
    tb = convert.kl_dom_tables(**convert.numpy_fields(tj))
    np.testing.assert_array_equal(tb.li, tj.li)
    assert tb.n_max == tj.n_max


def test_solve_local_kls_and_reduced_covariance_match_jax():
    """The host pipeline's stages: the local eigenpairs and their
    truncation (also in dom chunks), the reduced covariance K, and the
    reduced eigensolve with its projection, dense and through eigsh."""
    mesh, epart, ndom, cj, ct = _problem(nn=400, ndom=4, seed=9, L=0.4)
    sj = jdd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom)
    st = tdd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom, **CPU64)
    lj, pj, mj, ej = jdd.solve_local_kls(sj, mesh.points, cj, 15)
    for chunk in (None, 3):
        lt, pt, mt, et = tdd.solve_local_kls(st, mesh.points, ct, 15,
                                             dom_chunk=chunk)
        np.testing.assert_array_equal(mt, mj)
        assert abs(et - ej) <= 1e-12 * abs(ej)
        _lam_close(lt, lj)
        _abs_close(pt, pj)
    Kj = jdd.assemble_reduced_covariance(sj, mesh.points, cj, pj)
    Kt = tdd.assemble_reduced_covariance(st, mesh.points, ct, pj,
                                         pair_chunk=3)
    np.testing.assert_allclose(Kt, Kj, rtol=1e-12, atol=1e-15)
    for max_modes in (None, 3):
        lamj, psij, Vj = jdd.solve_global_reduced_kl(
            mesh.nnode, Kj, ej, sj, pj, return_reduced=True,
            max_modes=max_modes)
        lamt, psit, Vt = tdd.solve_global_reduced_kl(
            mesh.nnode, Kt, et, st, pj, return_reduced=True,
            max_modes=max_modes)
        _lam_close(lamt, lamj)
        _abs_close(psit, psij)


def test_compute_dd_kl_matches_jax():
    mesh, epart, ndom, cj, ct = _problem(nn=600, ndom=6, seed=7, L=0.4)
    lj, pj = jdd.compute_dd_kl(mesh.cells, mesh.points, epart, ndom, cj,
                               nev=15, relative_local=0.999,
                               relative_global=0.99)
    lt, pt = tdd.compute_dd_kl(mesh.cells, mesh.points, epart, ndom, ct,
                               nev=15, relative_local=0.999,
                               relative_global=0.99, **CPU64)
    assert isinstance(lt, np.ndarray) and lt.shape == lj.shape
    _lam_close(lt, lj)
    _abs_close(pt, pj)


@pytest.mark.parametrize("max_modes", [None, 5])
def test_compute_dd_kl_device_matches_jax(max_modes):
    mesh, epart, ndom, cj, ct = _problem(nn=600, ndom=6, seed=7, L=0.4)
    kw = dict(nev=15, relative_local=0.999, relative_global=0.99,
              dom_chunk=2, pair_chunk=4, max_modes=max_modes)
    lj, pj = jdev.compute_dd_kl_device(mesh.cells, mesh.points, epart, ndom,
                                       cj, **kw)
    lt, pt = tdev.compute_dd_kl_device(mesh.cells, mesh.points, epart, ndom,
                                       ct, **kw, **CPU64)
    assert lt.shape == lj.shape
    _lam_close(lt, lj)
    _abs_close(pt, pj)
    # and the host pipeline (tests/test_kl_device.py:83-95)
    if max_modes is None:
        lh, ph = tdd.compute_dd_kl(mesh.cells, mesh.points, epart, ndom, ct,
                                   nev=15, relative_local=0.999,
                                   relative_global=0.99, **CPU64)
        _lam_close(lt, lh, rtol=1e-7)
        np.testing.assert_allclose(np.abs(pt), np.abs(ph), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("local_eig", ["eigh", "randomized"])
def test_local_kls_device_matches_jax(local_eig):
    """Stage A in dom chunks; the randomized solver from the JAX package's
    own start block (PRNGKey(0), the same block for every chunk)."""
    mesh, epart, ndom, cj, ct = _problem()
    nev, chunk = 12, 2
    tables = jdev.build_kl_tables(mesh.cells, mesh.points, epart, ndom)
    out_j = jdev.local_kls_device(tables, mesh.points, cj, nev,
                                  relative=0.99, dom_chunk=chunk,
                                  local_eig=local_eig)
    Y0 = None
    if local_eig == "randomized":
        Y0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (chunk, tables.n_max, nev + 16),
                                          jnp.float64))
    out_t = tdev.local_kls_device(tables, mesh.points, ct, nev,
                                  relative=0.99, dom_chunk=chunk,
                                  local_eig=local_eig, Y0=Y0, **CPU64)
    lam_j, phi_j, rho_j, m_j, e_j = (np.asarray(a) for a in out_j)
    lam_t, phi_t, rho_t, m_t, e_t = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(m_t, m_j)
    assert abs(float(e_t) - float(e_j)) <= 1e-12 * abs(float(e_j))
    _lam_close(lam_t, lam_j)
    _abs_close(phi_t, phi_j)
    _abs_close(rho_t, rho_j)
    if local_eig == "eigh":
        # "auto" is the dense eigh off a TPU
        auto = tdev.local_kls_device(tables, mesh.points, ct, nev,
                                     relative=0.99, dom_chunk=chunk,
                                     local_eig="auto", **CPU64)
        np.testing.assert_array_equal(auto[0].numpy(), lam_t)


def test_randomized_local_eig_from_a_generator():
    """Without a start block the randomized path draws one from the
    generator and agrees with the dense eigh
    end to end as tests/test_kl_device.py:98-117 holds the JAX package:
    the same mode count, captured variance to 1e-6, λ to 1e-3."""
    mesh, epart, ndom, _, ct = _problem(nn=800, ndom=6, seed=3)
    kw = dict(nev=20, relative_local=0.999, relative_global=0.99, **CPU64)
    le, _ = tdev.compute_dd_kl_device(mesh.cells, mesh.points, epart, ndom,
                                      ct, local_eig="eigh", **kw)
    lr, _ = tdev.compute_dd_kl_device(
        mesh.cells, mesh.points, epart, ndom, ct, local_eig="randomized",
        generator=torch.Generator(device="cpu").manual_seed(0), **kw)
    assert len(le) == len(lr)
    assert abs(np.sum(le) - np.sum(lr)) / np.sum(le) < 1e-6
    np.testing.assert_allclose(lr, le, rtol=1e-3)


def test_reduced_covariance_device_matches_jax():
    """Stage B over pair chunks (the last one partial) against the JAX
    package's scan, 1e-12."""
    mesh, epart, ndom, cj, ct = _problem(nn=400, ndom=4)
    tables = jdev.build_kl_tables(mesh.cells, mesh.points, epart, ndom)
    _, _, rho, _, _ = jdev.local_kls_device(tables, mesh.points, cj, 10)
    Kj = jdev.reduced_covariance_device(tables, mesh.points, rho, cj,
                                        pair_chunk=3)
    Kt = tdev.reduced_covariance_device(tables, mesh.points,
                                        torch.tensor(np.asarray(rho)), ct,
                                        pair_chunk=3)
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(tdev.screened_pairs(tables, ct, 0.5),
                                  jdev.screened_pairs(tables, cj, 0.5))


def test_draw_dd_matches_jax():
    """The two-level draw from the JAX package's ξ, and its agreement with
    synthesis on the projected basis (tests/test_kl_dd.py's
    test_draw_dd_matches_projected_synthesis)."""
    mesh, epart, ndom, cj, ct = _problem(nn=400, ndom=4, seed=9, L=0.4)
    sj = jdd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom)
    st = tdd.set_kl_subdomains(mesh.cells, mesh.points, epart, ndom, **CPU64)
    lam_d, phi_d, _, energy = jdd.solve_local_kls(sj, mesh.points, cj, 15)
    K = jdd.assemble_reduced_covariance(sj, mesh.points, cj, phi_d)
    lam, psi, Vr = jdd.solve_global_reduced_kl(mesh.nnode, K, energy, sj,
                                               phi_d, return_reduced=True)
    xi_j, g_j = jdd.draw_dd(sj, lam, Vr, phi_d, jax.random.PRNGKey(3))
    xi_t, g_t = tdd.draw_dd(st, lam, Vr, phi_d, xi=np.asarray(xi_j))
    np.testing.assert_array_equal(xi_t.numpy(), np.asarray(xi_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-13)
    g_ref = kl.set_field(torch.tensor(lam), torch.tensor(psi), xi_t)
    np.testing.assert_allclose(g_t.numpy(), g_ref.numpy(), rtol=1e-9,
                               atol=1e-11)
    gen = torch.Generator(device="cpu").manual_seed(1)
    xi_g, g_g = tdd.draw_dd(st, lam, Vr, phi_d, generator=gen)
    again = tdd.draw_dd(st, lam, Vr, phi_d, xi=xi_g)[1]
    np.testing.assert_array_equal(g_g.numpy(), again.numpy())
