"""PyTorch port, RCM-banded block-tridiagonal subdomain interiors
(fem/dd_banded.py) against the JAX package and against the port's dense
interiors: float64 on the CPU, one Delaunay mesh and partition through both
packages (tests/test_dd_banded.py's cases), state carried across by
convert.py where the test says so."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem import dd as jdd
from krylov_spdes_tpu.fem import dd_banded as jdb
from krylov_spdes_tpu.fem import schur as jschur
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_delaunay_mesh
from krylov_spdes_tpu.fem.partition import mesh_partition
from krylov_spdes_tpu.solvers import refine as jref
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import convert, fem
from krylov_spdes_tpu_torch.fem import dd_banded as tdb
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.solvers import pcg, refined_dd_pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def fsrc(x, y):
    return -1.0 + 0.0 * x


def uex(x, y):
    return 0.0 * x


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture(scope="module")
def problem():
    """tests/test_dd_banded.py's system: get_delaunay_mesh(1200, seed=1) in
    6 subdomains, coefficient exp(N(0,1)) from numpy seed 1."""
    mesh = get_delaunay_mesh(1200, seed=1)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = mesh_partition(mesh.cells, mesh.points, 6, mesh.cell_neighbors)
    part_j = jdd.set_subdomains(mesh.cells, epart, maps, 6)
    plan_j = jdd.prepare_dd_assembly(mesh.cells, mesh.points, epart, part_j,
                                     maps, fsrc, uex)
    maps_t = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    part = fem.set_subdomains(mesh.cells, epart, maps_t, 6)
    plan = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part,
                                   maps_t, fsrc, uex, **CPU64)
    coeff = np.exp(np.random.default_rng(1).normal(size=mesh.nnode))
    bj = jdd.assemble_dd_values(plan_j, jnp.asarray(coeff))
    bt = fem.assemble_dd_values(plan, torch.as_tensor(coeff))
    tab_j = jdb.prepare_banded_interiors(mesh.cells, part_j, plan_j)
    tab = tdb.prepare_banded_interiors(mesh.cells, part, plan)
    S = tschur.prepare_schur_operator(plan, part, *bt[:3])
    Sb = tdb.prepare_schur_operator_banded(plan, part, *bt[:3], tab)
    Sbj = jdb.prepare_schur_operator_banded(plan_j, part_j, *bj[:3], tab_j)
    return dict(mesh=mesh, part_j=part_j, plan_j=plan_j, part=part,
                plan=plan, coeff=coeff, bj=bj, bt=bt, tab_j=tab_j, tab=tab,
                S=S, Sb=Sb, Sbj=Sbj)


def test_banded_tables_match_jax(problem):
    """The per-subdomain RCM tables equal the JAX package's, and carry
    across by convert.banded_interior_tables; the shared block is well below
    nI; a block below the bandwidth is refused."""
    p = problem
    tab, tab_j = p["tab"], p["tab_j"]
    for k, v in convert.numpy_fields(tab_j).items():
        np.testing.assert_array_equal(np.asarray(getattr(tab, k)), v, k)
    carried = convert.banded_interior_tables(**convert.numpy_fields(tab_j))
    np.testing.assert_array_equal(carried.perm, tab.perm)
    assert (carried.nb, carried.m) == (tab.nb, tab.m)
    assert tab.m < p["part"].interior_l2g.shape[1]
    assert tab.nb * tab.m >= p["part"].interior_l2g.shape[1]
    with pytest.raises(ValueError, match="bandwidth"):
        tdb.prepare_banded_interiors(p["mesh"].cells, p["part"], p["plan"],
                                     block=int(tab.bw.max()) - 1)


def test_banded_interior_solve_matches_dense_and_jax(problem):
    """A_II⁻¹ on a vector and on the (nI, nG) right-hand sides of the
    condensation: the banded operator against the dense one (rtol 1e-8,
    tests/test_dd_banded.py's) and against the JAX package's banded operator,
    the port's own and one carried across by convert.schur_operator_banded
    (rtol 1e-10)."""
    p = problem
    S, Sb, Sbj = p["S"], p["Sb"], p["Sbj"]
    im = p["plan"].imask.numpy()
    rhs = np.random.default_rng(0).normal(size=im.shape) * im
    carried = convert.schur_operator_banded(**convert.numpy_fields(Sbj),
                                            **CPU64)
    xd = S.interior_apply_inv(torch.as_tensor(rhs)).numpy()
    xj = np.asarray(Sbj.interior_apply_inv(jnp.asarray(rhs)))
    for op in (Sb, carried):
        xb = op.interior_apply_inv(torch.as_tensor(rhs)).numpy()
        np.testing.assert_allclose(xb * im, xd * im, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(xb * im, xj * im, rtol=1e-10, atol=1e-12)
    xd2 = S.interior_apply_inv(S.A_IG).numpy()
    xb2 = Sb.interior_apply_inv(Sb.A_IG).numpy()
    xj2 = np.asarray(Sbj.interior_apply_inv(Sbj.A_IG))
    np.testing.assert_allclose(xb2 * im[:, :, None], xd2 * im[:, :, None],
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(xb2 * im[:, :, None], xj2 * im[:, :, None],
                               rtol=1e-10, atol=1e-12)


def test_banded_schur_solve_parity(problem):
    """The whole interface solve through the banded operator: its Schur
    apply and condensed right-hand side against the dense operator's (rtol
    1e-8), NN-PCG `it` within 2 of the dense solve's (tests/
    test_dd_banded.py's) and equal to the JAX package's banded solve, the
    solution and subdomain solutions within 1e-6 of the dense."""
    p = problem
    S, Sb, Sbj, bt, bj = p["S"], p["Sb"], p["Sbj"], p["bt"], p["bj"]
    x = torch.as_tensor(np.random.default_rng(3).normal(size=p["part"].n_gamma))
    np.testing.assert_allclose(Sb(x).numpy(), S(x).numpy(), rtol=1e-8,
                               atol=1e-9)
    b_s = tschur.get_schur_rhs(S, bt[3], bt[4])
    b_sb = tschur.get_schur_rhs(Sb, bt[3], bt[4])
    np.testing.assert_allclose(b_sb.numpy(), b_s.numpy(), rtol=1e-8,
                               atol=1e-10)
    r_d = pcg(S, b_s, M=tschur.prepare_neumann_neumann_schur_precond(S),
              rtol=1e-9)
    r_b = pcg(Sb, b_sb, M=tschur.prepare_neumann_neumann_schur_precond(Sb),
              rtol=1e-9)
    r_j = j_pcg(Sbj, jschur.get_schur_rhs(Sbj, bj[3], bj[4]),
                M=jschur.prepare_neumann_neumann_schur_precond(Sbj), rtol=1e-9)
    assert abs(int(r_b.it) - int(r_d.it)) <= 2, (int(r_d.it), int(r_b.it))
    assert int(r_b.it) == int(r_j.it), (int(r_b.it), int(r_j.it))
    np.testing.assert_allclose(r_b.x.numpy(), r_d.x.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(r_b.x.numpy(), np.asarray(r_j.x), rtol=1e-8,
                               atol=1e-10)
    im = p["plan"].imask.numpy()
    u_d = tschur.get_subdomain_solutions(S, r_d.x, bt[3]).numpy()
    u_b = tschur.get_subdomain_solutions(Sb, r_b.x, bt[3]).numpy()
    np.testing.assert_allclose(u_b * im, u_d * im, rtol=1e-6, atol=1e-8)


def test_banded_refill_matches_dense_assembly(problem):
    """The direct banded refill (no dense A_II anywhere): its routing plan
    equal to the JAX package's and carried across by
    convert.banded_refill_plan; its (D, E) bands equal to those sliced from
    the dense assembly and to the JAX refill's, the other blocks equal to
    assemble_dd_values' (rtol 1e-12, tests/test_dd_banded.py's); a refill
    repeats bit for bit; the Schur solve through the refilled operator
    against the dense path (rtol 1e-7)."""
    p = problem
    plan, part, tab, bt = p["plan"], p["part"], p["tab"], p["bt"]
    bplan = tdb.prepare_banded_dd_refill(plan, part, tab)
    bplan_j = jdb.prepare_banded_dd_refill(p["plan_j"], p["part_j"], p["tab_j"])
    fj = convert.numpy_fields(bplan_j)
    for k in ("idx_D", "idx_E", "sel_D", "sel_E", "D_base", "nb", "m"):
        np.testing.assert_array_equal(_np(getattr(bplan, k)), fj[k], k)
    carried = convert.banded_refill_plan(**fj, **CPU64)

    coeff = torch.as_tensor(p["coeff"])
    out = tdb.assemble_dd_values_banded(plan, bplan, coeff)
    for again in (tdb.assemble_dd_values_banded(plan, bplan, coeff),
                  tdb.assemble_dd_values_banded(plan, carried, coeff)):
        for a, b in zip(out, again):
            assert torch.equal(a, b)
    D, E, A_IG, A_GGd, b_I, b_G = out
    perm = torch.as_tensor(tab.perm.astype(np.int64))
    Dd, Ed = tdb._banded_blocks_from_dense(bt[0], plan.imask, perm, tab.nb,
                                           tab.m)
    outj = jdb.assemble_dd_values_banded(p["plan_j"], bplan_j,
                                         jnp.asarray(p["coeff"]))
    for got, want in ((D, Dd), (E, Ed), (A_IG, bt[1]), (A_GGd, bt[2]),
                      (b_I, bt[3]), (b_G, bt[4])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-13)
    for got, want in zip(out, outj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-13)

    Sr = tdb.prepare_schur_operator_banded_refill(plan, part, D, E, A_IG,
                                                  A_GGd, tab)
    S = p["S"]
    b_s = tschur.get_schur_rhs(S, bt[3], bt[4])
    b_sr = tschur.get_schur_rhs(Sr, b_I, b_G)
    np.testing.assert_allclose(b_sr.numpy(), b_s.numpy(), rtol=1e-10,
                               atol=1e-12)
    xd = pcg(S, b_s, rtol=1e-10)
    xr = pcg(Sr, b_sr, rtol=1e-10)
    np.testing.assert_allclose(xr.x.numpy(), xd.x.numpy(), rtol=1e-7,
                               atol=1e-9)


def test_banded_refill_refuses_stray_entries(problem):
    """Tables whose block is narrower than the bandwidth route entries
    outside the block-tridiagonal band: both packages raise."""
    p = problem
    tab = p["tab"]
    nI = p["part"].interior_l2g.shape[1]
    m = max(2, tab.m // 4)
    narrow = dataclasses.replace(tab, m=m, nb=-(-nI // m))
    with pytest.raises(AssertionError, match="outside the"):
        tdb.prepare_banded_dd_refill(p["plan"], p["part"], narrow)
    with pytest.raises(AssertionError, match="outside the"):
        jdb.prepare_banded_dd_refill(p["plan_j"], p["part_j"],
                                     dataclasses.replace(p["tab_j"], m=m,
                                                         nb=-(-nI // m)))


def test_refined_dd_pcg_on_banded_operator(problem):
    """refined_dd_pcg takes the banded operator unchanged: certified at
    1e-7 by a float64 residual of the full DD system computed apart, with
    the JAX package's sweep count and `it` within a sweep of its count."""
    p = problem
    plan, Sb, Sbj, bt, bj = p["plan"], p["Sb"], p["Sbj"], p["bt"], p["bj"]
    rt = refined_dd_pcg(plan, Sb, Sb, bt[3], bt[4], *bt[:3],
                        M=tschur.prepare_neumann_neumann_schur_precond(Sb))
    rj = jref.refined_dd_pcg(
        p["plan_j"], Sbj, Sbj, bj[3], bj[4], *bj[:3],
        M=jschur.prepare_neumann_neumann_schur_precond(Sbj))
    assert not rt.breakdown and not rj.breakdown
    assert rt.refines == rj.refines
    assert abs(int(rt.it) - int(rj.it)) <= rt.refines
    A_II, A_IG, A_GGd, b_I, b_G = [b.numpy() for b in bt]
    im, gm = plan.imask.numpy(), plan.gmask.numpy()
    g2g = Sb.gammad_to_gamma.numpy()
    uI = rt.u_I[0].numpy() + rt.u_I[1].numpy()
    uG = rt.x_df32[0].numpy() + rt.x_df32[1].numpy()
    xd = uG[g2g] * gm
    rI = (b_I * im - np.einsum("dij,dj->di", A_II * im[:, :, None]
                               * im[:, None, :], uI)
          - np.einsum("dig,dg->di", A_IG * im[:, :, None] * gm[:, None, :],
                      xd)) * im
    sd = (np.einsum("dig,di->dg", A_IG * im[:, :, None] * gm[:, None, :], uI)
          + np.einsum("dgh,dh->dg", A_GGd * gm[:, :, None] * gm[:, None, :],
                      xd)) * gm
    rG = b_G.copy()
    np.subtract.at(rG, g2g.reshape(-1), sd.reshape(-1))
    bnorm = np.sqrt(np.sum((b_I * im) ** 2) + np.sum(b_G ** 2))
    assert np.sqrt(np.sum(rI ** 2) + np.sum(rG ** 2)) <= 1e-7 * bnorm
