"""PyTorch port, the stencil-derived DD refill (fem/dd_stencil.py) and the
block-tridiagonal interior factors (fem/schur.py) against the JAX package.
float64 on the CPU; the same mesh and coefficient from a numpy seed through
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem import dd_stencil as jds
from krylov_spdes_tpu.fem import schur as jschur
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.fem import dd as tdd
from krylov_spdes_tpu_torch.fem import dd_stencil as tds
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
CASES = [(6, 900), (4, 400), (9, 1200)]


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_dir(x, y):
    return 0.1 * x + 0.05 * y


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(a, b, rtol, what=""):
    """a (tensor) against b (array) to rtol of b's largest entry."""
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=what)


def _fields_equal(a, b):
    fa, fb = convert.numpy_fields(a), convert.numpy_fields(b)
    for k, va in fa.items():
        if k not in fb or k in ("splan", "tables"):
            continue
        vb = fb[k]
        if isinstance(va, np.ndarray) and va.dtype.kind == "f":
            np.testing.assert_allclose(vb, va, rtol=1e-13, atol=0, err_msg=k)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(vb, va, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=k)


_built = {}


def build(ndom, nnode):
    if (ndom, nnode) not in _built:
        mesh = get_mesh(nnode, jitter=0.2, seed=0)
        maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
        epart_j, part_j, plan_j = jds.prepare_dd_stencil_assembly(
            mesh, maps, f_src, u_dir, ndom)
        mesh_t = tfem.get_mesh(nnode, jitter=0.2, seed=0)
        maps_t = tfem.get_dirichlet_inds(mesh_t.points, mesh_t.point_markers)
        epart_t, part_t, plan_t = tds.prepare_dd_stencil_assembly(
            mesh_t, maps_t, f_src, u_dir, ndom, **CPU64)
        coeff = np.exp(np.random.default_rng(0).normal(size=mesh.nnode))
        _built[ndom, nnode] = dict(
            mesh=mesh, maps=maps, epart_j=epart_j, part_j=part_j,
            plan_j=plan_j, mesh_t=mesh_t, maps_t=maps_t, epart_t=epart_t,
            part_t=part_t, plan_t=plan_t, coeff=coeff)
    return _built[ndom, nnode]


def test_tile_dims_and_grid_partition():
    for ndom in (1, 4, 6, 12, 30, 64):
        assert tds.tile_dims(ndom) == jds.tile_dims(ndom)
    mesh = tfem.get_mesh(1600, jitter=0.2, seed=3)
    epart, tg = tds.grid_partition(mesh, 12)
    epart_j, _ = jds.grid_partition(get_mesh(1600, jitter=0.2, seed=3), 12)
    np.testing.assert_array_equal(epart, epart_j)
    counts = np.bincount(epart, minlength=12)
    assert counts.min() > 0
    assert counts.max() - counts.min() <= 2 * (tg["m"] + 1)


@pytest.mark.parametrize("ndom,nnode", CASES)
def test_prepare_dd_stencil_assembly_equal(ndom, nnode):
    """Partition, index tables and static fields equal; factor values to
    rtol 1e-13 (the same numpy expressions)."""
    p = build(ndom, nnode)
    np.testing.assert_array_equal(p["epart_t"], p["epart_j"])
    _fields_equal(p["part_j"], p["part_t"])
    _fields_equal(p["plan_j"], p["plan_t"])
    _fields_equal(p["plan_j"].splan, p["plan_t"].splan)


@pytest.mark.parametrize("carried", [False, True], ids=["own", "converted"])
@pytest.mark.parametrize("ndom,nnode", CASES[:2])
def test_dense_stencil_refill_matches(ndom, nnode, carried):
    """assemble_dd_values_stencil: the five blocks to rtol 1e-13 of their
    largest entry, from the port's plan and from the JAX plan carried
    across by convert.dd_stencil_plan."""
    p = build(ndom, nnode)
    plan_t = (convert.dd_stencil_plan(**convert.numpy_fields(p["plan_j"]),
                                      **CPU64) if carried else p["plan_t"])
    bj = jds.assemble_dd_values_stencil(p["plan_j"], jnp.asarray(p["coeff"]))
    bt = tds.assemble_dd_values_stencil(plan_t, _t(p["coeff"]))
    for name, a, b in zip(("A_II", "A_IG", "A_GGd", "b_I", "b_G"), bt, bj):
        _close(a, b, 1e-13, name)


@pytest.mark.parametrize("ndom,nnode", CASES)
def test_stencil_refill_matches_general_refill(ndom, nnode):
    """tests/test_dd_stencil.py's dual-path check inside the port: the
    stencil refill and the general routing refill on the same tiling give
    the same Schur apply, condensed right-hand side (1e-10) and NN apply
    (1e-8); the local orderings differ, the interface does not."""
    p = build(ndom, nnode)
    mesh, maps = p["mesh_t"], p["maps_t"]
    part_g = tdd.set_subdomains(mesh.cells, p["epart_t"], maps, ndom)
    plan_g = tdd.prepare_dd_assembly(mesh.cells, mesh.points, p["epart_t"],
                                     part_g, maps, f_src, u_dir, **CPU64)
    np.testing.assert_array_equal(p["part_t"].gamma_l2g, part_g.gamma_l2g)
    np.testing.assert_array_equal(p["part_t"].gamma_cnt, part_g.gamma_cnt)
    coeff = _t(p["coeff"])
    bf = tds.assemble_dd_values_stencil(p["plan_t"], coeff)
    bg = tdd.assemble_dd_values(plan_g, coeff)
    Sf = tschur.prepare_schur_operator(p["plan_t"], p["part_t"], *bf[:3])
    Sg = tschur.prepare_schur_operator(plan_g, part_g, *bg[:3])
    x = _t(np.random.default_rng(1).normal(size=part_g.n_gamma))
    _close(Sf.matvec(x), Sg.matvec(x).numpy(), 1e-10)
    _close(tschur.get_schur_rhs(Sf, bf[3], bf[4]),
           tschur.get_schur_rhs(Sg, bg[3], bg[4]).numpy(), 1e-10)
    Mf = tschur.prepare_neumann_neumann_schur_precond(Sf)
    Mg = tschur.prepare_neumann_neumann_schur_precond(Sg)
    _close(Mf(x), Mg(x).numpy(), 1e-8)


@pytest.mark.parametrize("carried", [False, True], ids=["own", "converted"])
@pytest.mark.parametrize("ndom,nnode", CASES)
def test_condense_dd_stencil_matches(ndom, nnode, carried):
    """condense_dd_stencil against the JAX package's: block factors, A_IΓ,
    A_ΓΓd, b_I to 1e-12 (unique Cholesky factors of well-conditioned wM×wM
    blocks), b_schur and the Schur apply to 1e-10."""
    p = build(ndom, nnode)
    plan_t = (convert.dd_stencil_plan(**convert.numpy_fields(p["plan_j"]),
                                      **CPU64) if carried else p["plan_t"])
    Sj, bsj, bIj = jds.condense_dd_stencil(p["plan_j"], jnp.asarray(p["coeff"]))
    St, bst, bIt = tds.condense_dd_stencil(plan_t, _t(p["coeff"]))
    assert isinstance(St, tschur.SchurOperatorBT)
    for name in ("Linv", "G", "A_IG", "A_GGd"):
        _close(getattr(St, name), getattr(Sj, name), 1e-12, name)
    _close(bIt, bIj, 1e-13, "b_I")
    _close(bst, bsj, 1e-10, "b_schur")
    x = np.random.default_rng(2).normal(size=St.n_gamma)
    _close(St.matvec(_t(x)), jschur.schur_matvec(Sj, jnp.asarray(x)), 1e-10)
    _close(tschur.assemble_local_schurs(St), jschur.assemble_local_schurs(Sj),
           1e-10, "Sd")
    carried_S = convert.schur_operator(**convert.numpy_fields(Sj), **CPU64)
    assert isinstance(carried_S, tschur.SchurOperatorBT)
    _close(carried_S.matvec(_t(x)), St.matvec(_t(x)).numpy(), 1e-10)


@pytest.mark.parametrize("ndom,nnode", CASES[:2])
def test_block_tridiagonal_factors_match_dense_cholesky(ndom, nnode):
    """bt_factor_batched / bt_interior_solve against the dense Cholesky of
    the same interiors (assemble_dd_values_stencil's A_II), vector and
    matrix right-hand sides: 1e-10 of the solution."""
    p = build(ndom, nnode)
    coeff = _t(p["coeff"])
    A_II = tds.assemble_dd_values_stencil(p["plan_t"], coeff)[0]
    L = tschur.factorize_interiors(A_II, p["plan_t"].imask)
    St, _, _ = tds.condense_dd_stencil(p["plan_t"], coeff)
    rng = np.random.default_rng(3)
    for shape in ((ndom, p["plan_t"].nI), (ndom, p["plan_t"].nI, 5)):
        rhs = _t(rng.normal(size=shape))
        mask = p["plan_t"].imask if len(shape) == 2 else \
            p["plan_t"].imask[:, :, None]
        rhs = rhs * mask
        x_bt = tschur.bt_interior_solve(St.Linv, St.G, rhs)
        x_de = tschur.interior_solve(L, rhs)
        assert x_bt.shape == rhs.shape
        _close(x_bt, x_de.numpy(), 1e-10)
    # and the factors themselves, from explicit D and E blocks
    hM, wM = p["plan_t"].hM, p["plan_t"].wM
    A5 = (A_II * p["plan_t"].imask[:, :, None] * p["plan_t"].imask[:, None, :]
          ).reshape(ndom, hM, wM, hM, wM)
    A5 = A5 + torch.diag_embed(1.0 - p["plan_t"].imask).reshape(
        ndom, hM, wM, hM, wM)
    D = torch.stack([A5[:, i, :, i, :] for i in range(hM)], dim=1)
    E = torch.stack([A5[:, i, :, min(i + 1, hM - 1), :] * (i + 1 < hM)
                     for i in range(hM)], dim=1)
    Linv, G = tschur.bt_factor_batched(D, E)
    _close(Linv, St.Linv.numpy(), 1e-12)
    _close(G, St.G.numpy(), 1e-12)


def test_condense_batch_axis_equals_single():
    p = build(6, 900)
    rng = np.random.default_rng(4)
    coeffs = _t(np.exp(rng.normal(size=(3, p["mesh"].nnode))))
    Sb, bsb, bIb = tds.condense_dd_stencil(p["plan_t"], coeffs)
    assert Sb.Linv.shape[0] == 3 and bsb.shape == (3, p["part_t"].n_gamma)
    Sdb = tschur.assemble_local_schurs(Sb)
    dense_b = tds.assemble_dd_values_stencil(p["plan_t"], coeffs)
    for c in range(3):
        S1, bs1, bI1 = tds.condense_dd_stencil(p["plan_t"], coeffs[c])
        tight = dict(rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(Sb.Linv[c].numpy(), S1.Linv.numpy(), **tight)
        np.testing.assert_allclose(Sb.A_IG[c].numpy(), S1.A_IG.numpy(), **tight)
        np.testing.assert_allclose(bsb[c].numpy(), bs1.numpy(), **tight)
        np.testing.assert_allclose(bIb[c].numpy(), bI1.numpy(), **tight)
        np.testing.assert_allclose(
            Sdb[c].numpy(), tschur.assemble_local_schurs(S1).numpy(), **tight)
        for a, b in zip(dense_b, tds.assemble_dd_values_stencil(
                p["plan_t"], coeffs[c])):
            np.testing.assert_allclose(a[c].numpy(), b.numpy(), **tight)


def test_stencil_dd_solution_matches_monolithic_solve():
    """The block-tridiagonal DD path end to end against the monolithic
    stencil solve of the same realization (tests/test_dd_stencil.py:73)."""
    p = build(6, 900)
    mesh, maps = p["mesh_t"], p["maps_t"]
    coeff = _t(p["coeff"])
    S, b_s, b_I = tds.condense_dd_stencil(p["plan_t"], coeff)
    M = tschur.prepare_neumann_neumann_schur_precond(S)
    r = pcg(S, b_s, M=M, maxit=500, rtol=1e-12)
    assert int(r.it) < 100
    u_I = tschur.get_subdomain_solutions(S, r.x, b_I)
    u_dd = tschur.merge_subdomain_solutions(p["part_t"], maps, mesh.points,
                                            u_dir, r.x, u_I)
    St, b = tfem.make_stencil_operator(p["plan_t"].splan, coeff)
    n = mesh.nnode
    A = torch.stack([St.matvec(e) for e in torch.eye(n, dtype=torch.float64)],
                    dim=1)
    u_full = torch.linalg.solve(A, b).numpy()
    dl = maps.dir_l2g
    u_full[dl] = u_dir(mesh.points[dl, 0], mesh.points[dl, 1])
    np.testing.assert_allclose(u_dd, u_full, rtol=1e-7, atol=1e-9)


def test_plan_dtype_handle():
    p = build(4, 400)
    assert p["plan_t"].kflat.dtype == torch.float64
    assert p["plan_t"].tables["sub"].shape == (4, 9, p["plan_t"].hE,
                                               p["plan_t"].wE)
