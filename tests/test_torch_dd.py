"""PyTorch port, the domain-decomposition layer (fem/partition.py,
fem/native.py, fem/dd.py, fem/schur.py) against the JAX package. float64 on
the CPU, the same mesh, partition and coefficient from a numpy seed through
both packages; plans are carried across by convert.py where the test says
so."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem import dd as jdd
from krylov_spdes_tpu.fem import partition as jpart
from krylov_spdes_tpu.fem import schur as jschur
from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.fem import dd as tdd
from krylov_spdes_tpu_torch.fem import native as tnative
from krylov_spdes_tpu_torch.fem import partition as tpart
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
NNODE, NDOM = 420, 8


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_dir(x, y):
    return 0.1 * x + 0.05 * y


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _assert_fields_equal(a, b, skip=()):
    """Every field of two dataclasses (numpy side by side): index tables
    and static fields equal, float values to rtol 1e-13."""
    fa, fb = convert.numpy_fields(a), convert.numpy_fields(b)
    for k, va in fa.items():
        if k in skip or k not in fb:
            continue
        vb = fb[k]
        if isinstance(va, np.ndarray) and va.dtype.kind == "f":
            np.testing.assert_allclose(vb, va, rtol=1e-13, atol=0, err_msg=k)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(vb, va, err_msg=k)
        else:
            assert va == vb, k


@pytest.fixture(scope="module", params=[True, False],
                ids=["native", "numpy"])
def problem(request):
    """One mesh through both packages, partitioned by the C++ partitioner
    or by the NumPy one; the flag is passed explicitly on both sides."""
    use_native = request.param
    mesh = get_mesh(NNODE, jitter=0.2, seed=3)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart_j, npart_j = jpart.mesh_partition(
        mesh.cells, mesh.points, NDOM, mesh.cell_neighbors,
        use_native=use_native)
    part_j = jdd.set_subdomains(mesh.cells, epart_j, maps, NDOM)
    plan_j = jdd.prepare_dd_assembly(mesh.cells, mesh.points, epart_j, part_j,
                                     maps, f_src, u_dir)

    mesh_t = tfem.get_mesh(NNODE, jitter=0.2, seed=3)
    maps_t = tfem.get_dirichlet_inds(mesh_t.points, mesh_t.point_markers)
    epart_t, npart_t = tpart.mesh_partition(
        mesh_t.cells, mesh_t.points, NDOM, mesh_t.cell_neighbors,
        use_native=use_native)
    part_t = tdd.set_subdomains(mesh_t.cells, epart_t, maps_t, NDOM)
    plan_t = tdd.prepare_dd_assembly(mesh_t.cells, mesh_t.points, epart_t,
                                     part_t, maps_t, f_src, u_dir, **CPU64)
    coeff = np.exp(np.random.default_rng(0).normal(size=mesh.nnode))
    return dict(mesh=mesh, maps=maps, epart_j=epart_j, npart_j=npart_j,
                part_j=part_j, plan_j=plan_j, mesh_t=mesh_t, maps_t=maps_t,
                epart_t=epart_t, npart_t=npart_t, part_t=part_t,
                plan_t=plan_t, coeff=coeff, use_native=use_native)


@pytest.fixture(scope="module")
def operators(problem):
    """The Schur operators of one realization on both sides."""
    p = problem
    bj = jdd.assemble_dd_values(p["plan_j"], jnp.asarray(p["coeff"]))
    Sj = jschur.prepare_schur_operator(p["plan_j"], p["part_j"], *bj[:3])
    bt = tdd.assemble_dd_values(p["plan_t"], _t(p["coeff"]))
    St = tschur.prepare_schur_operator(p["plan_t"], p["part_t"], *bt[:3])
    return bj, Sj, bt, St


def test_partition_equal(problem):
    """The same partitioner gives the same partition in both packages (the
    C++ one compiled from the same source with the same flags)."""
    np.testing.assert_array_equal(problem["epart_t"], problem["epart_j"])
    np.testing.assert_array_equal(problem["npart_t"], problem["npart_j"])
    assert np.bincount(problem["epart_t"], minlength=NDOM).min() > 0


def test_native_and_numpy_partitions_differ():
    """Why `use_native=True` must not quietly give the NumPy partition."""
    mesh = tfem.get_mesh(NNODE, jitter=0.2, seed=3)
    a, _ = tpart.mesh_partition(mesh.cells, mesh.points, NDOM,
                                mesh.cell_neighbors, use_native=True)
    b, _ = tpart.mesh_partition(mesh.cells, mesh.points, NDOM,
                                mesh.cell_neighbors, use_native=False)
    assert (a != b).any()


def test_native_partition_raises_without_its_library(monkeypatch, tmp_path):
    mesh = tfem.get_mesh(100)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError):
        tpart.mesh_partition(mesh.cells, mesh.points, 4, mesh.cell_neighbors,
                             use_native=True)
    # the NumPy path needs no library
    epart, _ = tpart.mesh_partition(mesh.cells, mesh.points, 4,
                                    mesh.cell_neighbors, use_native=False)
    assert set(epart.tolist()) == {0, 1, 2, 3}


def test_native_library_is_built_under_build():
    mesh = tfem.get_mesh(100)
    _, cut = tnative.native_partition(mesh.cell_neighbors,
                                      mesh.points[mesh.cells].mean(axis=1), 4)
    assert cut > 0
    so = tnative.library_path()
    assert so.exists() and so.parent.name == "native"
    assert so.parent.parent.name == "build"


def test_saved_partition_is_read_by_both_packages(problem, tmp_path):
    """save_partition writes the JAX package's file (name and keys)."""
    p, d = problem, str(tmp_path)
    tpart.save_partition(p["epart_t"], p["npart_t"], NNODE, NDOM, data_dir=d)
    for load in (tpart.load_partition, jpart.load_partition):
        epart, npart = load(NNODE, NDOM, data_dir=d)
        np.testing.assert_array_equal(epart, p["epart_j"])
        np.testing.assert_array_equal(npart, p["npart_j"])


def test_set_subdomains_tables_equal(problem):
    _assert_fields_equal(problem["part_j"], problem["part_t"])
    carried = convert.dd_partition(**convert.numpy_fields(problem["part_j"]))
    _assert_fields_equal(problem["part_j"], carried)


def test_get_partition_matches(problem):
    p = problem
    epart, npart, part = tdd.get_partition(
        p["mesh_t"].cells, p["mesh_t"].points, p["mesh_t"].cell_neighbors,
        p["maps_t"], NDOM, use_native=p["use_native"])
    np.testing.assert_array_equal(epart, p["epart_j"])
    _assert_fields_equal(p["part_j"], part)


def test_set_subdomains_needs_two_domains(problem):
    p = problem
    with pytest.raises(ValueError):
        tdd.set_subdomains(p["mesh_t"].cells, np.zeros_like(p["epart_t"]),
                           p["maps_t"], 1)


def test_prepare_dd_assembly_plan_equal(problem):
    """Index tables equal, geometry factors to rtol 1e-13 (the same numpy
    expressions on the same mesh)."""
    _assert_fields_equal(problem["plan_j"], problem["plan_t"])


@pytest.mark.parametrize("carried", [False, True], ids=["own", "converted"])
def test_refilled_blocks_match(problem, carried):
    """A_II, A_IΓ, A_ΓΓd, b_I, b_Γ to rtol 1e-13 (atol 1e-13 of the largest
    entry: both sum the same contributions per entry, in orders that may
    differ), from the port's own plan and from the JAX plan carried across
    field by field."""
    p = problem
    plan_t = (convert.dd_assembly_plan(**convert.numpy_fields(p["plan_j"]),
                                       **CPU64) if carried else p["plan_t"])
    bj = jdd.assemble_dd_values(p["plan_j"], jnp.asarray(p["coeff"]))
    bt = tdd.assemble_dd_values(plan_t, _t(p["coeff"]))
    for a, b in zip(bt, bj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-13,
                                   atol=1e-13 * np.abs(b).max())


def test_refill_batch_axis_equals_single_refills(problem):
    p = problem
    rng = np.random.default_rng(5)
    coeffs = _t(np.exp(rng.normal(size=(3, p["mesh"].nnode))))
    batched = tdd.assemble_dd_values(p["plan_t"], coeffs)
    for c in range(3):
        single = tdd.assemble_dd_values(p["plan_t"], coeffs[c])
        for a, b in zip(batched, single):
            assert torch.equal(a[c], b)


def test_ordered_scatter_equals_index_add():
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(rng.integers(0, 37, size=500))
    vals = _t(rng.normal(size=500))
    sc = tdd.OrderedScatter.of(idx, 40)
    ref = torch.zeros(40, dtype=torch.float64).index_add_(0, idx, vals)
    np.testing.assert_allclose(sc.sum(vals).numpy(), ref.numpy(), rtol=1e-13,
                               atol=1e-14)
    empty = tdd.OrderedScatter.of(idx[:0], 5)
    assert torch.equal(empty.sum(vals[:0]), torch.zeros(5, dtype=torch.float64))


def test_gamma_sum_equals_scatter_add(problem, operators):
    """The fixed-order Γ sum is the scatter-add of the JAX package."""
    _, _, _, St = operators
    rng = np.random.default_rng(3)
    vals = _t(rng.normal(size=tuple(St.gmask.shape))) * St.gmask
    ref = torch.zeros(St.n_gamma, dtype=torch.float64).index_add_(
        0, St.gammad_to_gamma.reshape(-1), vals.reshape(-1))
    out = tschur.gamma_sum(St.gamma_gather, vals)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-13,
                               atol=1e-14)
    # every Γ node is owned by gamma_cnt subdomains
    owners = (St.gamma_gather < St.gmask.numel()).sum(dim=1)
    np.testing.assert_array_equal(owners.numpy(), problem["part_t"].gamma_cnt)


def test_interior_factors_match(operators):
    """Cholesky factors are unique: rtol 1e-10 (conditioning of A_II)."""
    _, Sj, _, St = operators
    L = np.asarray(Sj.A_II_L)
    np.testing.assert_allclose(St.A_II_L.numpy(), L, rtol=1e-10,
                               atol=1e-12 * np.abs(L).max())


def test_schur_matvec_matches(problem, operators):
    """S x to 1e-10 of its size: three products and a Cholesky solve pair
    over nI ~ 40 interior nodes."""
    _, Sj, _, St = operators
    x = np.random.default_rng(1).normal(size=problem["part_j"].n_gamma)
    yj = np.asarray(jschur.schur_matvec(Sj, jnp.asarray(x)))
    yt = St.matvec(_t(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-10 * np.abs(yj).max())
    assert St.shape == (St.n_gamma, St.n_gamma)
    np.testing.assert_array_equal(St.as_partial_op()(_t(x)).numpy(), yt)


def test_schur_rhs_matches(operators):
    bj, Sj, bt, St = operators
    bsj = np.asarray(jschur.get_schur_rhs(Sj, bj[3], bj[4]))
    bst = tschur.get_schur_rhs(St, bt[3], bt[4]).numpy()
    np.testing.assert_allclose(bst, bsj, rtol=1e-10,
                               atol=1e-10 * np.abs(bsj).max())


def test_local_schurs_and_assembled_apply_match(problem, operators):
    _, Sj, _, St = operators
    Sdj = np.asarray(jschur.assemble_local_schurs(Sj))
    Sdt = tschur.assemble_local_schurs(St)
    np.testing.assert_allclose(Sdt.numpy(), Sdj, rtol=1e-10,
                               atol=1e-10 * np.abs(Sdj).max())
    x = np.random.default_rng(4).normal(size=St.n_gamma)
    A_t = tschur.assembled_schur_operator(St, Sd=Sdt)
    A_j = jschur.assembled_schur_operator(Sj)
    yj = np.asarray(A_j(jnp.asarray(x)))
    np.testing.assert_allclose(A_t(_t(x)).numpy(), yj, rtol=1e-10,
                               atol=1e-10 * np.abs(yj).max())
    # the assembled apply is the matrix-free one
    np.testing.assert_allclose(A_t(_t(x)).numpy(), St.matvec(_t(x)).numpy(),
                               rtol=1e-9, atol=1e-10 * np.abs(yj).max())


def test_masked_pinv_matches(operators, capsys):
    """The pinv, not its eigenvectors (LAPACK through XLA and through torch
    differ in sign and in rotations inside clusters): 1e-8 of its norm
    (the pinv amplifies the 1e-10 of Sd by its condition). The count of
    kept eigenvalues per subdomain is the same on both sides."""
    _, Sj, _, St = operators
    Sdj = jschur.assemble_local_schurs(Sj)
    Pj = np.asarray(jschur._masked_pinv(Sdj, Sj.gmask))
    Pt, kept_t = tschur._masked_pinv(tschur.assemble_local_schurs(St),
                                     St.gmask, return_kept=True)
    lam = np.linalg.eigvalsh(np.asarray(Sdj))
    tol = np.sqrt(np.finfo(np.float64).eps) * np.abs(lam).max(
        axis=-1, keepdims=True)
    kept_j = (lam > tol).sum(axis=-1)
    with capsys.disabled():
        print(f"\nkept eigenvalues per subdomain: jax {kept_j.tolist()} "
              f"torch {kept_t.tolist()} of n_gammad "
              f"{St.gmask.sum(dim=1).int().tolist()}")
    np.testing.assert_array_equal(kept_t.numpy(), kept_j)
    for d in range(Pj.shape[0]):
        np.testing.assert_allclose(Pt[d].numpy(), Pj[d], rtol=0,
                                   atol=1e-8 * np.linalg.norm(Pj[d], 2))


def test_nn_apply_matches(operators):
    _, Sj, _, St = operators
    r = np.random.default_rng(6).normal(size=St.n_gamma)
    zj = np.asarray(jschur.prepare_neumann_neumann_schur_precond(Sj)(
        jnp.asarray(r)))
    zt = tschur.prepare_neumann_neumann_schur_precond(St)(_t(r)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=1e-8, atol=1e-8 * np.abs(zj).max())


def test_batch_axis_of_the_condensation(problem, operators):
    """(B, ndom, ...) blocks through factorisation, local Schurs, pinv and
    both applies give each chain's unbatched result."""
    p = problem
    rng = np.random.default_rng(7)
    coeffs = _t(np.exp(rng.normal(size=(2, p["mesh"].nnode))))
    b = tdd.assemble_dd_values(p["plan_t"], coeffs)
    S = tschur.prepare_schur_operator(p["plan_t"], p["part_t"], *b[:3])
    bs = tschur.get_schur_rhs(S, b[3], b[4])
    Sd = tschur.assemble_local_schurs(S)
    Pi = tschur._masked_pinv(Sd, S.gmask)
    x = _t(rng.normal(size=(2, S.n_gamma)))
    y = tschur._schur_matvec_assembled(Sd, S.gammad_to_gamma, S.gmask,
                                       S.gamma_gather, x)
    z = tschur._nn_apply(Pi, S.gammad_to_gamma, S.gmask, S.gamma_gather,
                         1.0 / S.gamma_cnt, x)
    for c in range(2):
        b1 = tdd.assemble_dd_values(p["plan_t"], coeffs[c])
        S1 = tschur.prepare_schur_operator(p["plan_t"], p["part_t"], *b1[:3])
        Sd1 = tschur.assemble_local_schurs(S1)
        tight = dict(rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(
            bs[c].numpy(), tschur.get_schur_rhs(S1, b1[3], b1[4]).numpy(),
            **tight)
        np.testing.assert_allclose(Sd[c].numpy(), Sd1.numpy(), **tight)
        np.testing.assert_allclose(
            y[c].numpy(), tschur.assembled_schur_operator(S1, Sd1)(x[c]).numpy(),
            **tight)
        np.testing.assert_allclose(
            z[c].numpy(),
            tschur.prepare_neumann_neumann_schur_precond(S1, Sd1)(x[c]).numpy(),
            rtol=1e-9, atol=1e-11)


def test_failed_factorisation_gives_nans_not_an_exception():
    """An indefinite interior block: the JAX package's Cholesky returns NaNs
    that the solver reports as failed; so does the port's."""
    A = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    A[1, 1, 1] = -1.0
    L = tschur.factorize_interiors(A, torch.ones(2, 3, dtype=torch.float64))
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).all()


def test_schur_operator_carried_across(operators):
    _, Sj, _, St = operators
    carried = convert.schur_operator(**convert.numpy_fields(Sj), **CPU64)
    assert isinstance(carried, tschur.SchurOperator)
    x = _t(np.random.default_rng(8).normal(size=St.n_gamma))
    np.testing.assert_allclose(carried.matvec(x).numpy(),
                               St.matvec(x).numpy(), rtol=1e-10, atol=1e-12)


def test_domain_decompose_rhs_matches(problem):
    p = problem
    b = np.random.default_rng(9).normal(size=p["maps"].n_free)
    bIj, bGj = jdd.domain_decompose_rhs(p["part_j"], p["maps"], b)
    bIt, bGt = tdd.domain_decompose_rhs(p["part_t"], p["maps_t"], _t(b))
    np.testing.assert_array_equal(bIt.numpy(), np.asarray(bIj))
    np.testing.assert_array_equal(bGt.numpy(), np.asarray(bGj))


def test_dd_solution_matches_monolithic_solve(problem, operators):
    """Canonical drive 3 in the port's names: NN-preconditioned PCG on the
    interface, back-substitution, merge; against the dense solve of the
    monolithic system of the same realization (rtol 1e-7 of the solve)."""
    p = problem
    _, _, bt, St = operators
    b_s = tschur.get_schur_rhs(St, bt[3], bt[4])
    M = tschur.prepare_neumann_neumann_schur_precond(St)
    r = pcg(St, b_s, M=M, maxit=500, rtol=1e-12)
    assert int(r.it) < 100
    u_I = tschur.get_subdomain_solutions(St, r.x, bt[3])
    u_dd = tschur.merge_subdomain_solutions(p["part_t"], p["maps_t"],
                                            p["mesh_t"].points, u_dir, r.x,
                                            u_I)
    asm = prepare_elliptic_assembly(p["mesh"].cells, p["mesh"].points,
                                    p["maps"], f_src, u_dir)
    A, b = do_isotropic_elliptic_assembly(asm, jnp.asarray(p["coeff"]))
    u_full = np.zeros(p["mesh"].nnode)
    u_full[p["maps"].free_l2g] = np.linalg.solve(np.asarray(A.todense()),
                                                 np.asarray(b))
    dl = p["maps"].dir_l2g
    u_full[dl] = u_dir(p["mesh"].points[dl, 0], p["mesh"].points[dl, 1])
    np.testing.assert_allclose(u_dd, u_full, rtol=1e-7, atol=1e-9)


def test_do_condensed_assembly_matches(problem):
    p = problem
    op_t, bs_t, S_t, bI_t = tschur.do_condensed_assembly(
        p["plan_t"], p["part_t"], p["coeff"])
    op_j, bs_j, S_j, bI_j = jschur.do_condensed_assembly(
        p["plan_j"], p["part_j"], jnp.asarray(p["coeff"]))
    np.testing.assert_allclose(bs_t.numpy(), np.asarray(bs_j), rtol=1e-10,
                               atol=1e-12)
    x = np.random.default_rng(10).normal(size=p["part_j"].n_gamma)
    yj = np.asarray(op_j(jnp.asarray(x)))
    np.testing.assert_allclose(op_t(_t(x)).numpy(), yj, rtol=1e-10,
                               atol=1e-10 * np.abs(yj).max())
