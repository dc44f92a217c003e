"""PyTorch port, unstructured (Delaunay) meshes through the general path
against the JAX package: the mesh, its area, the assembly, the whole DD
pipeline, the KL and the mesh NPZ (tests/test_unstructured.py's cases),
float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem import mesh as jmesh
from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           get_mass_matrix,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.dd import (assemble_dd_values, prepare_dd_assembly,
                                     set_subdomains)
from krylov_spdes_tpu.fem.partition import mesh_partition
from krylov_spdes_tpu.fem.schur import (get_schur_rhs,
                                        prepare_neumann_neumann_schur_precond,
                                        prepare_schur_operator)
from krylov_spdes_tpu.kl.covariance import make_cov
from krylov_spdes_tpu.kl.single import solve_kl
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import fem, kl
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.solvers import cg, pcg

import oracle

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def fsrc(x, y):
    return -1.0 + 0.0 * x


def uex(x, y):
    return 0.0 * x


@pytest.mark.parametrize("nn,seed", [(500, 1), (220, 2), (3000, 0)])
def test_delaunay_mesh_equals_jax(nn, seed):
    """The same (tentative_nnode, seed): points, cells, markers and
    neighbours equal to the JAX package's exactly (both run
    scipy.spatial.Delaunay on the same points); area 1 to 1e-9; neighbour
    symmetry."""
    mj = jmesh.get_delaunay_mesh(nn, seed=seed)
    mt = fem.get_delaunay_mesh(nn, seed=seed)
    for f in ("cells", "points", "point_markers", "cell_neighbors"):
        a, b = getattr(mt, f), getattr(mj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert abs(fem.get_total_area(mt.cells, mt.points) - 1.0) < 1e-9
    assert fem.get_total_area(mt.cells, mt.points) == \
        jmesh.get_total_area(mj.cells, mj.points)
    nb = mt.cell_neighbors
    for e in range(0, mt.nel, 7):
        for k in range(3):
            if nb[e, k] >= 0:
                assert e in nb[nb[e, k]]


def test_mesh_npz_cross_loads(tmp_path):
    """A mesh NPZ saved by either package loads in the other, array for
    array (dtype included)."""
    mt = fem.get_delaunay_mesh(300, seed=5)
    fem.save_mesh(mt, 300, data_dir=str(tmp_path / "t"))
    mj = jmesh.load_mesh(300, data_dir=str(tmp_path / "t"))
    jmesh.save_mesh(mj, 301, data_dir=str(tmp_path / "j"))
    back = fem.load_mesh(301, data_dir=str(tmp_path / "j"))
    for f in ("cells", "points", "point_markers", "cell_neighbors"):
        for other in (mj, back):
            a, b = getattr(mt, f), getattr(other, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, f)


def test_delaunay_assembly_matches_jax_and_oracle():
    """The assembled matrix and right-hand side against the JAX package's
    and the NumPy oracle (rtol 1e-11, tests/test_unstructured.py's)."""
    mesh = fem.get_delaunay_mesh(220, seed=2)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    coeff = np.exp(np.random.default_rng(0).normal(size=mesh.nnode))
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, fsrc,
                                        uex, **CPU64)
    A, b = fem.do_isotropic_elliptic_assembly(asm, coeff)
    A_ref, b_ref, _ = oracle.assemble_elliptic(
        mesh.cells, mesh.points, mesh.point_markers, coeff, fsrc, uex)
    Aj, bj = do_isotropic_elliptic_assembly(
        prepare_elliptic_assembly(mesh.cells, mesh.points,
                                  get_dirichlet_inds(mesh.points,
                                                     mesh.point_markers),
                                  fsrc, uex), coeff)
    for Ar, br in ((A_ref.toarray(), b_ref),
                   (np.asarray(Aj.todense()), np.asarray(bj))):
        np.testing.assert_allclose(A.todense().numpy(), Ar, rtol=1e-11,
                                   atol=1e-13)
        np.testing.assert_allclose(b.numpy(), br, rtol=1e-11, atol=1e-13)


def test_delaunay_full_dd_pipeline():
    """Partition, DD assembly, condensation, NN-PCG on Γ, back-substitution
    and merge on a Delaunay mesh: the merged solution against the monolithic
    CG solve (rtol 1e-6, tests/test_unstructured.py's), and the Γ solve's
    `it` and x against the JAX package's (within 1 and 1e-8)."""
    mesh = fem.get_delaunay_mesh(700, seed=3)
    maps = fem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    ndom = 6
    epart, _ = fem.mesh_partition(mesh.cells, mesh.points, ndom,
                                  mesh.cell_neighbors)
    part = fem.set_subdomains(mesh.cells, epart, maps, ndom)
    plan = fem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part, maps,
                                   fsrc, uex, **CPU64)
    asm = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, fsrc,
                                        uex, **CPU64)
    coeff = np.exp(np.random.default_rng(1).normal(size=mesh.nnode))

    A, b = fem.do_isotropic_elliptic_assembly(asm, coeff)
    u_mono = np.zeros(mesh.nnode)
    u_mono[maps.free_l2g] = cg(A, b, rtol=1e-11).x.numpy()

    blocks = fem.assemble_dd_values(plan, torch.as_tensor(coeff))
    S = tschur.prepare_schur_operator(plan, part, *blocks[:3])
    b_s = tschur.get_schur_rhs(S, blocks[3], blocks[4])
    r = pcg(S, b_s, M=tschur.prepare_neumann_neumann_schur_precond(S),
            rtol=1e-11)
    u_I = tschur.get_subdomain_solutions(S, r.x, blocks[3])
    u = tschur.merge_subdomain_solutions(part, maps, mesh.points, uex, r.x,
                                         u_I)
    np.testing.assert_allclose(u, u_mono, rtol=1e-6, atol=1e-8)

    # the JAX package on the same mesh and partition
    mapj = get_dirichlet_inds(mesh.points, mesh.point_markers)
    epj, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                            mesh.cell_neighbors)
    np.testing.assert_array_equal(epart, epj)
    partj = set_subdomains(mesh.cells, epj, mapj, ndom)
    planj = prepare_dd_assembly(mesh.cells, mesh.points, epj, partj, mapj,
                                fsrc, uex)
    bj = assemble_dd_values(planj, jnp.asarray(coeff))
    Sj = prepare_schur_operator(planj, partj, *bj[:3])
    rj = j_pcg(Sj, get_schur_rhs(Sj, bj[3], bj[4]),
               M=prepare_neumann_neumann_schur_precond(Sj), rtol=1e-11)
    assert abs(int(r.it) - int(rj.it)) <= 1, (int(r.it), int(rj.it))
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-10)


def test_delaunay_kl_matches_jax():
    """The dense KL on a Delaunay mesh: M-orthonormal modes (atol 1e-8,
    tests/test_unstructured.py's), the same kept count and λ within 1e-9 of
    the JAX package's."""
    mesh = fem.get_delaunay_mesh(400, seed=4)
    M = fem.get_mass_matrix(mesh.cells, mesh.points, **CPU64)
    lam, psi = kl.solve_kl(mesh.cells, mesh.points, kl.make_cov("sexp", 1.0,
                                                                0.5),
                           12, M, relative=0.99, method="dense")
    Md = M.todense().numpy()
    np.testing.assert_allclose(psi.T @ Md @ psi, np.eye(len(lam)), atol=1e-8)
    lam_j, _ = solve_kl(mesh.cells, mesh.points, make_cov("sexp", 1.0, 0.5),
                        12, get_mass_matrix(mesh.cells, mesh.points),
                        relative=0.99, method="dense")
    assert lam.shape == np.asarray(lam_j).shape
    np.testing.assert_allclose(lam, np.asarray(lam_j), rtol=1e-9)
