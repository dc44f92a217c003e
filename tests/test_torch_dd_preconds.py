"""PyTorch port, the full-system DD preconditioners (precond/dd_preconds.py:
LORASC exact and randomized with a dense or banded Γ solve, DDLR,
NN-induced) against the JAX package: float64 on the CPU, the same mesh,
partition and coefficient from a numpy seed through both packages
(tests/test_dd_preconds.py's sizes, 1200 nodes in 8 subdomains)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.dd import (assemble_dd_values, prepare_dd_assembly,
                                     set_subdomains)
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.partition import mesh_partition
from krylov_spdes_tpu.fem.schur import prepare_schur_operator
from krylov_spdes_tpu.precond import dd_preconds as jddp
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.fem import schur as tschur
from krylov_spdes_tpu_torch.precond import dd_preconds as tddp
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_dir(x, y):
    return 0.0 * x


def _setup(nnode, ndom, seed):
    """One realization through both packages: the JAX package's partition
    (its default partitioner) handed to the port's set_subdomains and
    prepare_dd_assembly, each package refilling its own blocks."""
    mesh = get_mesh(nnode, jitter=0.2, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    part_j = set_subdomains(mesh.cells, epart, maps, ndom)
    plan_j = prepare_dd_assembly(mesh.cells, mesh.points, epart, part_j, maps,
                                 f_src, u_dir)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                    u_dir)
    coeff = np.exp(np.random.default_rng(seed).normal(size=mesh.nnode))
    A, b = do_isotropic_elliptic_assembly(asm, coeff)
    blocks_j = assemble_dd_values(plan_j, jnp.asarray(coeff))
    Sj = prepare_schur_operator(plan_j, part_j, *blocks_j[:3])

    maps_t = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    part_t = tfem.set_subdomains(mesh.cells, epart, maps_t, ndom)
    plan_t = tfem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part_t,
                                      maps_t, f_src, u_dir, **CPU64)
    blocks_t = tfem.assemble_dd_values(
        plan_t, torch.as_tensor(coeff, dtype=torch.float64))
    St = tschur.prepare_schur_operator(plan_t, part_t, *blocks_t[:3])
    At = convert.sparse_op(**convert.numpy_fields(A), **CPU64)
    r = np.random.default_rng(seed + 1).normal(size=maps.n_free)
    return dict(maps=maps, part_j=part_j, plan_j=plan_j, A=A, b=np.asarray(b),
                blocks_j=blocks_j, Sj=Sj, maps_t=maps_t, part_t=part_t,
                plan_t=plan_t, blocks_t=blocks_t, St=St, At=At, r=r)


@pytest.fixture(scope="module")
def dd():
    return _setup(1200, 8, 10)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pcg_pair(p, Mj, Mt):
    rj = j_pcg(p["A"], jnp.asarray(p["b"]), M=Mj)
    rt = pcg(p["At"], torch.as_tensor(p["b"]), M=Mt)
    assert rt.history()[-1] <= 1e-7 * np.linalg.norm(p["b"])
    return int(rj.it), int(rt.it)


def test_gamma_matrices_and_tables_match_jax(dd):
    p = dd
    St, Sj = p["St"], p["Sj"]
    A_GG = tddp.assemble_gamma_matrix(St)
    np.testing.assert_allclose(A_GG.numpy(),
                               np.asarray(jddp.assemble_gamma_matrix(Sj)),
                               rtol=1e-12, atol=1e-14)
    g = p["maps"].free_g2l[p["part_j"].gamma_l2g]
    np.testing.assert_allclose(A_GG.numpy(),
                               np.asarray(p["A"].todense())[np.ix_(g, g)],
                               rtol=1e-10, atol=1e-12)
    Sg = tddp.assemble_global_schur_dense(St)
    np.testing.assert_allclose(
        Sg.numpy(), np.asarray(jddp.assemble_global_schur_dense(Sj)),
        rtol=1e-10, atol=1e-12)
    sp_t, sp_j = tddp.assemble_gamma_sparse(St), jddp.assemble_gamma_sparse(Sj)
    assert sp_t.nnz == sp_j.nnz
    np.testing.assert_allclose(sp_t.toarray(), sp_j.toarray(), rtol=1e-12,
                               atol=1e-14)
    ifree, gfree = tddp.free_dof_tables(p["part_t"], p["maps_t"])
    ifree_j, gfree_j = jddp.free_dof_tables(p["part_j"], p["maps"])
    np.testing.assert_array_equal(ifree.numpy(), np.asarray(ifree_j))
    np.testing.assert_array_equal(gfree.numpy(), np.asarray(gfree_j))
    # the padded slots carry the sentinel n_free, outside the free dofs
    pads = p["part_j"].interior_l2g < 0
    assert pads.any() and (ifree.numpy()[pads] == p["maps"].n_free).all()


def test_lorasc_exact_matches_jax(dd):
    """The port's apply against the JAX package's, on the port's own setup
    and on the JAX package's setup carried across (convert.lorasc_state):
    E·diag(Σ)·Eᵀ does not depend on the signs of the eigenvectors."""
    p = dd
    Mj = jddp.prepare_lorasc_precond(p["Sj"], p["part_j"], p["maps"],
                                     nvec=10, low_rank_correction="exact")
    Mt = tddp.prepare_lorasc_precond(p["St"], p["part_t"], p["maps_t"],
                                     nvec=10, low_rank_correction="exact")
    r = p["r"]
    zj = np.asarray(Mj(jnp.asarray(r)))
    assert _rel(Mt(torch.as_tensor(r)).numpy(), zj) <= 1e-10
    E, Sig, LG = Mj.args[-2], Mj.args[-1], Mj.args[-3].args[0]
    Mc = convert.lorasc_state(np.asarray(E), np.asarray(Sig), p["St"],
                              p["part_t"], p["maps_t"], np.asarray(LG))
    assert _rel(Mc(torch.as_tensor(r)).numpy(), zj) <= 1e-10
    # "auto" on the CPU (n_Γ < 2048) is the exact path
    Ma = tddp.prepare_lorasc_precond(p["St"], p["part_t"], p["maps_t"],
                                     nvec=10)
    np.testing.assert_array_equal(Ma(torch.as_tensor(r)).numpy(),
                                  Mt(torch.as_tensor(r)).numpy())
    it_j, it_t = _pcg_pair(p, Mj, Mt)
    assert abs(it_t - it_j) <= 1, (it_t, it_j)


def test_lorasc_randomized_matches_jax(dd):
    """The same start block H0 in both packages gives the same apply. With
    each package's own draw (PRNGKey(0), a seeded torch.Generator) PCG's
    counts stay within 10% of the same-H0 count. The randomized pairs at
    the default ell and q are much weaker than the exact ones in both
    packages (37 and 38 iterations against 21 here), so the exact path's
    count is no yardstick for them."""
    p = dd
    part = p["part_j"]
    ell = int(part.ndom + 0.1 * p["Sj"].n_gamma)
    key = jax.random.PRNGKey(0)        # the JAX package's default draw
    H0 = np.asarray(jax.random.normal(key, (p["Sj"].n_gamma, ell),
                                      jnp.float64))
    kw = dict(nvec=10, low_rank_correction="randomized")
    Mj = jddp.prepare_lorasc_precond(p["Sj"], part, p["maps"], key=key, **kw)
    Mt = tddp.prepare_lorasc_precond(p["St"], p["part_t"], p["maps_t"],
                                     H0=H0, **kw)
    r = p["r"]
    assert _rel(Mt(torch.as_tensor(r)).numpy(),
                np.asarray(Mj(jnp.asarray(r)))) <= 1e-8
    it_j, it_h0 = _pcg_pair(p, Mj, Mt)
    assert abs(it_h0 - it_j) <= 1, (it_h0, it_j)
    M_own = tddp.prepare_lorasc_precond(
        p["St"], p["part_t"], p["maps_t"],
        generator=torch.Generator().manual_seed(0), **kw)
    Mj_own = jddp.prepare_lorasc_precond(p["Sj"], part, p["maps"],
                                         key=jax.random.PRNGKey(1), **kw)
    it_j_own, it_t_own = _pcg_pair(p, Mj_own, M_own)
    for it in (it_j_own, it_t_own):
        assert abs(it - it_h0) <= 0.1 * it_h0, (it_j_own, it_t_own, it_h0)


@pytest.mark.parametrize("gamma_solver", ["dense", "banded"])
def test_lorasc_without_correction_matches_jax(dd, gamma_solver):
    p = dd
    Mj = jddp.prepare_lorasc_precond(p["Sj"], p["part_j"], p["maps"],
                                     eps_threshold=0.0,
                                     gamma_solver=gamma_solver)
    Mt = tddp.prepare_lorasc_precond(p["St"], p["part_t"], p["maps_t"],
                                     eps_threshold=0.0,
                                     gamma_solver=gamma_solver)
    r = p["r"]
    assert _rel(Mt(torch.as_tensor(r)).numpy(),
                np.asarray(Mj(jnp.asarray(r)))) <= 1e-10
    it_j, it_t = _pcg_pair(p, Mj, Mt)
    assert abs(it_t - it_j) <= 1, (it_t, it_j)


def test_ddlr_matches_jax():
    """At tests/test_dd_preconds.py's DDLR configuration (800 nodes, 6
    subdomains). The preconditioner is not symmetric and its PCG count
    moves with the last bits of b in either package (193-195 here), so the
    port's count on b is held to the range of the JAX package's counts on b
    and on four last-bit copies of b, widened by one."""
    p = _setup(800, 6, 13)
    Mj = jddp.prepare_ddlr_precond(p["Sj"], p["part_j"], p["maps"],
                                   p["blocks_j"][0], p["plan_j"].imask,
                                   nvec=15)
    Mt = tddp.prepare_ddlr_precond(p["St"], p["part_t"], p["maps_t"],
                                   p["blocks_t"][0], p["plan_t"].imask,
                                   nvec=15)
    r = p["r"]
    assert _rel(Mt(torch.as_tensor(r)).numpy(),
                np.asarray(Mj(jnp.asarray(r)))) <= 1e-10
    b = p["b"]
    its_j = []
    for k in range(5):
        bk = b.copy()
        if k:
            bk[np.random.default_rng(k).integers(0, b.size, 5)] *= 1 + 2.2e-16
        its_j.append(int(j_pcg(p["A"], jnp.asarray(bk), M=Mj).it))
    rt = pcg(p["At"], torch.as_tensor(b), M=Mt)
    assert rt.history()[-1] <= 1e-7 * np.linalg.norm(b)
    assert min(its_j) - 1 <= int(rt.it) <= max(its_j) + 1, (int(rt.it), its_j)


def test_nn_induced_matches_jax_and_formula(dd):
    """Against the JAX apply and a direct transcription of
    apply_neumann_neumann_induced (reference :2383-2440), as
    tests/test_dd_preconds.py checks the JAX package."""
    p = dd
    part, maps = p["part_j"], p["maps"]
    Mj = jddp.prepare_nn_induced_precond(p["Sj"], part, maps)
    Mt = tddp.prepare_nn_induced_precond(p["St"], p["part_t"], p["maps_t"])
    r = p["r"]
    zt = Mt(torch.as_tensor(r)).numpy()
    assert _rel(zt, np.asarray(Mj(jnp.asarray(r)))) <= 1e-10
    Sd = tschur.assemble_local_schurs(p["St"]).numpy()
    AII = p["blocks_t"][0].numpy()
    AIG = p["St"].A_IG.numpy()
    z = np.zeros(maps.n_free)
    gidx = maps.free_g2l[part.gamma_l2g]
    r_s = r[gidx].copy()
    for d in range(part.ndom):
        nI, nG = int(part.n_interior[d]), int(part.n_gammad[d])
        ifree = maps.free_g2l[part.interior_l2g[d, :nI]]
        r_s[part.gammad_to_gamma[d, :nG]] -= AIG[d, :nI, :nG].T @ \
            np.linalg.solve(AII[d, :nI, :nI], r[ifree])
    z_G = np.zeros(part.n_gamma)
    for d in range(part.ndom):
        nI, nG = int(part.n_interior[d]), int(part.n_gammad[d])
        gl = part.gammad_to_gamma[d, :nG]
        Pin = np.linalg.pinv(Sd[d, :nG, :nG],
                             rcond=np.sqrt(np.finfo(float).eps))
        zd = Pin @ (r_s[gl] / part.gamma_cnt[gl])
        z_G[gl] += zd / part.gamma_cnt[gl]
        ifree = maps.free_g2l[part.interior_l2g[d, :nI]]
        z[ifree] = np.linalg.solve(AII[d, :nI, :nI],
                                   r[ifree] - AIG[d, :nI, :nG] @ zd)
    z[gidx] = z_G
    np.testing.assert_allclose(zt, z, rtol=1e-10, atol=1e-12)
