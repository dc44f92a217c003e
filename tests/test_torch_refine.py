"""PyTorch port, df32 arithmetic and the certified refined PCG
(ops/df32.py, solvers/refine.py) against numpy float64 and the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops import df32 as jdf
from krylov_spdes_tpu.ops import stencil as jst
from krylov_spdes_tpu.solvers.refine import refined_pcg as j_refined_pcg

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import df32 as tdf
from krylov_spdes_tpu_torch.solvers.cg import pcg
from krylov_spdes_tpu_torch.solvers.refine import refined_pcg

torch.set_num_threads(1)


def test_error_free_transforms():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) *
         10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    b = (rng.normal(size=4096) *
         10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    s, e = tdf.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  exact)
    p, pe = tdf.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(p.double().numpy() + pe.double().numpy(),
                               a.astype(np.float64) * b.astype(np.float64),
                               rtol=1e-14, atol=0)
    # df_add of a pair and a float32 value carries the sum to ~eps²
    h, lo = tdf.df_add(*tdf.df_from(torch.as_tensor(a)), torch.as_tensor(b),
                       torch.zeros(4096))
    np.testing.assert_allclose(h.double().numpy() + lo.double().numpy(),
                               exact, rtol=1e-13, atol=0)
    # eager torch on the CPU rounds every float32 op: the transforms hold
    assert tdf.strict_f32_rounding("cpu")


def _system(nn, dtype, seed=2, rough=1.2):
    mesh = get_mesh(nn, jitter=0.15, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rough * rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    St64 = jst.build_stencil_op(A, maps, (m1, m1))
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    planes = np.asarray(St64.planes).astype(np_dt)
    dd = np.asarray(St64.dir_diag).astype(np_dt)
    bf = np.asarray(jst.to_full_vector(maps, b, mesh.nnode)).astype(np_dt)
    Sj = jst.StencilOp(planes=jnp.asarray(planes), dir_diag=jnp.asarray(dd),
                       slot=jnp.zeros((0,), jnp.int32), H=m1, W=m1)
    St = convert.stencil_op(planes, dd, np.zeros(0), m1, m1, device="cpu",
                            dtype=dtype)
    return Sj, St, bf


def _true_residual(St, bf, x64):
    """b − A x in float64 from the operator's own (exactly widened) values."""
    St64 = convert.stencil_op(St.planes.numpy(), St.dir_diag.numpy(),
                              np.zeros(0), St.H, St.W, device="cpu",
                              dtype=torch.float64)
    Ax = St64.matvec(torch.as_tensor(x64)).numpy()
    return np.linalg.norm(bf.astype(np.float64) - Ax)


def test_residual_matches_jax_f64_path():
    Sj, St, bf = _system(900, torch.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=St.H * St.W).astype(np.float32)
    xl = (rng.normal(size=x.size) * 1e-8).astype(np.float32)
    zero = np.zeros_like(bf)
    rh_j, rl_j = jdf.stencil_residual_df32(Sj.planes, Sj.dir_diag, Sj.H, Sj.W,
                                           jnp.asarray(bf), jnp.asarray(zero),
                                           jnp.asarray(x), jnp.asarray(xl))
    t = torch.as_tensor
    rh_t, rl_t = tdf.stencil_residual_df32(St.planes, St.dir_diag, St.H, St.W,
                                           t(bf), t(zero), t(x), t(xl))
    assert rh_t.dtype == torch.float32
    got = rh_t.double().numpy() + rl_t.double().numpy()
    want = np.asarray(rh_j, np.float64) + np.asarray(rl_j, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-13 * scale


def test_refined_pcg_matches_jax_f64():
    Sj, St, bf = _system(1600, torch.float64, rough=0.3)
    dinv_j = 1.0 / Sj.diagonal()
    rj = j_refined_pcg(Sj, jnp.asarray(bf),
                       M=Partial(lambda d, r: d * r, dinv_j), rtol=1e-7,
                       inner_rtol=1e-5)
    dinv_t = 1.0 / St.diagonal()
    rt = refined_pcg(St, torch.as_tensor(bf), M=lambda r: dinv_t * r,
                     rtol=1e-7, inner_rtol=1e-5)
    bnorm = np.linalg.norm(bf)
    assert float(rt.res_norm[0]) <= 1e-7 * bnorm and not rt.failed
    assert _true_residual(St, bf, rt.x.numpy()) <= 1e-7 * bnorm
    assert rt.refines == rj.refines
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(rj.x)).max())


def test_refined_pcg_certifies_float32():
    """Float32 inner iterations (the card's working type, here on the CPU):
    the certified residual meets 1e-7 where a plain float32 PCG floors
    above it."""
    Sj, St, bf = _system(2500, torch.float32)
    bnorm = np.linalg.norm(bf.astype(np.float64))
    dinv = 1.0 / St.diagonal()
    r = refined_pcg(St, torch.as_tensor(bf), M=lambda v: dinv * v,
                    rtol=1e-7, inner_rtol=1e-5)
    xh, xl = r.x_df32
    x64 = xh.double().numpy() + xl.double().numpy()
    true_res = _true_residual(St, bf, x64)
    assert true_res <= 1e-7 * bnorm, (true_res / bnorm, r.refines)
    assert float(r.res_norm[0]) <= 1e-7 * bnorm and 1 <= r.refines <= 8
    plain = pcg(St, torch.as_tensor(bf), M=lambda v: dinv * v, rtol=1e-7,
                maxit=6000)
    assert true_res < _true_residual(St, bf, plain.x.double().numpy())


# ---------------------------------------------------------------------------
# certified 1e-7 beyond the stencil: the ELL and DD residuals, refined sparse,
# DD and recycled solves
# ---------------------------------------------------------------------------

from krylov_spdes_tpu.ops import sparse as jsp  # noqa: E402
from krylov_spdes_tpu.solvers import refine as jref  # noqa: E402
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg  # noqa: E402
from krylov_spdes_tpu.solvers.eigcg import eigpcg as j_eigpcg  # noqa: E402

import krylov_spdes_tpu_torch.fem as tfem  # noqa: E402
from krylov_spdes_tpu_torch.fem import schur as tschur  # noqa: E402
from krylov_spdes_tpu_torch.solvers import refine as tref  # noqa: E402
from krylov_spdes_tpu_torch.solvers.eigcg import eigpcg  # noqa: E402

NP_DT = {torch.float32: np.float32, torch.float64: np.float64}


def _sparse_system(nn, dtype, rough=1.2, seed=5):
    """tests/test_refine.py's unstructured system in `dtype`, both packages,
    with the exact float64 rendering of the rounded operator."""
    mesh = get_mesh(nn, jitter=0.15, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rough * rng.normal(size=mesh.nnode)))
    f = convert.numpy_fields(A)
    f["data"] = f["data"].astype(NP_DT[dtype])
    Aj = jsp.SparseOp(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v) for k, v in f.items()})
    At = convert.sparse_op(**f, device="cpu", dtype=dtype)
    bn = np.asarray(b).astype(NP_DT[dtype])
    A64 = sp.csr_matrix((f["data"].astype(np.float64), f["indices"],
                         f["indptr"]), shape=(A.n_rows, A.n_cols))
    return Aj, At, bn, A64


def _jacobi(Aj, At):
    d = 1.0 / At.to_scipy().diagonal()
    dj, dt = jnp.asarray(d), torch.as_tensor(d)
    return Partial(lambda v, r: v * r, dj), (lambda r: dt * r)


def _x64(pair):
    return pair[0].double().numpy() + pair[1].double().numpy()


def _jx64(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def test_ell_residual_df32_matches_scipy():
    """At a pair near the solution (the float64 solve split into float32 hi
    and lo), where b − A x cancels down to ~1e-14·‖b‖."""
    from scipy.sparse.linalg import spsolve
    Aj, At, bn, A64 = _sparse_system(900, torch.float32)
    xs = spsolve(A64.tocsc(), bn.astype(np.float64))
    x = xs.astype(np.float32)
    xl = (xs - x).astype(np.float32)
    want = bn.astype(np.float64) - A64 @ (x.astype(np.float64)
                                         + xl.astype(np.float64))
    bnorm = np.linalg.norm(bn.astype(np.float64))
    zero = np.zeros_like(bn)
    t = torch.as_tensor
    rt = tdf.ell_residual_df32(At, t(bn), t(zero), t(x), t(xl))
    assert rt[0].dtype == torch.float32
    rj = jdf.ell_residual_df32(Aj, jnp.asarray(bn), jnp.asarray(zero),
                               jnp.asarray(x), jnp.asarray(xl))
    for got in (_x64(rt), np.asarray(rj[0], np.float64)
                + np.asarray(rj[1], np.float64)):
        assert np.abs(got - want).max() <= 1e-12 * bnorm


def test_df_contract_matches_float64():
    """The eager df32 contraction carries ~n·eps² (the JAX package's scan
    reaches this only where the backend rounds strictly)."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(4, 37, 53)).astype(np.float32)
    xh = rng.normal(size=(4, 53)).astype(np.float32)
    xl = (rng.normal(size=(4, 53)) * 1e-8).astype(np.float32)
    y64 = np.einsum("dmn,dn->dm", A.astype(np.float64),
                    xh.astype(np.float64) + xl.astype(np.float64))
    t = torch.as_tensor
    got = _x64(tdf.df_matvec(t(A), t(xh), t(xl)))
    assert np.abs(got - y64).max() <= 1e-11 * (np.abs(y64).max() + 1.0)
    h, lo = tdf.df_dot_accumulate(*tdf.df_from(t(A[0, 0])), t(A[0, 1]),
                                  t(xh[0]))
    want = A[0, 0].astype(np.float64) + A[0, 1].astype(np.float64) * \
        xh[0].astype(np.float64)
    np.testing.assert_allclose(_x64((h, lo)), want, rtol=1e-13, atol=0)
    assert torch.equal(tdf.df_neg(h, lo)[0], -h)


def _dd_system(dtype, nnode=900, ndom=5, seed=3):
    """tests/test_refine.py's DD system in `dtype`: the JAX package's
    partition and plan, the port's own set_subdomains, plan and refill on
    the same partition, blocks refilled in float64 and rounded."""
    from krylov_spdes_tpu.fem.dd import (assemble_dd_values,
                                         prepare_dd_assembly, set_subdomains)
    from krylov_spdes_tpu.fem.partition import mesh_partition
    from krylov_spdes_tpu.fem.schur import (
        assembled_schur_operator, prepare_neumann_neumann_schur_precond,
        prepare_schur_operator)
    import dataclasses
    f = lambda x, y: -1.0 + 0.0 * x  # noqa: E731
    u = lambda x, y: 0.0 * x  # noqa: E731
    mesh = get_mesh(nnode, jitter=0.2, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    epart, _ = mesh_partition(mesh.cells, mesh.points, ndom,
                              mesh.cell_neighbors)
    coeff = np.exp(np.random.default_rng(seed).normal(size=mesh.nnode))
    part = set_subdomains(mesh.cells, epart, maps, ndom)
    plan = prepare_dd_assembly(mesh.cells, mesh.points, epart, part, maps,
                               f, u)
    npdt = NP_DT[dtype]
    bj = [jnp.asarray(np.asarray(a).astype(npdt))
          for a in assemble_dd_values(plan, jnp.asarray(coeff))]
    plan = dataclasses.replace(
        plan, imask=jnp.asarray(np.asarray(plan.imask).astype(npdt)),
        gmask=jnp.asarray(np.asarray(plan.gmask).astype(npdt)))
    Sj = prepare_schur_operator(plan, part, *bj[:3])
    jside = (plan, Sj, assembled_schur_operator(Sj),
             prepare_neumann_neumann_schur_precond(Sj), bj)

    maps_t = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    part_t = tfem.set_subdomains(mesh.cells, epart, maps_t, ndom)
    plan_t = tfem.prepare_dd_assembly(mesh.cells, mesh.points, epart, part_t,
                                      maps_t, f, u, device="cpu",
                                      dtype=torch.float64)
    bt = [a.to(dtype) for a in tfem.assemble_dd_values(
        plan_t, torch.as_tensor(coeff))]
    plan_t = dataclasses.replace(plan_t, imask=plan_t.imask.to(dtype),
                                 gmask=plan_t.gmask.to(dtype))
    St = tschur.prepare_schur_operator(plan_t, part_t, *bt[:3])
    tside = (plan_t, St, tschur.assembled_schur_operator(St),
             tschur.prepare_neumann_neumann_schur_precond(St), bt)
    return jside, tside


def _dd_full_residual(plan, S, blocks, uI, uG):
    """‖(r_I, r_Γ)‖ of the full DD system in float64 (numpy, np.add.at)."""
    A_II, A_IG, A_GGd, b_I, b_G = [b.double().numpy() for b in blocks]
    im = plan.imask.double().numpy()
    gm = plan.gmask.double().numpy()
    g2g = S.gammad_to_gamma.numpy()
    A_II = A_II * im[:, :, None] * im[:, None, :]
    A_IG = A_IG * im[:, :, None] * gm[:, None, :]
    A_GG = A_GGd * gm[:, :, None] * gm[:, None, :]
    b_I = b_I * im
    xd = uG[g2g] * gm
    rI = (b_I - np.einsum("dij,dj->di", A_II, uI)
          - np.einsum("dig,dg->di", A_IG, xd)) * im
    sd = (np.einsum("dig,di->dg", A_IG, uI)
          + np.einsum("dgh,dh->dg", A_GG, xd)) * gm
    rG = b_G.copy()
    np.subtract.at(rG, g2g.reshape(-1), sd.reshape(-1))
    bnorm = np.sqrt(np.sum(b_I * b_I) + np.sum(b_G * b_G))
    return np.sqrt(np.sum(rI * rI) + np.sum(rG * rG)), bnorm


def test_dd_residual_df32_and_pullback_match():
    (plan_j, Sj, _, _, bj), (plan_t, St, _, _, bt) = _dd_system(torch.float32)
    pull_t = tdf.build_gamma_pullback(St.gammad_to_gamma, St.gmask,
                                      St.n_gamma)
    pull_j = jdf.build_gamma_pullback(Sj.gammad_to_gamma, Sj.gmask, Sj.n_gamma)
    np.testing.assert_array_equal(pull_t.numpy(), np.asarray(pull_j))
    rng = np.random.default_rng(4)
    im = plan_t.imask.numpy()
    # iterates of the solution's size (|u| ~ 1e-2), so that A u ~ b
    uI = (1e-2 * rng.normal(size=im.shape) * im).astype(np.float32)
    uG = (1e-2 * rng.normal(size=St.n_gamma)).astype(np.float32)
    rI_ref, rG_ref = _dd_residual_np(plan_t, St, bt, uI, uG)
    bnorm = _dd_full_residual(plan_t, St, bt, np.zeros_like(uI),
                              np.zeros_like(uG))[1]
    im_t, gm_t = plan_t.imask, plan_t.gmask
    blk_t = (bt[0] * im_t[:, :, None] * im_t[:, None, :],
             bt[1] * im_t[:, :, None] * gm_t[:, None, :],
             bt[2] * gm_t[:, :, None] * gm_t[:, None, :])
    t, z = torch.as_tensor, torch.zeros_like
    (rIh, rIl), (rGh, rGl) = tdf.dd_residual_df32(
        *blk_t, St.gammad_to_gamma, St.gmask, pull_t, bt[3], bt[4], t(uI),
        z(t(uI)), t(uG), z(t(uG)))
    im_j, gm_j = plan_j.imask, plan_j.gmask
    (jIh, jIl), (jGh, jGl) = jdf.dd_residual_df32(
        bj[0] * im_j[:, :, None] * im_j[:, None, :],
        bj[1] * im_j[:, :, None] * gm_j[:, None, :],
        bj[2] * gm_j[:, :, None] * gm_j[:, None, :], Sj.gammad_to_gamma,
        Sj.gmask, pull_j, bj[3], bj[4], jnp.asarray(uI),
        jnp.zeros_like(bj[3]), jnp.asarray(uG), jnp.zeros_like(bj[4]))
    w = lambda h, lo: np.asarray(h, np.float64) + np.asarray(lo, np.float64)  # noqa: E731
    for rI, rG in ((_x64((rIh, rIl)), _x64((rGh, rGl))),
                   (w(jIh, jIl), w(jGh, jGl))):
        assert np.abs((rI - rI_ref) * im).max() <= 1e-12 * bnorm
        assert np.abs(rG - rG_ref).max() <= 1e-12 * bnorm


def _dd_residual_np(plan, S, blocks, uI, uG):
    A_II, A_IG, A_GGd, b_I, b_G = [b.double().numpy() for b in blocks]
    im = plan.imask.double().numpy()
    gm = plan.gmask.double().numpy()
    g2g = S.gammad_to_gamma.numpy()
    xd = uG.astype(np.float64)[g2g] * gm
    u = uI.astype(np.float64)
    rI = b_I - np.einsum("dij,dj->di", A_II * im[:, :, None] * im[:, None, :],
                         u) - np.einsum(
        "dig,dg->di", A_IG * im[:, :, None] * gm[:, None, :], xd)
    sd = (np.einsum("dig,di->dg", A_IG * im[:, :, None] * gm[:, None, :], u)
          + np.einsum("dgh,dh->dg", A_GGd * gm[:, :, None] * gm[:, None, :],
                      xd)) * gm
    rG = b_G.copy()
    np.subtract.at(rG, g2g.reshape(-1), sd.reshape(-1))
    return rI, rG


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_refined_pcg_sparse_matches_jax(dtype):
    """Both single_trace forms in both packages: the same certified solve."""
    Aj, At, bn, A64 = _sparse_system(3600, dtype)
    Mj, Mt = _jacobi(Aj, At)
    bnorm = np.linalg.norm(bn.astype(np.float64))
    rj = jref.refined_pcg_sparse(Aj, jnp.asarray(bn), M=Mj)
    outs = [tref.refined_pcg_sparse(At, torch.as_tensor(bn), M=Mt,
                                    single_trace=st) for st in (True, False)]
    for st, rt in zip((True, False), outs):
        rjs = jref.refined_pcg_sparse(Aj, jnp.asarray(bn), M=Mj,
                                      single_trace=st)
        assert rjs.refines == rj.refines and not rjs.breakdown
        assert np.linalg.norm(bn - A64 @ _jx64(rjs.x_df32)) <= 1e-7 * bnorm
        x = _x64(rt.x_df32)
        assert np.linalg.norm(bn - A64 @ x) <= 1e-7 * bnorm
        assert float(rt.res_norm[0]) <= 1e-7 * bnorm and not rt.failed
        if dtype == torch.float64:
            assert rt.refines == rjs.refines
            assert abs(int(rt.it) - int(rjs.it)) <= rt.refines
            xj = np.asarray(rjs.x)
            assert np.linalg.norm(x - xj) <= 1e-8 * np.linalg.norm(xj)
        else:
            assert abs(rt.refines - rjs.refines) <= 1
    assert outs[0].refines == outs[1].refines
    assert int(outs[0].it) == int(outs[1].it)
    assert float(outs[0].res_norm[0]) == float(outs[1].res_norm[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_refined_dd_pcg_matches_jax(dtype):
    (plan_j, Sj, op_j, Mj, bj), (plan_t, St, op_t, Mt, bt) = _dd_system(dtype)
    rj = jref.refined_dd_pcg(plan_j, Sj, op_j, bj[3], bj[4], *bj[:3], M=Mj)
    rt = tref.refined_dd_pcg(plan_t, St, op_t, bt[3], bt[4], *bt[:3], M=Mt)
    uI, uG = _x64(rt.u_I), _x64(rt.x_df32)
    res, bnorm = _dd_full_residual(plan_t, St, bt, uI, uG)
    assert res <= 1e-7 * bnorm and not rt.breakdown
    assert abs(rt.bnorm - bnorm) <= 1e-6 * bnorm
    assert float(rt.res_norm[0]) <= 1e-7 * rt.bnorm
    assert not rj.breakdown
    assert _dd_full_residual(plan_t, St, bt, _jx64(rj.u_I),
                             _jx64(rj.x_df32))[0] <= 1e-7 * bnorm
    if dtype == torch.float64:
        assert rt.refines == rj.refines
        assert abs(int(rt.it) - int(rj.it)) <= rt.refines
        for got, want in ((uG, rj.x_df32), (uI, rj.u_I)):
            w = np.asarray(want[0], np.float64) + np.asarray(want[1],
                                                             np.float64)
            assert np.linalg.norm(got - w) <= 1e-8 * np.linalg.norm(w)
    else:
        assert abs(rt.refines - rj.refines) <= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_refined_recycled_solve_matches_jax(dtype):
    """eigPCG as first_solve (tests/test_refine.py's case), then Def-PCG
    corrections deflated by its basis."""
    Aj, At, bn, A64 = _sparse_system(1600, dtype)
    Mj, Mt = _jacobi(Aj, At)
    bnorm = np.linalg.norm(bn.astype(np.float64))
    bj_, bt_ = jnp.asarray(bn), torch.as_tensor(bn)
    kw = dict(nvec=8, spdim=24, maxit=4000, rtol=1e-5)
    rj = jref.refined_recycled_solve(
        Aj, bj_, lambda: j_eigpcg(Aj, bj_, M=Mj, **kw), M=Mj,
        inner_maxit=4000)
    rt = tref.refined_recycled_solve(
        At, bt_, lambda: eigpcg(At, bt_, M=Mt, **kw), M=Mt, inner_maxit=4000)
    x = _x64(rt.x_df32)
    assert np.linalg.norm(bn - A64 @ x) <= 1e-7 * bnorm
    assert np.linalg.norm(bn - A64 @ _jx64(rj.x_df32)) <= 1e-7 * bnorm
    assert not rt.breakdown and not rj.breakdown
    assert rt.W is not None and rt.W.shape[1] == 8
    assert abs(rt.bnorm - bnorm) <= 1e-6 * bnorm
    if dtype == torch.float64:
        assert rt.refines == rj.refines
        assert abs(int(rt.it) - int(rj.it)) <= rt.refines + 1
        xj = np.asarray(rj.x)
        assert np.linalg.norm(x - xj) <= 1e-8 * np.linalg.norm(xj)
    else:
        assert abs(rt.refines - rj.refines) <= 1


def test_breakdown_restores_the_best_iterate():
    """An inner preconditioner that is not SPD (a random sign a dof) keeps
    the sweeps from contracting by half: both packages stop, restore the
    best iterate and report the breakdown (the JAX tests have no such
    case)."""
    Aj, At, bn, _ = _sparse_system(1600, torch.float64)
    s = np.where(np.random.default_rng(0).random(At.n_rows) < 0.5, -1.0, 1.0)
    Mj = Partial(lambda v, r: v * r, jnp.asarray(s))
    st = torch.as_tensor(s)
    Mt = lambda r: st * r  # noqa: E731
    bj_, bt_ = jnp.asarray(bn), torch.as_tensor(bn)
    rj = jref.refined_recycled_solve(
        Aj, bj_, lambda: j_pcg(Aj, bj_, M=Mj, maxit=5, rtol=1e-5), M=Mj,
        inner_maxit=5)
    rt = tref.refined_recycled_solve(
        At, bt_, lambda: pcg(At, bt_, M=Mt, maxit=5, rtol=1e-5), M=Mt,
        inner_maxit=5)
    assert rt.breakdown and rj.breakdown and rt.failed
    assert rt.refines == rj.refines
    # the same best iterate restored, at the smallest residual of the sweeps
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)
    np.testing.assert_allclose(float(rt.res_norm[0]), float(rj.res_norm[0]),
                               rtol=1e-8)

    (plan_j, Sj, op_j, _, bj), (plan_t, St, op_t, _, bt) = _dd_system(
        torch.float64)
    s = np.where(np.random.default_rng(1).random(St.n_gamma) < 0.5, -1.0, 1.0)
    rj = jref.refined_dd_pcg(plan_j, Sj, op_j, bj[3], bj[4], *bj[:3],
                             M=Partial(lambda v, r: v * r, jnp.asarray(s)),
                             inner_maxit=20)
    st = torch.as_tensor(s)
    rt = tref.refined_dd_pcg(plan_t, St, op_t, bt[3], bt[4], *bt[:3],
                             M=lambda r: st * r, inner_maxit=20)
    assert rt.breakdown and rj.breakdown
    assert rt.refines == rj.refines
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-8 * max(
        np.linalg.norm(xj), 1e-30)
    np.testing.assert_allclose(float(rt.res_norm[0]), float(rj.res_norm[0]),
                               rtol=1e-8)


def test_certified_solves_run_with_tf32_off():
    """The wrappers switch TF32 off for everything inside them, the first
    solve and the preconditioner included, and restore the caller's
    setting."""
    Aj, At, bn, _ = _sparse_system(400, torch.float32)
    seen = []
    b = torch.as_tensor(bn)

    def first():
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return pcg(At, b, rtol=1e-5)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tref.refined_recycled_solve(At, b, first)
        tref.refined_pcg_sparse(
            At, b, M=lambda r: (seen.append(
                torch.backends.cuda.matmul.allow_tf32), r)[1])
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
