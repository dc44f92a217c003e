"""PyTorch port, the batched chain solver (solvers/batched.py), the batched
stencil apply and the projection kernels' plain versions
(ops/batched_proj.py, kernels F and G) against the JAX package. float64 on
the CPU unless said otherwise; the JAX package's Pallas kernels run in
interpret mode, as tests/test_batched.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.fem.stencil_assembly import (prepare_stencil_assembly,
                                                   stencil_assemble)
from krylov_spdes_tpu.ops import batched_proj as jbp
from krylov_spdes_tpu.ops.stencil import (StencilOp, stencil_matvec,
                                          stencil_matvec_batched)
from krylov_spdes_tpu.solvers.base import as_precond_op
from krylov_spdes_tpu.solvers.batched import _batched_eigdef_impl as j_batched
from krylov_spdes_tpu.solvers.eigcg import _eigpcg_impl as j_eigpcg

from krylov_spdes_tpu_torch.ops import batched_proj as tbp
from krylov_spdes_tpu_torch.ops import stencil as tst
from krylov_spdes_tpu_torch.ops.stencil_kernel import stencil_spmv_plain
from krylov_spdes_tpu_torch.solvers.batched import \
    _batched_eigdef_impl as t_batched

torch.set_num_threads(1)


def _setup(B=3, nn=1600, seed=0):
    mesh = get_mesh(nn, seed=0)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    plan = prepare_stencil_assembly(
        mesh, maps, lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    return mesh, plan, rng


def _realize(plan, rng, B, n):
    g = rng.normal(size=(B, n)) * 0.4
    planes, b = jax.vmap(stencil_assemble, in_axes=(None, 0))(
        plan, jnp.exp(jnp.asarray(g)))
    mdiag = 1.0 / (planes[:, 0] + plan.dir_diag[None]).reshape(B, -1)
    return planes, b, mdiag


def _seed_bases(plan, planes, b, mdiag, nvec, spdim, rtol):
    Ws = []
    for c in range(b.shape[0]):
        op = StencilOp(planes=planes[c], dir_diag=plan.dir_diag.astype(b.dtype),
                       slot=jnp.zeros((0,), jnp.int32), H=plan.H, W=plan.W)
        Mfn = as_precond_op(Partial(lambda d, r: d * r, mdiag[c]))
        Ws.append(j_eigpcg(Partial(stencil_matvec, op), Mfn, b[c],
                           jnp.zeros_like(b[c]), nvec, spdim, 2000, rtol)[3])
    return jnp.stack(Ws)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _port_A(planes, dir_diag, dtype=torch.float64):
    pt, dt = _t(planes, dtype), _t(dir_diag, dtype)
    return lambda v: tst.stencil_matvec_batched(pt, dt, v)


def test_batched_matvec_bit_equal_to_the_loop_and_to_jax():
    mesh, plan, rng = _setup()
    planes, b, _ = _realize(plan, rng, 3, mesh.nnode)
    pt, dt, bt = _t(planes), _t(plan.dir_diag), _t(b)
    y = tst.stencil_matvec_batched(pt, dt, bt)
    for c in range(3):
        np.testing.assert_array_equal(
            y[c].numpy(), stencil_spmv_plain(pt[c], dt, bt[c]).numpy())
    np.testing.assert_allclose(
        y.numpy(), np.asarray(stencil_matvec_batched(planes, plan.dir_diag, b)),
        rtol=1e-13, atol=1e-15)


def test_batched_eigdefpcg_matches_jax():
    """its equal, x to 1e-8, the harvested projectors to 1e-8."""
    B, nvec, spdim = 3, 8, 24
    mesh, plan, rng = _setup(B=B)
    planes, b, mdiag = _realize(plan, rng, B, mesh.nnode)
    W_b = _seed_bases(plan, planes, b, mdiag, nvec, spdim, 1e-7)
    planes2, b2, md2 = _realize(plan, rng, B, mesh.nnode)

    Ab = Partial(stencil_matvec_batched, planes2, plan.dir_diag)
    xj, itj, resj, Wnj = j_batched(Ab, md2, b2, jnp.zeros_like(b2), W_b,
                                   nvec, spdim, 2000, 1e-7)
    xt, itt, rest, Wnt = t_batched(
        _port_A(planes2, plan.dir_diag), _t(md2), _t(b2),
        torch.zeros(b2.shape, dtype=torch.float64), _t(W_b), nvec, spdim,
        2000, 1e-7)
    assert itt.dtype == torch.int32
    assert itt.tolist() == [int(v) for v in itj]
    assert min(itt.tolist()) > spdim        # several restarts were taken
    for c in range(B):
        np.testing.assert_allclose(xt[c].numpy(), np.asarray(xj[c]),
                                   rtol=1e-8, atol=1e-12)
        Q1, _ = np.linalg.qr(np.asarray(Wnj[c]))
        Q2, _ = np.linalg.qr(Wnt[c].numpy())
        d = np.max(np.abs(Q1 @ Q1.T - Q2 @ Q2.T))
        assert d < 1e-8, d
        m = int(itj[c])
        np.testing.assert_allclose(rest[c].numpy()[:m],
                                   np.asarray(resj[c])[:m], rtol=1e-7)


def test_projection_plain_versions_match_the_pallas_kernels():
    """gemv_rows_plain / fused_reorth_plain against gemv_rows(...,
    interpret=True) / fused_reorth(..., interpret=True) on the operands of
    tests/test_batched.py (float32: sums in another order, 1e-4)."""
    rng = np.random.default_rng(0)
    B, nvec, n = 3, 8, 5000
    K = 2 * nvec
    n_pad = -(-n // jbp.TN) * jbp.TN
    G = rng.normal(size=(B, K, n)).astype(np.float32)
    r = rng.normal(size=(B, n)).astype(np.float32)
    m = (rng.random(size=(B, n)) + 0.5).astype(np.float32)
    C = rng.normal(size=(B, 2 * nvec)).astype(np.float32)
    Gp, rp_, mp = (jbp.pad_n(jnp.asarray(a), n_pad) for a in (G, r, m))
    f32 = torch.float32
    Gt, rt, mt, Ct = _t(G, f32), _t(r, f32), _t(m, f32), _t(C, f32)

    # pad_n is the same zero padding
    np.testing.assert_array_equal(tbp.pad_n(Gt, n_pad).numpy(), np.asarray(Gp))

    U_j = jbp.gemv_rows(Gp, rp_, interpret=True)
    U_t = tbp.gemv_rows(Gt, rt)                  # the plain version on the CPU
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=1e-4,
                               atol=1e-4)
    # the padded operands give the same sums: the port takes any n
    np.testing.assert_allclose(
        tbp.gemv_rows_plain(tbp.pad_n(Gt, n_pad), tbp.pad_n(rt, n_pad)).numpy(),
        U_t.numpy(), rtol=1e-5, atol=1e-5)

    out_j = jbp.fused_reorth(jbp.pad_n(jnp.asarray(G[:, :nvec]), n_pad),
                             jnp.asarray(C), rp_, mp, nvec, interpret=True)
    out_t = tbp.fused_reorth(Gt, Ct, rt, mt, nvec)   # K = 2·nvec >= nvec rows
    for a, c in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c)[:, :n],
                                   rtol=1e-4, atol=1e-5)
    for a, c in zip(out_t[3:], out_j[3:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5)


def test_bf16_basis_matches_jax_in_float32():
    """basis_dtype=bfloat16 in float32 against the JAX package: both round
    G, W, r and the coefficients to bf16 and accumulate in float32. Sums in
    another order move a float32 solve's stop by a few iterations at
    rtol 1e-5, so: its within max(3, 5%) (the window the JAX package's own
    test gives bf16 against full precision), x to 1e-3."""
    B, nvec, spdim = 2, 8, 24
    mesh, plan, rng = _setup(B=B)
    f32 = jnp.float32
    planes, b, mdiag = _realize(plan, rng, B, mesh.nnode)
    W = _seed_bases(plan, planes.astype(f32), b.astype(f32),
                    mdiag.astype(f32), nvec, spdim, 1e-5)
    planes2, b2, _ = _realize(plan, rng, B, mesh.nnode)
    planes2, b2 = planes2.astype(f32), b2.astype(f32)
    dd = plan.dir_diag.astype(f32)
    md2 = (1.0 / (planes2[:, 0] + dd[None])).reshape(B, -1)
    Ab = Partial(stencil_matvec_batched, planes2, dd)
    xj, itj, _, Wnj = j_batched(Ab, md2, b2, jnp.zeros_like(b2), W, nvec,
                                spdim, 2000, 1e-5, basis_dtype=jnp.bfloat16)
    t32 = torch.float32
    xt, itt, _, Wnt = t_batched(
        _port_A(planes2, dd, t32), _t(md2, t32), _t(b2, t32),
        torch.zeros(b2.shape, dtype=t32), _t(W, t32), nvec, spdim, 2000,
        1e-5, basis_dtype=torch.bfloat16)
    assert Wnt.dtype == t32 and xt.dtype == t32
    itj = np.asarray(itj)
    assert np.all(np.abs(itt.numpy() - itj) <= np.maximum(3, 0.05 * itj)), (
        itt, itj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3,
                               atol=1e-5)
