"""PyTorch port, df32 arithmetic and the certified refined PCG
(ops/df32.py, solvers/refine.py) against numpy float64 and the JAX
package."""

import jax.numpy as jnp
import numpy as np
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
