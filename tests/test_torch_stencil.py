"""PyTorch port, stencil operator and kernel A: the port's `stencil_matvec`
(its plain version on the CPU) against the JAX package's `stencil_matvec`
and its Pallas kernel in interpret mode (float64). Kernel A itself is held
against its plain version on the card in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops import stencil as jst
from krylov_spdes_tpu.ops.pallas_stencil import stencil_matvec_pallas

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import stencil as tst
from krylov_spdes_tpu_torch.ops import stencil_kernel as tsk

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _setup(nn=900, jitter=0.25, seed=0):
    mesh = get_mesh(nn, jitter=jitter, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    Sj = jst.build_stencil_op(A, maps, (m1, m1))
    St = convert.stencil_op(**convert.numpy_fields(Sj), **CPU64)
    return mesh, maps, A, Sj, St


@pytest.mark.parametrize("jitter", [0.0, 0.25])
def test_matvec_matches_jax_and_pallas(jitter):
    mesh, maps, A, Sj, St = _setup(jitter=jitter, seed=11)
    x = np.random.default_rng(3).normal(size=mesh.nnode)
    y_t = tst.stencil_matvec(St, torch.as_tensor(x)).numpy()
    y_j = np.asarray(jst.stencil_matvec(Sj, jnp.asarray(x)))
    y_p = np.asarray(stencil_matvec_pallas(Sj, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(y_t, y_p, rtol=1e-13, atol=1e-15)
    assert tsk.stencil_spmv.launches == 0  # the CPU path launches nothing


def test_matvec_random_planes_zero_beyond_edge():
    """Arbitrary (non-FEM) planes: the grid edge reads zero, as JAX's pad."""
    rng = np.random.default_rng(7)
    H, W = 23, 31
    planes = rng.normal(size=(9, H, W))
    dd = rng.normal(size=(H, W))
    x = rng.normal(size=H * W)
    Sj = jst.StencilOp(planes=jnp.asarray(planes), dir_diag=jnp.asarray(dd),
                       slot=jnp.zeros((0,), jnp.int32), H=H, W=W)
    St = convert.stencil_op(planes, dd, np.zeros(0), H, W, **CPU64)
    np.testing.assert_allclose(
        tst.stencil_matvec(St, torch.as_tensor(x)).numpy(),
        np.asarray(jst.stencil_matvec(Sj, jnp.asarray(x))),
        rtol=1e-13, atol=1e-14)


def test_operator_helpers_match_jax():
    mesh, maps, A, Sj, St = _setup(seed=5)
    np.testing.assert_array_equal(St.diagonal().numpy(),
                                  np.asarray(Sj.diagonal()))
    rng = np.random.default_rng(9)
    data = rng.normal(size=A.nnz)
    np.testing.assert_array_equal(
        St.with_csr_data(torch.as_tensor(data)).planes.numpy(),
        np.asarray(Sj.with_csr_data(jnp.asarray(data)).planes))
    xf = rng.normal(size=maps.n_free)
    full_t = tst.to_full_vector(maps, torch.as_tensor(xf), mesh.nnode)
    full_j = jst.to_full_vector(maps, jnp.asarray(xf), mesh.nnode)
    np.testing.assert_array_equal(full_t.numpy(), np.asarray(full_j))
    np.testing.assert_array_equal(tst.to_free_vector(maps, full_t).numpy(), xf)
