"""PyTorch port, the block-tridiagonal Cholesky engine
(precond/block_tridiag_chol.py) against the JAX package and a dense solve:
float64 on the CPU, the same seeded systems through both packages
(tests/test_block_tridiag_chol.py's cases)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops.stencil import build_stencil_op, to_full_vector
from krylov_spdes_tpu.precond import block_tridiag_chol as jbtc
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.precond import block_tridiag_chol as tbtc
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _random_block_tridiag(nb=7, m=5, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(nb, m, m))
    E = rng.normal(size=(nb, m, m)) * 0.3
    E[-1] = 0.0
    n = nb * m
    A = np.zeros((n, n))
    for i in range(nb):
        A[i * m:(i + 1) * m, i * m:(i + 1) * m] = D[i] @ D[i].T + 3 * np.eye(m)
        if i + 1 < nb:
            A[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = E[i]
            A[(i + 1) * m:(i + 2) * m, i * m:(i + 1) * m] = E[i].T
    Dsym = np.stack([A[i * m:(i + 1) * m, i * m:(i + 1) * m]
                     for i in range(nb)])
    return A, Dsym, E


def test_btc_factor_and_solve_match_jax_and_dense():
    A, D, E = _random_block_tridiag()
    nb, m = D.shape[:2]
    Lt, Gt = tbtc.btc_factor(torch.as_tensor(D), torch.as_tensor(E))
    Lj, Gj = jbtc.btc_factor(jnp.asarray(D), jnp.asarray(E))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=1e-12,
                               atol=1e-14)
    b = np.random.default_rng(1).normal(size=nb * m)
    x = tbtc._btc_solve(torch.float64, Lt, Gt,
                        torch.as_tensor(b).reshape(nb, m)).reshape(-1)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-10,
                               atol=1e-12)
    # bfloat16 storage, solved in float32
    L16, G16 = tbtc.btc_factor(torch.as_tensor(D), torch.as_tensor(E),
                               store_dtype=torch.bfloat16)
    assert L16.dtype == torch.bfloat16
    x16 = tbtc._btc_solve(torch.float64, L16, G16,
                          torch.as_tensor(b).reshape(nb, m)).reshape(-1)
    assert np.linalg.norm(x16.numpy() - x.numpy()) <= 5e-2 * np.linalg.norm(
        x.numpy())


def _stencil_system(nn, seed, rough):
    mesh = get_mesh(nn, jitter=0.1, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rough * rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    Sj = build_stencil_op(A, maps, (m1, m1))
    St = convert.stencil_op(**convert.numpy_fields(Sj), **CPU64)
    bf = np.asarray(to_full_vector(maps, jnp.asarray(b), mesh.nnode))
    return A, Sj, St, bf


def test_stencil_block_tridiag_matches_jax_and_operator():
    _, Sj, St, _ = _stencil_system(400, 3, 0.5)
    D, E = tbtc.stencil_to_block_tridiag(St)
    Dj, Ej = jbtc.stencil_to_block_tridiag(Sj)
    np.testing.assert_array_equal(D.numpy(), np.asarray(Dj))
    np.testing.assert_array_equal(E.numpy(), np.asarray(Ej))
    n, W = St.n, St.W
    Afull = np.zeros((n, n))
    for i in range(St.H):
        s = i * W
        Afull[s:s + W, s:s + W] = D[i].numpy()
        if i + 1 < St.H:
            Afull[s:s + W, s + W:s + 2 * W] = E[i].numpy()
            Afull[s + W:s + 2 * W, s:s + W] = E[i].numpy().T
    x = np.random.default_rng(4).normal(size=n)
    np.testing.assert_allclose(Afull @ x, St.matvec(torch.as_tensor(x)).numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", ["stencil", "banded"])
def test_cholesky_preconditioners_match_jax(kind):
    """Stencil Cholesky (float64 and bfloat16-stored) and the RCM-banded
    Cholesky of the same matrix: the port's apply against the JAX
    package's, and PCG converging in as many iterations."""
    A, Sj, St, bf = _stencil_system(2500, 5, 1.0)
    r = np.random.default_rng(6).normal(size=St.n)
    if kind == "stencil":
        cases = [(jbtc.get_stencil_cholesky(Sj, dtype=jnp.float64),
                  tbtc.get_stencil_cholesky(St, dtype=torch.float64), 1e-10),
                 (jbtc.get_stencil_cholesky(Sj, store_dtype=jnp.bfloat16),
                  tbtc.get_stencil_cholesky(St, store_dtype=torch.bfloat16),
                  1e-2)]
        opj, opt, b = Sj, St, bf
    else:
        from krylov_spdes_tpu_torch.ops.sparse import from_scipy
        csr = A.to_scipy()
        cases = [(jbtc.get_banded_cholesky(csr, dtype=jnp.float64,
                                           out_dtype=jnp.float64),
                  tbtc.get_banded_cholesky(csr, dtype=torch.float64,
                                           out_dtype=torch.float64,
                                           device="cpu"), 1e-10)]
        opj, opt = A, from_scipy(csr, **CPU64)
        b = np.random.default_rng(2).normal(size=csr.shape[0])
        r = r[:csr.shape[0]]
    for Mj, Mt, tol in cases:
        zj = np.asarray(Mj(jnp.asarray(r)))
        zt = Mt(torch.as_tensor(r))
        assert zt.dtype == torch.float64
        assert np.linalg.norm(zt.numpy() - zj) <= tol * np.linalg.norm(zj)
        rj = j_pcg(opj, jnp.asarray(b), M=Mj)
        rt = pcg(opt, torch.as_tensor(b), M=Mt)
        assert abs(int(rt.it) - int(rj.it)) <= 1, (int(rt.it), int(rj.it))
        assert rt.history()[-1] <= 1e-7 * np.linalg.norm(b)
