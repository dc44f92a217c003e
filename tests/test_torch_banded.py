"""PyTorch port, the RCM-banded block-tridiagonal operator (ops/banded.py)
and the banded AMG V-cycle (precond/amg.py, matvec="banded") against the
JAX package: float64 on the CPU, the same Delaunay system through both
packages (tests/test_banded.py's cases)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_delaunay_mesh
from krylov_spdes_tpu.ops import banded as jb
from krylov_spdes_tpu.precond import amg as jamg
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import banded as tb
from krylov_spdes_tpu_torch.ops.sparse import from_scipy
from krylov_spdes_tpu_torch.precond import amg as tamg
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def system():
    mesh = get_delaunay_mesh(1500, seed=3)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    kappa = np.exp(0.3 * np.random.default_rng(0).normal(size=mesh.nnode))
    Aj, b = do_isotropic_elliptic_assembly(asm, kappa)
    At = convert.sparse_op(**convert.numpy_fields(Aj), **CPU64)
    return Aj, At, np.array(b)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_banded_op_matches_jax(system):
    """The same RCM permutation and blocks; the matvec on a vector and on an
    (n, k) block against the JAX package's (rtol 1e-12) and against the
    permuted scipy product."""
    Aj, At, _ = system
    opj = jb.build_banded_op(Aj)
    opt = tb.build_banded_op(At, **CPU64)
    np.testing.assert_array_equal(opt.perm.numpy(), np.asarray(opj.perm))
    np.testing.assert_array_equal(opt.iperm.numpy(), np.asarray(opj.iperm))
    assert (opt.n, opt.m, opt.nb) == (opj.n, opj.m, opj.nb)
    np.testing.assert_array_equal(opt.D.numpy(), np.asarray(opj.D))
    np.testing.assert_array_equal(opt.E.numpy(), np.asarray(opj.E))

    rng = np.random.default_rng(1)
    x = rng.normal(size=At.n_rows)
    yj = np.asarray(jb.banded_matvec(opj, jnp.asarray(x)))
    yt = tb.banded_matvec(opt, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12)
    perm = opt.perm.numpy()
    np.testing.assert_allclose(yt, At.to_scipy()[perm][:, perm] @ x,
                               rtol=1e-10, atol=1e-12)
    X = rng.normal(size=(At.n_rows, 3))
    Y = opt(torch.as_tensor(X)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(
            Y[:, k], opt(torch.as_tensor(X[:, k].copy())).numpy())
    # carried across from the JAX package's object
    opc = convert.banded_op(**convert.numpy_fields(opj), **CPU64)
    np.testing.assert_array_equal(opc(torch.as_tensor(x)).numpy(), yt)


def test_banded_amg_vcycle_matches_jax(system):
    """The banded hierarchy (permutations folded into P and R) built by the
    port and carried across from the JAX package's by
    convert.amg_hierarchy: both V-cycles agree with JAX's banded V-cycle
    (rtol 1e-12) and with the ELL V-cycle of the same hierarchy (1e-9, as
    tests/test_banded.py); a banded PCG solve reaches 1.1e-7."""
    Aj, At, b = system
    hj = jamg.amg_setup(Aj.to_scipy(), matvec="banded")
    ht = tamg.amg_setup(At.to_scipy(), matvec="banded", device="cpu")
    assert ht["perm0"] is not None and len(ht["levels"]) == len(hj["levels"])
    np.testing.assert_array_equal(ht["perm0"][0].numpy(),
                                  np.asarray(hj["perm0"][0]))
    r = np.random.default_rng(2).normal(size=At.n_rows)
    zj = np.asarray(jamg._vcycle(1, 1, hj, 2.0 / 3.0, jnp.asarray(r)))
    carried = convert.amg_hierarchy(**hj, **CPU64)
    assert isinstance(carried["levels"][0]["A"], tb.BandedOp)
    for hier in (carried, ht):
        zt = tamg._vcycle(1, 1, hier, 2.0 / 3.0, torch.as_tensor(r))
        assert _rel(zt.numpy(), zj) <= 1e-12
    z_ell = tamg.amg_precond(At)(torch.as_tensor(r)).numpy()
    M_band = tamg.amg_precond(At, matvec="banded")
    np.testing.assert_allclose(M_band(torch.as_tensor(r)).numpy(), z_ell,
                               rtol=1e-9, atol=1e-11)
    res = pcg(At, torch.as_tensor(b), M=M_band)
    x = res.x.numpy()
    assert np.linalg.norm(b - At.to_scipy() @ x) <= \
        1.1e-7 * np.linalg.norm(b)


def test_banded_pcg_matches_jax(system):
    """Example 01's --op banded arm: the permuted system through
    banded_system, AMG (banded V-cycle) built on the permuted matrix, and
    bench_banded.py's Jacobi-PCG: the same `it` as the JAX package, the
    unpermuted x within 1e-8 of JAX's and within 1e-5 of the ELL solve
    (tests/test_banded.py's limit)."""
    Aj, At, b = system
    Aop_j, bp_j, unperm_j, op_j = jb.banded_system(Aj, b)
    Aop_t, bp_t, unperm_t, op_t = tb.banded_system(At, torch.as_tensor(b))
    assert Aop_t is op_t and bp_t.dtype == torch.float64
    np.testing.assert_array_equal(bp_t.numpy(), np.asarray(bp_j))
    perm = op_t.perm.numpy()
    # the permuted matrix with sorted column indices: greedy aggregation
    # walks each row's indices in storage order
    Ap = At.to_scipy()[perm][:, perm].sorted_indices()
    dinv = 1.0 / Ap.diagonal()
    bnorm = np.linalg.norm(b)
    res_ell = pcg(At, torch.as_tensor(b), M=tamg.amg_precond(At))
    for Mj, Mt in (
            (jamg.amg_precond(Ap, matvec="banded"),
             tamg.amg_precond(from_scipy(Ap, **CPU64), matvec="banded")),
            (lambda r: jnp.asarray(dinv) * r,
             lambda r: torch.as_tensor(dinv) * r)):
        rj = j_pcg(Aop_j, bp_j, M=Mj)
        rt = pcg(Aop_t, bp_t, M=Mt)
        assert int(rt.it) == int(rj.it), (int(rt.it), int(rj.it))
        x = unperm_t(rt.x).numpy()
        np.testing.assert_allclose(x, np.asarray(unperm_j(rj.x)), rtol=1e-8,
                                   atol=1e-10)
        assert np.linalg.norm(b - At.to_scipy() @ x) <= 1.1e-7 * bnorm
        np.testing.assert_allclose(x, res_ell.x.numpy(), rtol=1e-5,
                                   atol=1e-8)
