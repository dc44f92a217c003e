"""PyTorch port, the sparse interop of ops/sparse.py and the single-domain
preconditioners (precond/simple.py Chebyshev, block_jacobi.py, cholesky.py,
amg.py) against the JAX package: float64 on the CPU, the same seeded
operator and residual through both packages (tests/test_precond.py's
system, n = 2000)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import eigsh
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops import sparse as jsparse
from krylov_spdes_tpu.precond import amg as jamg
from krylov_spdes_tpu.precond import block_jacobi as jbj
from krylov_spdes_tpu.precond import cholesky as jchol
from krylov_spdes_tpu.precond import simple as jsimple
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import sparse as tsparse
from krylov_spdes_tpu_torch.precond import amg as tamg
from krylov_spdes_tpu_torch.precond import block_jacobi as tbj
from krylov_spdes_tpu_torch.precond import cholesky as tchol
from krylov_spdes_tpu_torch.precond import simple as tsimple
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _system(n=2000, seed=0):
    mesh = get_mesh(n, jitter=0.2, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rng.normal(size=mesh.nnode)))
    return A, np.asarray(b), asm


@pytest.fixture(scope="module")
def system():
    Aj, b, asm = _system()
    At = convert.sparse_op(**convert.numpy_fields(Aj), **CPU64)
    r = np.random.default_rng(5).normal(size=b.shape[0])
    return Aj, At, b, r


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


def test_sparse_interop_matches_jax(system):
    Aj, At, b, r = system
    cj, ct = Aj.to_scipy(), At.to_scipy()
    np.testing.assert_array_equal(ct.indptr, cj.indptr)
    np.testing.assert_array_equal(ct.indices, cj.indices)
    np.testing.assert_array_equal(ct.data, cj.data)
    # from_scipy of a COO matrix with duplicates and unsorted entries
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 300, 4000), rng.integers(0, 250, 4000)
    m = sp.coo_matrix((rng.normal(size=4000), (rows, cols)), (300, 250))
    fj, ft = jsparse.from_scipy(m, dtype=jnp.float64), tsparse.from_scipy(
        m, **CPU64)
    for k, v in convert.numpy_fields(fj).items():
        np.testing.assert_array_equal(convert.numpy_fields(ft)[k], v, k)
    # the round trip SparseOp -> scipy -> SparseOp is exact
    back = tsparse.from_scipy(ct, **CPU64)
    for k, v in convert.numpy_fields(At).items():
        np.testing.assert_array_equal(convert.numpy_fields(back)[k], v, k)
    x = torch.as_tensor(r)
    y_csr = tsparse.csr_spmv(At, x).numpy()
    np.testing.assert_allclose(y_csr, tsparse.ell_spmv(At, x).numpy(),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        y_csr, np.asarray(jsparse.csr_spmv(Aj, jnp.asarray(r))), rtol=1e-14,
        atol=1e-14)
    # rows without entries give 0
    e = tsparse.from_scipy(sp.csr_matrix(([1.0], ([0], [1])), (3, 3)), **CPU64)
    assert tsparse.csr_spmv(e, torch.ones(3, dtype=torch.float64)).tolist() \
        == [1.0, 0.0, 0.0]


def _preconditioner_pairs(Aj, At):
    """(JAX preconditioner, port preconditioner, tolerance of the applies)
    by name."""
    # Chebyshev's window, given to both packages: λmax of D⁻¹A
    c = Aj.to_scipy()
    dh = sp.diags(1.0 / np.sqrt(c.diagonal()))
    lmax = float(eigsh(dh @ c @ dh, k=1, which="LA")[0][0])
    return {
        "chebyshev": (lambda: jsimple.chebyshev_precond(Aj, lmax_est=lmax),
                      lambda: tsimple.chebyshev_precond(At, lmax_est=lmax),
                      1e-10),
        "bj16": (lambda: jbj.block_jacobi_precond(Aj, 16),
                 lambda: tbj.block_jacobi_precond(At, 16), 1e-10),
        "chol64": (lambda: jchol.get_cholesky(Aj, jnp.float64),
                   lambda: tchol.get_cholesky(At, torch.float64), 1e-10),
        # a float32 factor: two LAPACKs' float32 Cholesky differ in their
        # last bits (2.6e-6 apart here, κ(A) ≈ 3e3); chol64 holds the same
        # code at float64
        "chol32": (lambda: jchol.get_cholesky32(Aj),
                   lambda: tchol.get_cholesky32(At), 1e-5),
        "chol16": (lambda: jchol.get_cholesky16(Aj),
                   lambda: tchol.get_cholesky16(At), 1e-2),
        "amg": (lambda: jamg.amg_precond(Aj), lambda: tamg.amg_precond(At),
                1e-10),
    }


NAMES = ["chebyshev", "bj16", "chol64", "chol32", "chol16", "amg"]


@pytest.mark.parametrize("name", NAMES)
def test_apply_and_pcg_match_jax(system, name):
    Aj, At, b, r = system
    build_j, build_t, tol = _preconditioner_pairs(Aj, At)[name]
    Mj, Mt = build_j(), build_t()
    zt = Mt(torch.as_tensor(r))
    assert zt.dtype == torch.float64
    assert _rel(zt.numpy(), Mj(jnp.asarray(r))) <= tol
    rj = j_pcg(Aj, jnp.asarray(b), M=Mj)
    rt = pcg(At, torch.as_tensor(b), M=Mt)
    assert abs(int(rt.it) - int(rj.it)) <= 1, (int(rt.it), int(rj.it))
    assert rt.history()[-1] <= 1e-7 * np.linalg.norm(b)


def test_amg_hierarchy_matches_jax(system):
    """The host setup is a copy: the same levels bit for bit. The port's
    V-cycle on the JAX package's hierarchy and on its own agree with the
    JAX V-cycle."""
    Aj, At, b, r = system
    hj = jamg.amg_setup(Aj.to_scipy())
    ht = tamg.amg_setup(At.to_scipy(), device="cpu")
    assert len(ht["levels"]) == len(hj["levels"]) >= 2
    for lt, lj in zip(ht["levels"], hj["levels"]):
        for key in ("A", "P", "R"):
            for f, v in convert.numpy_fields(lj[key]).items():
                np.testing.assert_array_equal(
                    convert.numpy_fields(lt[key])[f], v, f"{key}.{f}")
        np.testing.assert_array_equal(lt["dinv"].numpy(),
                                      np.asarray(lj["dinv"]))
    np.testing.assert_allclose(ht["coarse_L"].numpy(),
                               np.asarray(hj["coarse_L"]), rtol=1e-12,
                               atol=1e-14)
    zj = np.asarray(jamg._vcycle(1, 1, hj, 2.0 / 3.0, jnp.asarray(r)))
    carried = convert.amg_hierarchy(**hj, **CPU64)
    for hier in (carried, ht):
        zt = tamg._vcycle(1, 1, hier, 2.0 / 3.0, torch.as_tensor(r))
        assert _rel(zt.numpy(), zj) <= 1e-12
    # the banded option (tests/test_torch_banded.py holds it against JAX):
    # the same hierarchy, so the same V-cycle up to rounding
    hb = tamg.amg_setup(At.to_scipy(), matvec="banded", device="cpu")
    assert hb["perm0"] is not None and len(hb["levels"]) == len(ht["levels"])
    zb = tamg._vcycle(1, 1, hb, 2.0 / 3.0, torch.as_tensor(r))
    assert _rel(zb.numpy(), zj) <= 1e-12


def test_bj_plan_reuse_across_realizations():
    """A plan built on one realization serves another: the same blocks as a
    plan built afresh, and the same apply as the JAX package's (also from
    its own plan, carried across)."""
    Aj, b, asm = _system(800, seed=2)
    At = convert.sparse_op(**convert.numpy_fields(Aj), **CPU64)
    plan_j = jbj.prepare_block_jacobi_plan(Aj, 8)
    plan_t = tbj.prepare_block_jacobi_plan(At, 8)
    fj, ft = convert.numpy_fields(plan_j), convert.numpy_fields(plan_t)
    for k, v in fj.items():
        np.testing.assert_array_equal(np.asarray(ft[k]), np.asarray(v), k)
    rng = np.random.default_rng(3)
    A2j, b2 = do_isotropic_elliptic_assembly(
        asm, np.exp(rng.normal(size=int(np.asarray(asm.plan.cells).max())
                                + 1)))
    A2t = convert.sparse_op(**convert.numpy_fields(A2j), **CPU64)
    r = torch.as_tensor(np.random.default_rng(4).normal(size=At.n_rows))
    Mj = jbj.block_jacobi_precond(A2j, 8, plan=plan_j)
    zj = np.asarray(Mj(jnp.asarray(r.numpy())))
    for plan in (plan_t, convert.block_jacobi_plan(**fj, device="cpu")):
        Mt = tbj.block_jacobi_precond(A2t, 8, plan=plan)
        np.testing.assert_array_equal(
            tbj._factorize(A2t.data, plan).numpy(),
            tbj._factorize(A2t.data, tbj.prepare_block_jacobi_plan(
                A2t, 8)).numpy())
        assert _rel(Mt(r).numpy(), zj) <= 1e-10
    res = pcg(A2t, torch.as_tensor(np.asarray(b2)), M=Mt)
    assert res.history()[-1] <= 1e-7 * np.linalg.norm(np.asarray(b2))


def test_chebyshev_estimates_lmax_with_its_generator(system):
    """Without lmax_est each package draws its own power-iteration start
    (PRNGKey(0) / a seeded torch.Generator, by default seeded with 0): 12
    power iterations leave the two estimates apart, so only convergence and
    the port's own repeatability are held here."""
    Aj, At, b, r = system
    gen = torch.Generator().manual_seed(0)
    Mt = tsimple.chebyshev_precond(At, generator=gen)
    rt = pcg(At, torch.as_tensor(b), M=Mt)
    assert rt.history()[-1] <= 1e-7 * np.linalg.norm(b)
    assert int(rt.it) < int(pcg(At, torch.as_tensor(b)).it)
    z0 = Mt(torch.as_tensor(r))
    z1 = tsimple.chebyshev_precond(At)(torch.as_tensor(r))
    np.testing.assert_array_equal(z0.numpy(), z1.numpy())


@pytest.mark.parametrize("name", ["amg", "jacobi", "chebyshev"])
def test_block_apply_equals_column_applies(system, name):
    """A preconditioner applied to an (n, k) block equals its applies to the
    columns one by one (1e-12): the port's form of the JAX package's vmap
    over columns, which the HR recyclers' M(AV) and block_pcg's M(R) use.
    The AMG V-cycle's coarse solve takes the whole block."""
    _, At, _, r = system
    M = {"amg": lambda: tamg.amg_precond(At),
         "jacobi": lambda: tsimple.jacobi_precond(At),
         "chebyshev": lambda: tsimple.chebyshev_precond(At, lmax_est=2.0)}[
        name]()
    R = torch.tensor(np.random.default_rng(9).normal(size=(r.shape[0], 7)))
    Y = M(R)
    cols = torch.stack([M(R[:, j].contiguous()) for j in range(7)], dim=1)
    assert Y.shape == R.shape
    assert _rel(Y.numpy(), cols.numpy()) <= 1e-12
