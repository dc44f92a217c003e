"""PyTorch port, quantization of the latent space and the preconditioner
banks (quantization/quantizers.py, quantization/precond_bank.py) against
the JAX package: float64 on the CPU; where the JAX package draws from
jax.random, its draws (samples, k-means start indices) are handed to the
port (tests/test_quantization.py's cases)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           get_mass_matrix,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.kl.covariance import make_cov
from krylov_spdes_tpu.kl.single import solve_kl
from krylov_spdes_tpu.kl.synthesis import set_field as j_set_field
from krylov_spdes_tpu.precond import amg as jamg
from krylov_spdes_tpu.precond import block_tridiag_chol as jbtc
from krylov_spdes_tpu.precond import cholesky as jchol
from krylov_spdes_tpu.quantization import precond_bank as jbank
from krylov_spdes_tpu.quantization import quantizers as jq
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import fem
from krylov_spdes_tpu_torch.precond import (amg_precond, get_cholesky32,
                                            jacobi_precond)
from krylov_spdes_tpu_torch.precond.block_tridiag_chol import \
    get_banded_cholesky
from krylov_spdes_tpu_torch.quantization import precond_bank as tbank
from krylov_spdes_tpu_torch.quantization import quantizers as tq
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
DISTANCES = ["L2-full", "L2-10%", "cdf"]


def _lam(m=8):
    return np.exp(-0.5 * np.arange(m))


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _jax_start(n, P, key=None):
    """get_quantizer's draws in the JAX package: its samples' key and its
    k-means start indices (quantizers.py:83-86)."""
    key = jax.random.PRNGKey(987_654_321) if key is None else key
    key, k1, k2 = jax.random.split(key, 3)
    return np.array(jax.random.choice(k2, n, (P,), replace=False))


@pytest.mark.parametrize("dist", DISTANCES)
def test_transform_and_kmeans_match_jax(dist):
    """The metric transform, and Lloyd k-means from the same start indices
    (rtol 1e-10); the last sweep's cost; the inverse map."""
    lam = _lam()
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2000, 8)))
    Xtj, invj = jq._transform(jnp.asarray(X), lam, dist)
    Xtt, invt = tq._transform(_t(X), _t(lam), dist)
    np.testing.assert_allclose(Xtt.numpy(), np.asarray(Xtj), rtol=1e-14,
                               atol=1e-15)
    idx = np.array(jax.random.choice(jax.random.PRNGKey(3), 2000, (6,),
                                       replace=False))
    Cj, hj = jq._lloyd(Xtj, Xtj[idx], 50)
    Ct, wt = tq.kmeans(Xtt, 6, iters=50, idx0=idx)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(wt), float(hj[-1]), rtol=1e-10)
    np.testing.assert_allclose(invt(Ct).numpy(), np.asarray(invj(Cj)),
                               rtol=1e-9, atol=1e-10)
    # k-means lowers the distortion, and more centroids lower it further
    C1, _ = tq.kmeans(Xtt, 6, iters=1, idx0=idx)
    assert float(tq.distortion(Xtt, Ct)) <= float(tq.distortion(Xtt, C1))
    C12, _ = tq.kmeans(Xtt, 12, iters=50,
                       generator=torch.Generator().manual_seed(0))
    assert float(tq.distortion(Xtt, C12)) < float(tq.distortion(Xtt, Ct))


@pytest.mark.parametrize("dist", DISTANCES)
def test_get_quantizer_matches_jax(dist):
    """get_quantizer from the JAX package's samples and start indices: the
    same centroids (rtol 1e-9), assignments and costs (rtol 1e-9)."""
    lam = _lam()
    Xj, Cj, aj, cj = jq.get_quantizer(1000, 10, lam, distance=dist)
    X, C, a, c = tq.get_quantizer(1000, 10, _t(lam), distance=dist,
                                  X=np.asarray(Xj),
                                  idx0=_jax_start(1000, 10), **CPU64)
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-9,
                               atol=1e-12)
    # from a generator: seeded, repeatable, well formed
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    X1, C1, a1, c1 = tq.get_quantizer(1000, 10, _t(lam), distance=dist,
                                      generator=g(), **CPU64)
    X2, C2, _, _ = tq.get_quantizer(1000, 10, _t(lam), distance=dist,
                                    generator=g(), **CPU64)
    assert torch.equal(X1, X2) and torch.equal(C1, C2)
    assert C1.shape[0] == 10 and bool((c1 >= 0).all())
    assert len(torch.unique(a1)) > 1


def test_clvq_and_gains_match_jax():
    """The gain sequence, and CLVQ over the same stream from the same start
    (rtol 1e-12): the loop keeps the scan's order. CLVQ within 3× k-means'
    distortion (tests/test_quantization.py's)."""
    lam = _lam(4)
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4000, 4))
                   * jnp.sqrt(jnp.asarray(lam)))
    gj = jq.get_gain_sequence(1.0, 0.1, 0.2, 0.51, 4000)
    gt = tq.get_gain_sequence(1.0, 0.1, 0.2, 0.51, 4000, **CPU64)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-15)
    Cj, cj = jq.clvq(jnp.asarray(X), jnp.asarray(X[:8]), gj)
    Ct, ct = tq.clvq(_t(X), _t(X[:8]), gt)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12,
                               atol=1e-14)
    w_clvq = float(tq.distortion(_t(X), Ct))
    np.testing.assert_allclose(w_clvq, float(jq.distortion(jnp.asarray(X),
                                                           Cj)), rtol=1e-12)
    Ck, _ = tq.kmeans(_t(X), 8, iters=50,
                      generator=torch.Generator().manual_seed(0))
    assert w_clvq < 3.0 * float(tq.distortion(_t(X), Ck))


@pytest.mark.parametrize("nKL,s", [(3, 1.0), (4, 0.5)])
def test_deterministic_grid_and_nearest_centroid(nKL, s):
    lam = _lam(nKL + 2)
    eta, xi = tq.deterministic_grid(nKL, s, _t(lam))
    eta_j, xi_j = jq.deterministic_grid(nKL, s, lam)
    np.testing.assert_array_equal(xi, xi_j)
    np.testing.assert_array_equal(eta, eta_j)
    assert xi.shape == (2 ** nKL + 1, nKL) and np.all(xi[0] == 0)
    rng = np.random.default_rng(nKL)
    for _ in range(5):
        x = rng.normal(size=nKL)
        pt, dt = tq.nearest_centroid(_t(x), _t(xi), _t(lam[:nKL]))
        pj, dj = jq.nearest_centroid(jnp.asarray(x), jnp.asarray(xi),
                                     jnp.asarray(lam[:nKL]))
        assert int(pt) == int(pj)
        np.testing.assert_allclose(float(dt), float(dj), rtol=1e-14)


@pytest.fixture(scope="module")
def pipeline():
    """tests/test_quantization.py's Example 12/20 system: get_mesh(300), the
    JAX package's KL basis handed to both, its quantizer's centroids."""
    mesh = get_mesh(300, seed=0)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    f = lambda x, y: -1.0 + 0.0 * x  # noqa: E731
    u = lambda x, y: 0.0 * x  # noqa: E731
    asm_j = prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f, u)
    asm_t = fem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f, u,
                                          **CPU64)
    lam, psi = solve_kl(mesh.cells, mesh.points, make_cov("sexp", 1.0, 0.5),
                        10, get_mass_matrix(mesh.cells, mesh.points),
                        relative=0.999)
    lam, psi = np.asarray(lam), np.asarray(psi)
    _, cent, _, _ = jq.get_quantizer(400, 5, lam)
    cent = np.asarray(cent)
    xi = cent[2] + 0.05 * np.random.default_rng(0).normal(size=lam.shape[0])
    return dict(asm_j=asm_j, asm_t=asm_t, lam=lam, psi=psi, cent=cent, xi=xi)


FACTORIES = {
    "cholesky32": (jchol.get_cholesky32, get_cholesky32, 1),
    "banded": (partial(jbtc.get_banded_cholesky, dtype=jnp.float64),
               partial(get_banded_cholesky, dtype=torch.float64,
                       out_dtype=torch.float64, device="cpu"), 0),
    "amg": (jamg.amg_precond, amg_precond, 0),
}


@pytest.mark.parametrize("factory", list(FACTORIES))
def test_precond_bank_matches_jax(pipeline, factory):
    """Example 12/20's flow on both packages with each factory: the
    centroidal bank, nearest selection (the centroid the sample was drawn
    beside), the solve with the selected preconditioner (`it` equal to the
    JAX package's, ±1 for the float32 Cholesky factor of two LAPACKs, and
    below Jacobi's), Shepard's combination of the bank (Λ weights) and the
    truncated-KL preconditioner (k = 3), each converging with the JAX
    package's `it` (same allowance)."""
    p = pipeline
    fj, ft, slack = FACTORIES[factory]
    lam, psi, cent, xi = p["lam"], p["psi"], p["cent"], p["xi"]

    def assemble_j(c):
        return do_isotropic_elliptic_assembly(p["asm_j"], c)[0]

    def assemble_t(c):
        return fem.do_isotropic_elliptic_assembly(p["asm_t"], c)[0]

    bank_j = jbank.build_centroidal_preconds(cent, lam, psi, assemble_j, fj)
    bank_t = tbank.build_centroidal_preconds(cent, _t(lam), _t(psi),
                                             assemble_t, ft)
    Mj, pj, dj = jbank.select_nearest(bank_j, xi, cent, lam)
    Mt, pt, dt = tbank.select_nearest(bank_t, _t(xi), _t(cent), _t(lam))
    assert pt == pj == 2 and dt == dj

    g = j_set_field(jnp.asarray(lam), jnp.asarray(psi), jnp.asarray(xi))
    Aj, bj = do_isotropic_elliptic_assembly(p["asm_j"], jnp.exp(g))
    At, bt = fem.do_isotropic_elliptic_assembly(p["asm_t"],
                                                torch.exp(_t(np.asarray(g))))
    b = bt.numpy()

    def check(Mt_, Mj_):
        rt, rj = pcg(At, bt, M=Mt_), j_pcg(Aj, bj, M=Mj_)
        assert rt.converged(b) and abs(int(rt.it) - int(rj.it)) <= slack, \
            (int(rt.it), int(rj.it))
        return int(rt.it)

    it_q = check(Mt, Mj)
    assert it_q < int(pcg(At, bt, M=jacobi_precond(At)).it)
    check(tbank.shepard_interpolating_precond(_t(xi), _t(cent), bank_t,
                                              _t(lam)),
          jbank.shepard_interpolating_precond(xi, cent, bank_j, lam))
    check(tbank.truncated_kl_precond(_t(lam), _t(psi), 3, assemble_t, ft,
                                     xi=_t(xi)),
          jbank.truncated_kl_precond(lam, psi, 3, assemble_j, fj, xi=xi))


def test_shepard_weights_match_jax(pipeline):
    """Shepard's coefficients under both distances: the combination of
    three fixed applies (scalings of r) equals the JAX package's."""
    p = pipeline
    cent, xi, lam = p["cent"], p["xi"], p["lam"]
    bank_t = [partial(lambda s, r: s * r, float(k + 1))
              for k in range(cent.shape[0])]
    bank_j = [partial(lambda s, r: s * r, float(k + 1))
              for k in range(cent.shape[0])]
    r = np.random.default_rng(4).normal(size=30)
    for dist in ("L2-full", "cdf"):
        Mt = tbank.shepard_interpolating_precond(_t(xi), _t(cent), bank_t,
                                                 _t(lam), distance=dist)
        Mj = jbank.shepard_interpolating_precond(xi, cent, bank_j, lam,
                                                 distance=dist)
        np.testing.assert_allclose(Mt(_t(r)).numpy(),
                                   np.asarray(Mj(jnp.asarray(r))),
                                   rtol=1e-14)
    with pytest.raises(ValueError):
        tbank.shepard_interpolating_precond(xi, cent, bank_t, lam,
                                            distance="L1")
