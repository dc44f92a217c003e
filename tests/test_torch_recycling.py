"""PyTorch port, the recycling solvers (solvers/eig_common.py, eigcg.py,
defcg.py, initcg.py) against the JAX package in float64 on the systems of
tests/test_recycling.py: identical iteration counts, the same solutions,
residual histories and harvested subspaces.

Tolerances: the two packages sum their dot products in different orders
(BLAS against XLA's reduction), and CG amplifies that last-bit difference
as it iterates, so a residual history agrees to 1e-7 (relative) over its
first entries and drifts later, while x, which converges, agrees to 1e-8.
With the Jacobi preconditioner the first 25 entries hold 1e-7 and the whole
history stays within 25%. The unpreconditioned solves on these systems
(coefficient exp(N(0, ~1)), more iterations than unknowns' worth of
conditioning) hold 1e-14 for 15 entries, then the difference grows about
100x an iteration wherever the residual is not monotone (measured on the
eigCG case: 1e-12 at entry 16, 7e-2 at entry 23, back to 1e-9 at entry 27,
|log ratio| up to 0.58 later), so they are held to 1e-7 over 15 entries and
to a factor e over the whole history, with equal iteration counts. Harvested bases are compared as subspaces (cosines of the principal
angles), never column by column: eigh/svd vectors differ in sign and, in
clusters, by a rotation."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.solvers import eig_common as jec

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.solvers import eig_common as tec

# the packages' __init__ export functions named like these modules
jdef, jeig, jinit = (importlib.import_module(f"krylov_spdes_tpu.solvers.{m}")
                     for m in ("defcg", "eigcg", "initcg"))
tdef, teig, tinit = (
    importlib.import_module(f"krylov_spdes_tpu_torch.solvers.{m}")
    for m in ("defcg", "eigcg", "initcg"))

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
NVEC, SPDIM = 6, 16


def make_systems(nnode=250, n_sys=3, seed=0):
    """tests/test_recycling.py's sequence of correlated FEM systems, as
    (JAX operator, port operator, b) triples."""
    mesh = get_mesh(nnode, jitter=0.2, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(
        mesh.cells, mesh.points, maps,
        lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    g = rng.normal(size=mesh.nnode)
    out = []
    for _ in range(n_sys):
        g = 0.9 * g + 0.45 * rng.normal(size=mesh.nnode)
        A, b = do_isotropic_elliptic_assembly(asm, np.exp(g))
        At = convert.sparse_op(**convert.numpy_fields(A), **CPU64)
        out.append((A, At, np.asarray(b)))
    return out


def _dinv(A):
    return 1.0 / np.asarray(A.to_scipy().diagonal())


def _Mj(d):
    return Partial(lambda dd, r: dd * r, jnp.asarray(d))


def _Mt(d):
    dt = torch.tensor(d)
    return lambda r: dt * r


def cosines(Wa, Wb):
    """Cosines of the principal angles between span(Wa) and span(Wb)."""
    qa, _ = np.linalg.qr(np.asarray(Wa))
    qb, _ = np.linalg.qr(np.asarray(Wb))
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def _same(rt, rj, precond=True):
    head, drift = (25, 0.25) if precond else (15, 1.0)
    it = int(rj.it)
    xj = np.asarray(rj.x)
    if precond:
        assert int(rt.it) == it
        np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-8,
                                   atol=1e-10 * np.abs(xj).max())
    else:
        # the drifting history crosses the tolerance an iteration apart on
        # some of these systems (the JAX package's own tests allow 2 against
        # their oracle); x then agrees to the solve's tolerance, not beyond
        assert abs(int(rt.it) - it) <= 1, (int(rt.it), it)
        assert (np.linalg.norm(rt.x.numpy() - xj)
                <= 1e-6 * np.linalg.norm(xj))
    m = min(it, int(rt.it))
    ht, hj = rt.history()[:m], np.asarray(rj.res_norm)[:m]
    np.testing.assert_allclose(ht[:head], hj[:head], rtol=1e-7)
    assert np.max(np.abs(np.log(ht / hj))) < drift
    assert np.all(rt.res_norm.numpy()[int(rt.it):] == 0)


def _same_subspace(Wt, Wj, tol=1e-6):
    s = cosines(Wt.numpy(), Wj)
    assert s.min() > 1 - tol, s


def test_eigcg_matches_jax():
    (A, At, b), = make_systems(n_sys=1)
    rj = jeig.eigcg(A, b, nvec=NVEC, spdim=SPDIM)
    rt = teig.eigcg(At, torch.tensor(b), nvec=NVEC, spdim=SPDIM)
    _same(rt, rj, precond=False)
    # unpreconditioned, the drift reaches the harvested basis: the best
    # converged half of the directions agree (the JAX package's own test
    # holds all but the last to 0.8 against its oracle)
    s = np.sort(cosines(rt.W.numpy(), rj.W))
    assert s[NVEC // 2:].min() > 0.99, s


def test_eigpcg_matches_jax():
    (A, At, b), = make_systems(n_sys=1, seed=6)
    d = _dinv(A)
    rj = jeig.eigpcg(A, b, M=_Mj(d), nvec=NVEC, spdim=SPDIM)
    rt = teig.eigpcg(At, torch.tensor(b), M=_Mt(d), nvec=NVEC, spdim=SPDIM)
    _same(rt, rj)
    s = cosines(rt.W.numpy(), rj.W)
    assert np.sort(s)[1:].min() > 1 - 1e-6 and s.min() > 0.99, s


@pytest.mark.parametrize("precond", [False, True])
def test_defcg_defpcg_initcg_match_jax(precond):
    systems = make_systems(n_sys=2, seed=1 if not precond else 7)
    A0, _, b0 = systems[0]
    A1, A1t, b1 = systems[1]
    W = np.asarray(jeig.eigcg(A0, b0, nvec=NVEC, spdim=SPDIM).W)
    Wt, bt = torch.tensor(W), torch.tensor(b1)
    if precond:
        d = _dinv(A1)
        _same(tdef.defpcg(A1t, bt, W=Wt, M=_Mt(d)),
              jdef.defpcg(A1, b1, W=W, M=_Mj(d)))
        _same(tinit.initpcg(A1t, bt, W=Wt, M=_Mt(d)),
              jinit.initpcg(A1, b1, W=W, M=_Mj(d)))
    else:
        _same(tdef.defcg(A1t, bt, W=Wt), jdef.defcg(A1, b1, W=W),
              precond=False)
        _same(tinit.initcg(A1t, bt, W=Wt), jinit.initcg(A1, b1, W=W),
              precond=False)
    xg = tinit.deflated_guess(A1t.matvec, bt, torch.zeros_like(bt), Wt)
    np.testing.assert_allclose(
        xg.numpy(), np.asarray(jinit.deflated_guess(
            Partial(A1.matvec), jnp.asarray(b1), jnp.zeros_like(b1),
            jnp.asarray(W))), rtol=1e-9, atol=1e-12)


def test_eigdefcg_chain_matches_jax():
    systems = make_systems(n_sys=4, seed=4)
    A0, _, b0 = systems[0]
    Wj = jeig.eigcg(A0, b0, nvec=NVEC, spdim=SPDIM).W
    Wt = torch.tensor(np.asarray(Wj))
    for A, At, b in systems[1:]:
        rj = jdef.eigdefcg(A, b, W=Wj, spdim=SPDIM)
        rt = tdef.eigdefcg(At, torch.tensor(b), W=Wt, spdim=SPDIM)
        _same(rt, rj, precond=False)
        _same_subspace(rt.W, rj.W)
        # both chains go on from the JAX basis, so that each step compares
        # the two solvers on identical inputs
        Wj, Wt = rj.W, torch.tensor(np.asarray(rj.W))


@pytest.mark.parametrize("fused", [False, True])
def test_eigdefpcg_chain_matches_jax(fused):
    systems = make_systems(n_sys=3, seed=5 if not fused else 9)
    A0, _, b0 = systems[0]
    Wj = jeig.eigpcg(A0, b0, M=_Mj(_dinv(A0)), nvec=NVEC, spdim=SPDIM).W
    Wt = torch.tensor(np.asarray(Wj))
    for A, At, b in systems[1:]:
        d = _dinv(A)
        if fused:
            rj = jdef.eigdefpcg(A, b, Mdiag=jnp.asarray(d), W=Wj, spdim=SPDIM)
            rt = tdef.eigdefpcg(At, torch.tensor(b), Mdiag=torch.tensor(d),
                                W=Wt, spdim=SPDIM)
        else:
            rj = jdef.eigdefpcg(A, b, M=_Mj(d), W=Wj, spdim=SPDIM)
            rt = tdef.eigdefpcg(At, torch.tensor(b), M=_Mt(d), W=Wt,
                                spdim=SPDIM)
        _same(rt, rj)
        _same_subspace(rt.W, rj.W)
        Wj, Wt = rj.W, torch.tensor(np.asarray(rj.W))


def test_eigdefpcg_minimum_spdim_restarts_match_jax():
    """spdim = 2·nvec + 1 forces a restart every iteration or two."""
    systems = make_systems(n_sys=2, seed=2)
    A0, _, b0 = systems[0]
    A1, A1t, b1 = systems[1]
    nvec, spdim = 4, 9
    Wj = jeig.eigpcg(A0, b0, M=_Mj(_dinv(A0)), nvec=nvec, spdim=spdim).W
    d = _dinv(A1)
    rj = jdef.eigdefpcg(A1, b1, Mdiag=jnp.asarray(d), W=Wj, spdim=spdim)
    rt = tdef.eigdefpcg(A1t, torch.tensor(b1), Mdiag=torch.tensor(d),
                        W=torch.tensor(np.asarray(Wj)), spdim=spdim)
    _same(rt, rj)
    _same_subspace(rt.W, rj.W)


@pytest.mark.parametrize("active,batched", [(16, False), (11, False),
                                            (16, True)])
def test_thick_restart_basis_matches_jax(active, batched):
    """On a projected matrix of the shape the solvers build (diagonal block
    of Ritz values, then a tridiagonal): nev equal, vals to 1e-10, the span
    of QZ equal."""
    rng = np.random.default_rng(active)
    nb = 3 if batched else 1
    Ts = []
    for _ in range(nb):
        T = np.zeros((SPDIM, SPDIM))
        T[np.arange(2 * NVEC), np.arange(2 * NVEC)] = np.sort(
            rng.random(2 * NVEC)) + 0.1
        for i in range(2 * NVEC, SPDIM):
            T[i, i] = 1.0 + rng.random()
            T[i - 1, i] = -0.3 * rng.random()
        T[:NVEC, 2 * NVEC:] = 0.05 * rng.normal(size=(NVEC, SPDIM - 2 * NVEC))
        Ts.append(T)
    T = np.stack(Ts) if batched else Ts[0]
    out_t = tec.thick_restart_basis(torch.tensor(T), NVEC, active)
    for c in range(nb):
        vj, QZj, nevj = jec.thick_restart_basis(jnp.asarray(Ts[c]), NVEC,
                                                jnp.int32(active))
        vt, QZt, nevt = (o[c] if batched else o for o in out_t)
        assert int(nevt) == int(nevj)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10,
                                   atol=1e-12)
        nev = int(nevj)
        assert np.all(QZt.numpy()[:, nev:] == 0)
        s = cosines(QZt.numpy()[:, :nev], np.asarray(QZj)[:, :nev])
        assert s.min() > 1 - 1e-10, s


def test_eig_common_small_pieces_match_jax():
    rng = np.random.default_rng(3)
    T = rng.normal(size=(7, 7))
    np.testing.assert_array_equal(tec._sym(torch.tensor(T)).numpy(),
                                  np.asarray(jec._sym(jnp.asarray(T))))
    np.testing.assert_allclose(tec._spd_ridge(torch.tensor(T)).numpy(),
                               np.asarray(jec._spd_ridge(jnp.asarray(T))),
                               rtol=1e-15)
    S = T @ T.T
    active = np.arange(7) < 5
    Sm = S * active[:, None] * active[None, :]
    Ut = tec.masked_least_eigvecs(torch.tensor(Sm), 2, torch.tensor(active))
    Uj = jec.masked_least_eigvecs(jnp.asarray(Sm), 2, jnp.asarray(active))
    assert cosines(Ut.numpy(), Uj).min() > 1 - 1e-10
    assert np.all(np.abs(Ut.numpy()[5:]) < 1e-12)
    s = np.array([3.0, 1.0, 1e-3, 1e-17])
    assert int(tec.matrix_rank_tol(torch.tensor(s), 16, 12)) == int(
        jec.matrix_rank_tol(jnp.asarray(s), 16, 12)) == 3


def test_bf16_rounding_of_the_basis_matches_jax_in_float32():
    """basis_dtype=bfloat16 on the fused path, float32: JAX rounds G, W, r
    and the coefficients to bf16 and accumulates in float32; the port
    rounds the same operands and multiplies them in float32. The two
    float32 solves agree as far as float32 sums in another order allow: it
    within 2, x to 2e-3 relative (measured below 1e-3)."""
    systems = make_systems(n_sys=2, seed=9)
    A0, _, b0 = systems[0]
    A1, A1t, b1 = systems[1]
    f32 = jnp.float32
    Wj = jeig.eigpcg(A0, b0, M=_Mj(_dinv(A0)), nvec=NVEC, spdim=SPDIM).W
    d = _dinv(A1)
    A32 = A1.with_data(A1.data.astype(f32))
    out_j = jdef._eigdef_impl(
        Partial(A32.matvec), Partial(lambda r: r), jnp.asarray(b1, f32),
        jnp.zeros_like(b1, f32), Wj.astype(f32), NVEC, SPDIM, 250, 1e-5,
        True, True, jnp.asarray(d, f32), jnp.bfloat16)
    At32 = convert.sparse_op(**convert.numpy_fields(A1), device="cpu",
                             dtype=torch.float32)
    bt = torch.tensor(b1, dtype=torch.float32)
    out_t = tdef._eigdef_impl(
        At32.matvec, lambda r: r, bt, torch.zeros_like(bt),
        torch.tensor(np.asarray(Wj), dtype=torch.float32), NVEC, SPDIM, 250,
        1e-5, True, True, torch.tensor(d, dtype=torch.float32),
        torch.bfloat16)
    assert out_t[0].dtype == torch.float32 and out_t[3].dtype == torch.float32
    assert abs(out_t[1] - int(out_j[1])) <= 2, (out_t[1], int(out_j[1]))
    xj = np.asarray(out_j[0])
    assert np.linalg.norm(out_t[0].numpy() - xj) <= 2e-3 * np.linalg.norm(xj)
    # and it is the rounding that was asked for, not the full-precision path
    full = tdef._eigdef_impl(
        At32.matvec, lambda r: r, bt, torch.zeros_like(bt),
        torch.tensor(np.asarray(Wj), dtype=torch.float32), NVEC, SPDIM, 250,
        1e-5, True, True, torch.tensor(d, dtype=torch.float32), None)
    assert not torch.equal(full[2], out_t[2])


@pytest.mark.parametrize("dead,frac", [(0, 0.9), (1, 0.9), (3, 0.9), (3, 0.5)])
def test_check_w_rank_matches_jax(dead, frac):
    """The basis-health guard: the same verdict as the JAX package's on a
    basis with `dead` duplicated columns."""
    from krylov_spdes_tpu.solvers import check_w_rank as j_check
    from krylov_spdes_tpu_torch.solvers import check_w_rank as t_check
    W = np.random.default_rng(0).normal(size=(60, 8))
    W[:, :dead] = W[:, -1:]
    assert t_check(torch.tensor(W), frac) == bool(j_check(jnp.asarray(W), frac))
    assert t_check(torch.tensor(W), frac) == (8 - dead >= frac * 8)
