"""PyTorch port, stretch-wise eigDef-PCG (ops/vmem_eigdef.py, the module
that holds kernel E) against the JAX package in float64. The JAX side runs
its Pallas stretch kernel in interpret mode, as tests/test_vmem_eigdef.py
does; the port runs the kernel's plain version (the CUDA kernel itself is
held against it on the card in tests/test_torch_kernels.py). Harvested
bases are compared as subspaces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops import fused_cg as jfc
from krylov_spdes_tpu.ops import stencil as jst
from krylov_spdes_tpu.ops import vmem_eigdef as jve
from krylov_spdes_tpu.solvers.defcg import eigdefpcg as j_eigdefpcg

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import fused_cg as tfc
from krylov_spdes_tpu_torch.ops import vmem_eigdef as tve
from krylov_spdes_tpu_torch.solvers.defcg import eigdefpcg as t_eigdefpcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _setup(nn=900, jitter=0.2, seed=3, coeff_seed=0):
    mesh = get_mesh(nn, jitter=jitter, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(
        mesh.cells, mesh.points, maps,
        lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x)
    rng = np.random.default_rng(coeff_seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    Sj = jst.build_stencil_op(A, maps, (m1, m1))
    bj = jst.to_full_vector(maps, jnp.asarray(b), mesh.nnode)
    St = convert.stencil_op(**convert.numpy_fields(Sj), **CPU64)
    return mesh, maps, Sj, bj, St, torch.tensor(np.asarray(bj))


def _cosines(Wa, Wb):
    qa, _ = np.linalg.qr(np.asarray(Wa))
    qb, _ = np.linalg.qr(np.asarray(Wb))
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def _random_basis(mesh, maps, nvec, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(mesh.nnode, nvec)) * (~maps.is_dirichlet)[:, None]


class _Counts:
    """Counts the stretches (calls of the kernel's plain version, which the
    wrapper takes on CPU tensors) and the thick restarts of the solves run
    while it is installed."""

    def __init__(self, monkeypatch):
        self.stretches = 0
        self._restarts0 = tve._restart_iteration.calls
        plain = tve.stretch_plain

        def counted(*args):
            self.stretches += 1
            return plain(*args)
        monkeypatch.setattr(tve, "stretch_plain", counted)

    @property
    def restarts(self):
        return tve._restart_iteration.calls - self._restarts0


@pytest.fixture
def counts(monkeypatch):
    return _Counts(monkeypatch)


def _compare(Sj, bj, St, bt, W, spdim):
    psj = jfc.build_padded_stencil(Sj, tb=16)
    xj, itj, resj, Wnj = jve.vmem_eigdefpcg(psj, bj, jnp.asarray(W),
                                            spdim=spdim, maxit=400,
                                            interpret=True)
    pst = tfc.build_padded_stencil(St)
    xt, itt, rest, Wnt = tve.vmem_eigdefpcg(
        pst, bt, convert.deflation_basis(W, **CPU64), spdim=spdim, maxit=400)
    it = int(itj)
    assert int(itt) == it
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(rest.numpy()[:it], np.asarray(resj)[:it],
                               rtol=1e-7)
    assert np.all(rest.numpy()[it:] == 0)
    # subspace angles to 1e-6
    s = _cosines(Wnt.numpy(), Wnj)
    assert s.min() > 1 - 1e-6, s
    # and the port's stretch path is the port's fused eigDef-PCG
    ref = t_eigdefpcg(St, bt, W=convert.deflation_basis(W, **CPU64),
                      spdim=spdim, maxit=400, Mdiag=1.0 / St.diagonal())
    assert int(ref.it) == it
    np.testing.assert_allclose(xt.numpy(), ref.x.numpy(), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("nvec,spdim", [(4, 12), (8, 20)])
def test_vmem_eigdefpcg_matches_jax(nvec, spdim, counts):
    """Chain semantics: a first solve harvests W, the second deflates with
    it. Iterations, solution, residual history and the harvested subspace."""
    mesh, maps, Sj, bj, St, bt = _setup()
    dinv = 1.0 / Sj.diagonal()
    W0 = jnp.asarray(_random_basis(mesh, maps, nvec, 1))
    W = np.asarray(j_eigdefpcg(Sj, bj, W=W0, spdim=spdim, maxit=400,
                               Mdiag=dinv).W)
    _compare(Sj, bj, St, bt, W, spdim)
    # one read-back per stretch: far fewer stretches than iterations
    assert counts.stretches >= 2 and counts.restarts >= 1


def test_vmem_eigdefpcg_restart_path_matches_jax(counts):
    """spdim = 2·nvec + 1 forces a thick restart after every stretch of at
    most a few iterations (defcg.jl:428-436)."""
    mesh, maps, Sj, bj, St, bt = _setup(seed=5, coeff_seed=7)
    _compare(Sj, bj, St, bt, _random_basis(mesh, maps, 4, 2), 9)
    assert counts.restarts > 10


def test_one_stretch_matches_the_pallas_kernel():
    """One stretch alone: the same operands into the JAX package's
    `_stretch_call(interpret=True)` and into `stretch_plain`, carried
    between the two padded layouts through each side's unpad/pad."""
    mesh, maps, Sj, bj, St, bt = _setup()
    nvec, spdim, nsteps = 4, 14, 7
    n = mesh.nnode
    psj = jfc.build_padded_stencil(Sj, tb=16)
    pst = tfc.build_padded_stencil(St)
    Rj, Cj = psj.R, psj.C
    rng = np.random.default_rng(5)
    free = (~maps.is_dirichlet).astype(float)

    def rows(k):
        return rng.normal(size=(k, n)) * free[None, :]

    # well-scaled random operands: the kernel's arithmetic, not a solve
    G, A1, B = rows(2 * nvec) * 1e-2, rows(nvec) * 1e-2, rows(2 * nvec) * 1e-2
    x, r, p = rows(1)[0], rows(1)[0], rows(1)[0]
    V = np.zeros((spdim, n))
    V[:nvec + 1] = rows(nvec + 1)
    minv_full = 1.0 / np.asarray(Sj.diagonal())
    rTz = float(r @ (minv_full * r))
    res2_prev = float(r @ r)
    tol2 = 1e-30

    def padj(a):
        return jnp.concatenate([jfc.pad_vec(psj, jnp.asarray(v)) for v in a])

    planes_j = jfc._unblock_planes(psj)
    minv_j = jfc._jacobi_minv(psj, planes_j, None)
    out_j = jve._stretch_call(
        nvec, spdim, Rj, Cj, psj.K, planes_j, minv_j, padj(G), padj(A1),
        padj(B), jfc.pad_vec(psj, jnp.asarray(x)),
        jfc.pad_vec(psj, jnp.asarray(r)), jfc.pad_vec(psj, jnp.asarray(p)),
        padj(V), jnp.asarray(tol2), jnp.asarray(rTz), jnp.asarray(res2_prev),
        jnp.int32(nsteps), jnp.int32(nvec), interpret=True)

    def unj(a, k):
        a = np.asarray(a).reshape(k, Rj, Cj)
        return np.stack([np.asarray(jfc.unpad_vec(psj, jnp.asarray(g)))
                         for g in a])

    pg = lambda a: convert.padded_grids(pst, a, **CPU64)  # noqa: E731
    minv_t = tfc._jacobi_minv(pst, tfc._unblock_planes(pst), None)
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    out_t = tve.stretch(pst, minv_t, pg(G), pg(A1), pg(B), pg(x[None])[0],
                        pg(r[None])[0], pg(p[None])[0], pg(V), t(tol2),
                        t(rTz), t(res2_prev), nsteps, nvec)
    assert int(out_t[7]) == int(out_j[7]) == nsteps and bool(out_t[9])
    for k in range(3):                                   # x, r, p
        np.testing.assert_allclose(
            convert.full_rows(pst, out_t[k][None])[0], unj(out_j[k], 1)[0],
            rtol=1e-9, atol=1e-12)
    Vt, Vj = convert.full_rows(pst, out_t[3]), unj(out_j[3], spdim)
    np.testing.assert_allclose(Vt, Vj, rtol=1e-9, atol=1e-12)
    # only the appended columns changed
    np.testing.assert_array_equal(Vt[:nvec + 1], V[:nvec + 1])
    assert np.all(Vt[nvec + 1 + nsteps:] == 0) and Vt[nvec + nsteps].any()
    for k in (4, 5, 6):                                  # α, β, ‖r‖²
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-9)
    np.testing.assert_allclose(float(out_t[8]), float(out_j[8]), rtol=1e-9)
    # preset of the streamed scalars beyond cnt: 1, 0, 0
    assert np.all(out_t[4].numpy()[nsteps:] == 1)
    assert np.all(out_t[5].numpy()[nsteps:] == 0)
    assert np.all(out_t[6].numpy()[nsteps:] == 0)


def test_stretch_stops_on_the_tolerance_and_on_nsteps(counts):
    mesh, maps, Sj, bj, St, bt = _setup()
    pst = tfc.build_padded_stencil(St)
    nvec, spdim = 4, 80
    W = convert.deflation_basis(_random_basis(mesh, maps, nvec, 1), **CPU64)
    # run the solver's own setup by asking for one stretch of a real solve
    x, it, res, _ = tve.vmem_eigdefpcg(pst, bt, W, spdim=spdim, maxit=12)
    assert int(it) == 12
    assert (counts.stretches, counts.restarts) == (1, 0)
    assert np.all(res.numpy()[:12] > 0)
    x, it, res, _ = tve.vmem_eigdefpcg(pst, bt, W, spdim=spdim, maxit=400,
                                       rtol=1e-2)
    h = res.numpy()[:int(it)]
    tol = 1e-2 * float(torch.linalg.vector_norm(bt))
    assert h[-1] <= tol and np.all(h[:-1] > tol)
    assert (counts.stretches, counts.restarts) == (2, 0)
    assert int(it) < spdim - nvec
