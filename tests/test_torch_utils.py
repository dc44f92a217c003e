"""PyTorch port, utils/ (metrics.py, persistence.py, diagnostics.py) against
the JAX package: float64 on the CPU. The NPZ files are cross-loaded both
ways (tests/test_persistence.py's layouts), the chain checkpoint resumes a
port chain exactly, and the spectral diagnostics run from the JAX package's
start vector (tests/test_diagnostics.py's systems)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.precond import amg as jamg
from krylov_spdes_tpu.precond.simple import jacobi_precond as j_jacobi
from krylov_spdes_tpu.samplers import samplers as jsamplers
from krylov_spdes_tpu.utils import diagnostics as jdiag
from krylov_spdes_tpu.utils import persistence as jpers

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.precond import amg_precond, jacobi_precond
from krylov_spdes_tpu_torch.samplers import samplers as tsamplers
from krylov_spdes_tpu_torch.utils import diagnostics as tdiag
from krylov_spdes_tpu_torch.utils import metrics as tmetrics
from krylov_spdes_tpu_torch.utils import persistence as tpers

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _system(n, seed, jitter=0.2):
    mesh = get_mesh(n, jitter=jitter, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    Aj, b = do_isotropic_elliptic_assembly(
        asm, np.exp(rng.normal(size=mesh.nnode)))
    At = convert.sparse_op(**convert.numpy_fields(Aj), **CPU64)
    return Aj, At, np.array(b)


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_system_files_cross_load(tmp_path):
    """save_system / save_deflated_system of either package load in the
    other with equal arrays, and hold the same NPZ fields."""
    Aj, At, b = _system(300, seed=40, jitter=0.25)
    W = np.random.default_rng(0).normal(size=(b.shape[0], 5))
    bt, Wt = torch.as_tensor(b), torch.as_tensor(W)
    tpers.save_system(str(tmp_path / "t_sys.npz"), At, bt)
    jpers.save_system(str(tmp_path / "j_sys.npz"), Aj, b)
    tpers.save_deflated_system(str(tmp_path / "t_defl.npz"), At, bt, Wt)
    jpers.save_deflated_system(str(tmp_path / "j_defl.npz"), Aj, b, W)
    for name in ("sys", "defl"):
        ft, fj = (np.load(tmp_path / f"{k}_{name}.npz") for k in "tj")
        assert sorted(ft.files) == sorted(fj.files)
        for k in fj.files:
            assert ft[k].dtype == fj[k].dtype, k
            np.testing.assert_array_equal(ft[k], fj[k], k)
    ref = Aj.to_scipy()
    for load in (tpers.load_system, jpers.load_system):
        for who in "tj":
            A2, b2 = load(str(tmp_path / f"{who}_sys.npz"))
            _same_csr(A2, ref)
            np.testing.assert_array_equal(b2, b)
    for load in (tpers.load_deflated_system, jpers.load_deflated_system):
        for who in "tj":
            A2, b2, W2 = load(str(tmp_path / f"{who}_defl.npz"))
            _same_csr(A2, ref)
            np.testing.assert_array_equal(b2, b)
            np.testing.assert_array_equal(W2, W)


def _basis(seed=2):
    rng = np.random.default_rng(seed)
    lam = np.sort(rng.uniform(0.1, 1.0, 6))[::-1].copy()
    return lam, rng.normal(size=(40, 6)), rng


def test_chain_checkpoint_resumes_exactly(tmp_path):
    """A port chain checkpointed after 3 draws and resumed from disk into a
    state of another seed continues bit for bit like the uninterrupted one
    (tests/test_persistence.py's case); W and the counts come back."""
    lam, psi, rng = _basis()
    s = tsamplers.prepare_mcmc_sampler(lam, psi, key=5, **CPU64)
    for _ in range(3):
        s, _ = tsamplers.draw(s)
    W = torch.as_tensor(rng.normal(size=(40, 4)))
    p = str(tmp_path / "chain.npz")
    tpers.save_chain_checkpoint(p, s, W, sample_idx=3, iters=[10, 8, 7])
    assert sorted(np.load(p).files) == sorted(
        ["xi", "g", "key", "W", "sample_idx", "iters"])
    cont = [s]
    for _ in range(4):
        cont.append(tsamplers.draw(cont[-1])[0])
    template = tsamplers.prepare_mcmc_sampler(lam, psi, key=0, **CPU64)
    s2, W2, idx, iters = tpers.load_chain_checkpoint(p, template)
    assert idx == 3 and list(iters) == [10, 8, 7]
    assert torch.equal(W2, W)
    for want in cont[1:]:
        s2, _ = tsamplers.draw(s2)
        assert torch.equal(s2.xi, want.xi) and torch.equal(s2.g, want.g)


def test_jax_chain_checkpoint_needs_a_generator(tmp_path):
    """A JAX checkpoint's key cannot seed a torch generator: refused with a
    clear error, and loaded (ξ, g and W equal) when a generator is given."""
    lam, psi, rng = _basis()
    s = jsamplers.prepare_mcmc_sampler(lam, psi, key=5)
    s, _ = jsamplers.draw(s)
    W = rng.normal(size=(40, 4))
    p = str(tmp_path / "jchain.npz")
    jpers.save_chain_checkpoint(p, s, W, sample_idx=1, iters=[12])
    template = tsamplers.prepare_mcmc_sampler(lam, psi, key=0, **CPU64)
    with pytest.raises(ValueError, match="generator="):
        tpers.load_chain_checkpoint(p, template)
    gen = torch.Generator().manual_seed(11)
    s2, W2, idx, _ = tpers.load_chain_checkpoint(p, template, generator=gen)
    assert s2.gen is gen and idx == 1
    np.testing.assert_array_equal(s2.xi.numpy(), np.asarray(s.xi))
    np.testing.assert_array_equal(s2.g.numpy(), np.asarray(s.g))
    np.testing.assert_array_equal(W2.numpy(), W)
    tsamplers.draw(s2)


def test_preconditioned_spectrum_matches_jax():
    """The dense spectrum of M⁻¹A (one block apply of A, then of M) against
    the JAX package's (rtol 1e-10), with and without Jacobi; Lanczos from
    the JAX package's start vector gives its (λmin, λmax, κ) (rtol 1e-8),
    brackets the true spectrum and captures λmax (tests/
    test_diagnostics.py's limits)."""
    Aj, At, _ = _system(400, seed=0)
    for Mj, Mt in ((None, None), (j_jacobi(Aj), jacobi_precond(At))):
        wj = jdiag.preconditioned_spectrum(Aj, Mj)
        wt = tdiag.preconditioned_spectrum(At, Mt, **CPU64)
        np.testing.assert_allclose(wt, wj, rtol=1e-10, atol=1e-12)
    w = wt
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (At.n_rows,),
                                      jnp.float64))
    lj = jdiag.condition_estimate(Aj, j_jacobi(Aj), iters=80)
    lmin, lmax, kappa = tdiag.condition_estimate(At, jacobi_precond(At),
                                                 iters=80, v0=v0, **CPU64)
    np.testing.assert_allclose((lmin, lmax, kappa), lj, rtol=1e-8)
    assert lmax <= w[-1] * (1 + 1e-8)
    assert abs(lmax - w[-1]) / w[-1] < 1e-6
    assert lmin >= w[0] * (1 - 1e-8)
    assert kappa <= (w[-1] / w[0]) * (1 + 1e-6)
    # from a generator: seeded and repeatable
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    assert tdiag.condition_estimate(At, None, iters=20, generator=g(),
                                    **CPU64) == \
        tdiag.condition_estimate(At, None, iters=20, generator=g(), **CPU64)


def test_preconditioning_lowers_condition():
    """κ(AMG) < κ(Jacobi) < κ(none) and κ(AMG) < 10 (tests/
    test_diagnostics.py's). With Jacobi and AMG, (λmin, λmax, κ) within 1e-6
    of the JAX package's from its start vector. Unpreconditioned, this
    Lanczos (no reorthogonalization) amplifies the two packages' last-bit
    difference from step to step once orthogonality is lost, so that the
    two λmin part after 80 steps; there only λmax, which has converged, is
    held to the JAX package's (1e-10)."""
    Aj, At, _ = _system(1000, seed=1)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (At.n_rows,),
                                      jnp.float64))
    kappas = []
    for Mj, Mt, rtol in ((None, None, None),
                         (j_jacobi(Aj), jacobi_precond(At), 1e-6),
                         (jamg.amg_precond(Aj), amg_precond(At), 1e-6)):
        est = tdiag.condition_estimate(At, Mt, iters=80, v0=v0, **CPU64)
        est_j = jdiag.condition_estimate(Aj, Mj, iters=80)
        if rtol is None:
            np.testing.assert_allclose(est[1], est_j[1], rtol=1e-10)
        else:
            np.testing.assert_allclose(est, est_j, rtol=rtol)
        kappas.append(est[2])
    k_plain, k_jac, k_amg = kappas
    assert k_amg < k_jac < k_plain and k_amg < 10


def test_phase_metrics_keys(capsys, tmp_path):
    """PhaseMetrics' JSON keys are the JAX package's: t_<phase> (summed over
    repeats) and <phase>_nnz_per_s, plus added counters; the print
    helpers; profiler_trace writes a Chrome trace."""
    m = tmetrics.PhaseMetrics(device="cpu")
    with m.phase("solve", nnz=1000):
        torch.ones(10).sum()
    with m.phase("solve"):
        pass
    with m.phase("setup", verbose=False):
        pass
    m.add("it", 12)
    d = json.loads(m.json())
    assert set(d) == {"t_solve", "t_setup", "solve_nnz_per_s", "it"}
    assert d["it"] == 12 and d["t_solve"] >= 0
    m.dump()
    tmetrics.printlnln("a")
    tmetrics.space_println("b")
    out = capsys.readouterr().out
    assert "[solve]" in out and json.dumps(d) in out
    assert "a\n\n" in out and "\nb\n" in out
    with tmetrics.profiler_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(100).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
