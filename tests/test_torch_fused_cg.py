"""PyTorch port, padded-layout CG (ops/fused_cg.py, kernels B, C, D): the
symmetry probe, refill and padding, one sweep of kernel B's plain version
against the JAX package's `_k1` in interpret mode, and the four solvers
(plain versions on the CPU) against the JAX solvers in interpret mode
(float64). The kernels themselves are held against their plain versions
on the card in tests/test_torch_kernels.py."""

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

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import fused_cg as tfc

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _setup(nn=900, jitter=0.2, seed=3, coeff_seed=0, sigma=0.3):
    mesh = get_mesh(nn, jitter=jitter, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(coeff_seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(sigma * rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    Sj = jst.build_stencil_op(A, maps, (m1, m1))
    bj = jst.to_full_vector(maps, b, mesh.nnode)
    St = convert.stencil_op(**convert.numpy_fields(Sj), **CPU64)
    return mesh, asm, Sj, bj, St, torch.tensor(np.asarray(bj))


def test_symmetry_probe_and_plane_count():
    _, _, Sj, _, St, _ = _setup()
    p9 = St.planes.numpy()
    assert tfc._check_symmetric(p9) == jfc._check_symmetric(p9) is True
    assert tfc.build_padded_stencil(St).K == 5
    broken = p9.copy()
    broken[1, 3, 4] += 1.0
    assert not tfc._check_symmetric(broken)
    St_b = convert.stencil_op(broken, St.dir_diag.numpy(), np.zeros(0),
                              St.H, St.W, **CPU64)
    assert tfc.build_padded_stencil(St_b).K == 9
    assert tfc.build_padded_stencil(St, sym=False).K == 9


def test_refill_equals_fresh_build():
    mesh, asm, Sj, _, St, _ = _setup()
    rng = np.random.default_rng(42)
    A2, _ = do_isotropic_elliptic_assembly(
        asm, np.exp(rng.normal(size=mesh.nnode)))
    maps = asm.maps
    St2 = convert.stencil_op(**convert.numpy_fields(
        jst.build_stencil_op(A2, maps, (St.H, St.W))), **CPU64)
    for sym in (None, False):
        ps = tfc.build_padded_stencil(St, sym=sym)
        np.testing.assert_array_equal(
            tfc.refill_padded_stencil(ps, St2).planes.numpy(),
            tfc.build_padded_stencil(St2, sym=sym).planes.numpy())


def test_pad_round_trip_and_zero_ring():
    _, _, _, _, St, bt = _setup()
    ps = tfc.build_padded_stencil(St)
    assert ps.C % 32 == 0 and ps.C >= ps.W + 1 and ps.R == ps.H + 4
    xp = tfc.pad_vec(ps, bt)
    np.testing.assert_array_equal(tfc.unpad_vec(ps, xp).numpy(), bt.numpy())
    arr = xp.numpy()
    r0 = tfc.ROW0
    assert np.all(arr[:r0] == 0) and np.all(arr[r0 + ps.H:] == 0)
    assert np.all(arr[:, ps.W:] == 0)
    planes = ps.planes.numpy()
    assert np.all(planes[:, :r0] == 0) and np.all(planes[:, r0 + ps.H:] == 0)
    assert np.all(planes[:, :, ps.W:] == 0)
    assert tfc._unblock_planes(ps).shape == (ps.K * ps.R, ps.C)


# Grids whose shapes meet kernel B's edges (csrc/fused_cg.cu): W + 1 exactly
# 32 (pitch 32), W + 1 just over it (pitch 64), and a prime H, which no
# strip height divides. get_mesh(nn) gives a (√nn)² grid.
EDGE_GRIDS = {961: "31x31", 1024: "32x32", 1369: "37x37"}


def _with_edge_grids(first, *cases):
    """The cases at the default 30 x 30 grid under their old ids, then the
    same cases on each edge grid."""
    out = [pytest.param(*c, 900, id="-".join(map(str, c))) for c in cases]
    out += [pytest.param(*c, nn, id="-".join(map(str, c)) + f"-{g}")
            for nn, g in EDGE_GRIDS.items() for c in cases if c[0] in first]
    return out


@pytest.mark.parametrize("sym,nn", _with_edge_grids((False, True), (False,),
                                                    (True,)))
def test_sweep_plain_matches_jax_k1(sym, nn):
    _, _, Sj, _, St, _ = _setup(nn=nn, seed=5)
    n = St.H * St.W
    rng = np.random.default_rng(8)
    r, p, beta = rng.normal(size=n), rng.normal(size=n), 0.7
    psj = jfc.build_padded_stencil(Sj, tb=16, sym=sym)
    pn_j, ap_j, d_j = jfc._k1(psj, jfc.pad_vec(psj, jnp.asarray(r)),
                              jfc.pad_vec(psj, jnp.asarray(p)),
                              jnp.asarray(beta), interpret=True)
    pst = tfc.build_padded_stencil(St, sym=sym)
    t = lambda v: tfc.pad_vec(pst, torch.as_tensor(v))  # noqa: E731
    pn_t, ap_t, d_t = tfc.cg_sweep(pst, t(r), t(p),
                                   torch.tensor(beta, dtype=torch.float64))
    # XLA:CPU contracts r + β·p into an FMA (krylov_spdes_tpu/ops/df32.py:
    # 13-23) where torch rounds the product: last-bit differences
    np.testing.assert_allclose(tfc.unpad_vec(pst, pn_t).numpy(),
                               np.asarray(jfc.unpad_vec(psj, pn_j)),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(tfc.unpad_vec(pst, ap_t).numpy(),
                               np.asarray(jfc.unpad_vec(psj, ap_j)),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-12)
    # the pads of both outputs stay zero
    r0 = tfc.ROW0
    for out in (pn_t, ap_t):
        assert not (out[:r0].any() or out[r0 + pst.H:].any()
                    or out[:, pst.W:].any())


@pytest.mark.parametrize("solver,sym,nn", _with_edge_grids(
    ("fused_pcg",), *[(s, sym) for s in ("fused_cg", "fused_pcg", "vmem_cg",
                                        "vmem_pcg") for sym in (False, True)]))
def test_solver_matches_jax(solver, sym, nn):
    """Same `it` (±2 with the 5-plane form, whose product-then-shift terms
    round differently, as in tests/test_fused_cg.py:71), x to rtol 1e-6;
    fused_pcg (kernel B's solver) also on the edge grids."""
    _, _, Sj, bj, St, bt = _setup(nn=nn, seed=7, coeff_seed=2)
    psj = jfc.build_padded_stencil(Sj, tb=16, sym=sym)
    pst = tfc.build_padded_stencil(St, sym=sym)
    xj, itj, resj = getattr(jfc, solver)(psj, bj, maxit=1500, interpret=True)
    xt, itt, rest = getattr(tfc, solver)(pst, bt, maxit=1500)
    assert abs(int(itt) - int(itj)) <= (2 if sym else 0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-9)
    tol = 1e-7 * float(np.linalg.norm(np.asarray(bj)))
    res_t = rest[int(itt) - 1] if solver.startswith("fused") else rest
    assert float(res_t) <= tol


@pytest.mark.parametrize("H,W,esize,K", [
    (500, 500, 4, 5), (500, 500, 8, 9), (1000, 1000, 4, 5), (31, 31, 4, 9),
    (32, 32, 8, 5), (37, 37, 4, 5), (11, 1100, 4, 9), (11, 1100, 8, 5)])
def test_sweep_plan_covers_the_grid(H, W, esize, K):
    """Kernel B's launch plan: the segments cover a padded row's 16-byte
    groups, one a thread; the strips cover the rows (band_rows) in two-row
    strips where the device holds all the blocks at once, longer strips
    where it does not; the shared memory is the window and, for K = 5, the
    plane rows."""
    from krylov_spdes_tpu_torch.ops.persistent import band_rows
    C = -(-(W + 1) // 32) * 32
    G = C * esize // 16
    for sms, per_sm in ((132, 3), (132, 1), (4, 2)):
        plan = tfc.sweep_plan(H, C, K, esize, sms, per_sm)
        assert (plan.segments - 1) * plan.groups < G <= plan.segments * plan.groups
        assert plan.groups <= tfc.SWEEP_GROUPS
        assert plan.threads % 32 == 0 and plan.groups <= plan.threads < plan.groups + 32
        assert plan.segments * plan.strips <= sms * per_sm
        bands = band_rows(H, plan.strips)
        assert sum(n for _, n in bands) == H and max(n for _, n in bands) == plan.rows
        if plan.segments * -(-H // tfc.SWEEP_ROWS) <= sms * per_sm:
            assert plan.rows == min(H, tfc.SWEEP_ROWS)
        rows = 4 + (9 if K == 5 else 0)
        assert plan.smem == rows * (plan.groups + 2) * 16
    with pytest.raises(ValueError):
        tfc.sweep_plan(H, C, K, esize, 1, 0)
