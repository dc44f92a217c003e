"""PyTorch port, the CUDA kernels A-H against their plain PyTorch versions.

The tests marked `cuda` need a CUDA device and nvcc; without a card they
skip. This file imports no jax, so on a machine without jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

import krylov_spdes_tpu_torch.fem as tfem
from krylov_spdes_tpu_torch.ops import batched_proj as tbp
from krylov_spdes_tpu_torch.ops import fused_cg as tfc
from krylov_spdes_tpu_torch.ops import pallas_cg as tpc
from krylov_spdes_tpu_torch.ops import stencil as tst
from krylov_spdes_tpu_torch.ops import stencil_kernel as tsk
from krylov_spdes_tpu_torch.ops import vmem_eigdef as tve
from krylov_spdes_tpu_torch.solvers.defcg import eigdefpcg

torch.set_num_threads(1)


def _system(nn, device, dtype, seed=9):
    mesh = tfem.get_mesh(nn, jitter=0.2, seed=seed)
    maps = tfem.get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = tfem.prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                         lambda x, y: -1.0 + 0.0 * x,
                                         lambda x, y: 0.0 * x, device=device,
                                         dtype=dtype)
    coeff = np.exp(0.3 * np.random.default_rng(seed).normal(size=mesh.nnode))
    A, b = tfem.do_isotropic_elliptic_assembly(asm, coeff)
    m1 = int(round(np.sqrt(mesh.nnode)))
    St = tst.build_stencil_op(A, maps, (m1, m1))
    return St, tst.to_full_vector(maps, b, mesh.nnode)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")


def test_wrappers_take_plain_version_on_cpu():
    St, b = _system(400, "cpu", torch.float64)
    before = (tsk.stencil_spmv.launches, tfc.cg_sweep.launches,
              tfc.whole_cg.launches, tfc.whole_pcg.launches)
    np.testing.assert_array_equal(
        tst.stencil_matvec(St, b).numpy(),
        tsk.stencil_spmv_plain(St.planes, St.dir_diag, b).numpy())
    ps = tfc.build_padded_stencil(St)
    x, it, res = tfc.vmem_cg(ps, b, maxit=500)
    assert float(res) <= 1e-7 * float(torch.linalg.vector_norm(b))
    x2, it2, _ = tfc.fused_cg(ps, b, maxit=500)
    assert int(it2) == int(it)
    after = (tsk.stencil_spmv.launches, tfc.cg_sweep.launches,
             tfc.whole_cg.launches, tfc.whole_pcg.launches)
    assert after == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_a_matches_plain(dtype):
    _need_card()
    rng = np.random.default_rng(2)
    for H, W in ((37, 53), (500, 500)):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa
        planes = t(rng.normal(size=(9, H, W)))
        dd = t(rng.normal(size=(H, W)))
        x = t(rng.normal(size=H * W))
        n0 = tsk.stencil_spmv.launches
        y = tsk.stencil_spmv(planes, dd, x)
        assert tsk.stencil_spmv.launches == n0 + 1
        # --fmad=false and the same sum order: bit-equal
        torch.testing.assert_close(y, tsk.stencil_spmv_plain(planes, dd, x),
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_b_c_d_match_plain(sym, dtype):
    _need_card()
    St, b = _system(2500, "cuda", dtype)
    ps = tfc.build_padded_stencil(St, sym=sym)
    assert ps.K == (5 if sym else 9)
    bp = tfc.pad_vec(ps, b)
    g = torch.Generator(device="cuda").manual_seed(0)
    p = tfc.pad_vec(ps, torch.randn(b.shape, generator=g, device="cuda",
                                    dtype=dtype))
    beta = torch.tensor(0.3, dtype=dtype, device="cuda")
    pn, ap, d = tfc.cg_sweep(ps, bp, p, beta)
    pn0, ap0, d0 = tfc.cg_sweep_plain(ps, bp, p, beta)
    # --fmad=false and the same sum order: pn and Ap bit-equal; d is summed
    # in another order
    torch.testing.assert_close(pn, pn0, rtol=0, atol=0)
    torch.testing.assert_close(ap, ap0, rtol=0, atol=0)
    torch.testing.assert_close(d, d0, rtol=1e-5, atol=0)
    # the sum's order is fixed: the same d on every run
    assert all(bool(tfc.cg_sweep(ps, bp, p, beta)[2] == d) for _ in range(3))

    tol2 = 1e-12 * torch.sum(bp * bp)
    minv = tfc._jacobi_minv(ps, tfc._unblock_planes(ps), None)
    for kern, plain, args in ((tfc.whole_cg, tfc.whole_cg_plain, (bp,)),
                              (tfc.whole_pcg, tfc.whole_pcg_plain, (minv, bp))):
        x, it, res = kern(ps, *args, 2000, tol2)
        x0, it0, res0 = plain(ps, *args, 2000, tol2)
        assert it.device.type == "cuda" and it.dtype == torch.int32
        assert abs(int(it) - int(it0)) <= max(2, int(it0) // 20)
        assert float(res) ** 2 <= float(tol2)
        err = float(torch.linalg.vector_norm(x - x0)
                    / torch.linalg.vector_norm(x0))
        assert err <= (1e-8 if dtype == torch.float64 else 1e-3), err
        # pads of x stay zero
        r0 = tfc.ROW0
        assert not (x[:r0].any() or x[r0 + ps.H:].any() or x[:, ps.W:].any())


@pytest.mark.cuda
def test_maxit_caps_the_whole_solve():
    _need_card()
    St, b = _system(2500, "cuda", torch.float64)
    ps = tfc.build_padded_stencil(St)
    for solve in (tfc.vmem_cg, tfc.vmem_pcg):
        x, it, res = solve(ps, b, maxit=5)
        assert int(it) == 5
        x1, it1, _ = solve(ps, b, maxit=1)
        assert int(it1) == 1 and float(x1.abs().sum()) == 0.0


def test_efg_wrappers_take_plain_version_on_cpu():
    St, b = _system(400, "cpu", torch.float64)
    before = (tve.stretch.launches, tbp.gemv_rows.launches,
              tbp.fused_reorth.launches)
    ps = tfc.build_padded_stencil(St)
    W = torch.linalg.qr(torch.tensor(
        np.random.default_rng(0).normal(size=(St.n, 3))) * (St.dir_diag.reshape(-1, 1) == 0))[0]
    x, it, res, Wn = tve.vmem_eigdefpcg(ps, b, W, spdim=8, maxit=300)
    ref = eigdefpcg(St, b, W=W, spdim=8, maxit=300, Mdiag=1.0 / St.diagonal())
    assert int(it) == int(ref.it)
    G = torch.ones(2, 4, 10, dtype=torch.float64)
    r = torch.ones(2, 10, dtype=torch.float64)
    assert tbp.gemv_rows(G, r).shape == (2, 4)
    assert tbp.fused_reorth(G, torch.ones(2, 4, dtype=torch.float64), r, r, 2)[0].shape == (2, 10)
    after = (tve.stretch.launches, tbp.gemv_rows.launches,
             tbp.fused_reorth.launches)
    assert after == before


def _stretch_operands(ps, b, W):
    """The operands of the first stretch of a solve, as `_vmem_eigdef_impl`
    builds them."""
    bp = tfc.pad_vec(ps, b)
    minv = tfc._jacobi_minv(ps, tfc._unblock_planes(ps), None)
    Wp = torch.stack([tfc.pad_vec(ps, w) for w in W.T.contiguous()])
    o = tve.stretch_operands(ps, minv, bp, Wp)
    return (minv, o["G"].contiguous(), o["A1"].contiguous(),
            o["B"].contiguous(), o["Ac"].contiguous(), o["Bc"].contiguous(),
            o["x"], o["r"], o["p"], o["rTz"], o["rTr"])


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_e_matches_plain(sym, dtype):
    _need_card()
    St, b = _system(2500, "cuda", dtype)
    ps = tfc.build_padded_stencil(St, sym=sym)
    nvec, spdim = 6, 20
    g = torch.Generator(device="cuda").manual_seed(1)
    W = torch.randn(St.n, nvec, generator=g, device="cuda", dtype=dtype) \
        * (St.dir_diag.reshape(-1, 1) == 0)
    minv, G, A1, B, Ac, Bc, x, r, p, rTz, rTr = _stretch_operands(ps, b, W)
    tol2 = 1e-14 * rTr
    outs = []
    # the kernel (G, Ac, Bc) against the JAX twin (G, A1, B)
    for fn, M1, M2 in ((tve.stretch, Ac, Bc), (tve.stretch_plain, A1, B)):
        V = torch.zeros(spdim, ps.R, ps.C, dtype=dtype, device="cuda")
        n0 = tve.stretch.launches
        outs.append(fn(ps, minv, G, M1, M2, x.clone(), r.clone(), p.clone(),
                       V, tol2, rTz, rTr, 9, nvec))
        assert tve.stretch.launches == n0 + (fn is tve.stretch)
    k, pl = outs
    assert int(k[7]) == int(pl[7]) == 9 and bool(k[9]) == bool(pl[9])
    tol = 1e-9 if dtype == torch.float64 else 2e-3
    for a, c in zip(k[:7], pl[:7]):
        err = float(torch.linalg.vector_norm(a - c) / torch.linalg.vector_norm(c))
        assert err <= tol, err
    assert abs(float(k[8]) - float(pl[8])) <= tol * abs(float(pl[8]))
    # only the appended columns of V were written; pads stay zero
    V = k[3]
    assert not V[:nvec + 1].any() and not V[nvec + 10:].any()
    r0 = tfc.ROW0
    assert not (V[:, :r0].any() or V[:, r0 + ps.H:].any() or V[:, :, ps.W:].any())
    # the sums have a fixed order: a second run repeats bit for bit
    V2 = torch.zeros_like(V)
    again = tve.stretch(ps, minv, G, Ac, Bc, x.clone(), r.clone(), p.clone(),
                        V2, tol2, rTz, rTr, 9, nvec)
    assert torch.equal(again[4], k[4]) and torch.equal(again[0], k[0])


def _check_stretch_where_w_does_not_fit(nn, dtype, nvec):
    """Kernel E against stretch_plain over 1 and 8 iterations (float32:
    1e-5 and 2e-3, as chip_smoke holds it; float64: 1e-9) and a repeat bit
    for bit, at a size where the band's basis rows (or its vectors) do not
    all fit in shared memory."""
    St, b = _system(nn, "cuda", dtype)
    ps = tfc.build_padded_stencil(St)
    plan = tve.plan_for(ps, b, nvec)
    assert plan.w_rows < nvec, plan
    g = torch.Generator(device="cuda").manual_seed(4)
    W = torch.randn(St.n, nvec, generator=g, device="cuda", dtype=dtype) \
        * (St.dir_diag.reshape(-1, 1) == 0)
    minv, G, A1, B, Ac, Bc, x, r, p, rTz, rTr = _stretch_operands(ps, b, W)
    tol2 = 1e-14 * rTr
    f64 = dtype == torch.float64
    for nsteps, tol in ((1, 1e-9 if f64 else 1e-5), (8, 1e-9 if f64 else 2e-3)):
        outs = []
        for fn, M1, M2 in ((tve.stretch, Ac, Bc), (tve.stretch, Ac, Bc),
                           (tve.stretch_plain, A1, B)):
            V = torch.zeros(nvec + 1 + nsteps, ps.R, ps.C, dtype=dtype,
                            device="cuda")
            outs.append(fn(ps, minv, G, M1, M2, x.clone(), r.clone(),
                           p.clone(), V, tol2, rTz, rTr, nsteps, nvec))
        k, k2, pl = outs
        assert int(k[7]) == int(pl[7]) == nsteps
        for a, c in zip(k[:7], pl[:7]):
            err = float(torch.linalg.vector_norm(a - c)
                        / torch.linalg.vector_norm(c))
            assert err <= tol, (nsteps, err)
        for a, c in zip(k[:7], k2[:7]):
            assert torch.equal(a, c)


@pytest.mark.cuda
def test_kernel_e_where_w_does_not_fit():
    """nvec 32 at 250k nodes, float32: 19 of the 32 basis rows resident."""
    _need_card()
    _check_stretch_where_w_does_not_fit(250000, torch.float32, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_e_where_the_band_does_not_fit(dtype):
    """1000 x 1000, nvec 4: in float32 no basis row fits beside the band's
    vectors, in float64 the vectors themselves live in global memory."""
    _need_card()
    _check_stretch_where_w_does_not_fit(1000000, dtype, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("nvec,spdim", [(4, 12), (8, 20), (4, 9)])
def test_vmem_eigdefpcg_on_card_matches_eigdefpcg(nvec, spdim):
    _need_card()
    St, b = _system(900, "cuda", torch.float64, seed=3)
    ps = tfc.build_padded_stencil(St)
    g = torch.Generator(device="cuda").manual_seed(2)
    W = torch.randn(St.n, nvec, generator=g, device="cuda",
                    dtype=torch.float64) * (St.dir_diag.reshape(-1, 1) == 0)
    ref = eigdefpcg(St, b, W=W, spdim=spdim, maxit=400,
                    Mdiag=1.0 / St.diagonal())
    n0 = tve.stretch.launches
    x, it, res, Wn = tve.vmem_eigdefpcg(ps, b, W, spdim=spdim, maxit=400)
    assert tve.stretch.launches > n0
    assert int(it) == int(ref.it)
    torch.testing.assert_close(x, ref.x, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_f_g_match_plain(dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=dtype)  # noqa
    for B, nvec, n in ((3, 8, 5000), (2, 5, 1025), (4, 16, 250000)):
        K = 2 * nvec
        G, r, C = rnd(B, K, n), rnd(B, n), rnd(B, 2 * nvec)
        m = torch.rand(B, n, generator=g, device="cuda", dtype=dtype) + 0.5
        n0 = (tbp.gemv_rows.launches, tbp.fused_reorth.launches)
        U = tbp.gemv_rows(G, r)
        out = tbp.fused_reorth(G, C, r, m, nvec)
        assert (tbp.gemv_rows.launches, tbp.fused_reorth.launches) == (n0[0] + 1, n0[1] + 1)
        rt = 1e-4 if dtype == torch.float32 else 1e-11
        torch.testing.assert_close(U, tbp.gemv_rows_plain(G, r), rtol=rt,
                                   atol=rt * n ** 0.5)
        ref = tbp.fused_reorth_plain(G, C, r, m, nvec)
        # --fmad=false and the same accumulation order: bit-equal vectors
        for a, c in zip(out[:3], ref[:3]):
            torch.testing.assert_close(a, c, rtol=0, atol=0)
        for a, c in zip(out[3:], ref[3:]):
            torch.testing.assert_close(a, c, rtol=rt, atol=0)
        assert torch.equal(tbp.gemv_rows(G, r), U)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_h_matches_plain(dtype):
    """Kernel H against its plain version: over 1 and 8 iterations to
    rounding (CG amplifies a last-bit difference from iteration to
    iteration, and the two reduce in different orders), a whole solve to the
    tolerance of the solve; a solve repeats bit for bit."""
    _need_card()
    for nn in (1369, 40000):
        St, b = _system(nn, "cuda", dtype)
        eps = torch.finfo(dtype).eps
        for maxit, tol in ((2, 50 * eps), (9, 5e4 * eps)):
            n0 = tpc.stencil_cg.launches
            x, it, res = tpc.stencil_cg(St, b, maxit, 1e-12)
            assert tpc.stencil_cg.launches == n0 + 1
            xp, itp, resp = tpc.stencil_cg_plain(St, b, maxit, 1e-12)
            assert int(it) == int(itp) == maxit
            torch.testing.assert_close(x, xp, rtol=tol,
                                       atol=tol * float(xp.abs().max()))
            torch.testing.assert_close(res, resp, rtol=tol, atol=0)
        rtol = 1e-5 if dtype == torch.float32 else 1e-8
        x, it, res = tpc.stencil_cg(St, b, 3000, rtol)
        xp, itp, resp = tpc.stencil_cg_plain(St, b, 3000, rtol)
        assert abs(int(it) - int(itp)) <= max(2, 0.05 * int(itp))
        assert float(res) <= rtol * float(torch.linalg.vector_norm(b))
        torch.testing.assert_close(x, xp, rtol=0,
                                   atol=1e3 * rtol * float(xp.abs().max()))
        x2, it2, res2 = tpc.stencil_cg(St, b, 3000, rtol)
        assert int(it2) == int(it) and torch.equal(x2, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_h_where_the_band_does_not_fit(dtype):
    """1000 x 1000: the planes are read from global memory (float32), and
    the vectors too (float64). Against the plain version over 1 and 8
    iterations; a longer solve repeats bit for bit."""
    _need_card()
    St, b = _system(1000000, "cuda", dtype)
    plan = tpc.plan_for(b, St.H, St.W)
    assert not plan.planes and plan.vectors == (dtype == torch.float32)
    eps = torch.finfo(dtype).eps
    for maxit, tol in ((2, 50 * eps), (9, 5e4 * eps)):
        x, it, res = tpc.stencil_cg(St, b, maxit, 1e-12)
        xp, itp, resp = tpc.stencil_cg_plain(St, b, maxit, 1e-12)
        assert int(it) == int(itp) == maxit
        torch.testing.assert_close(x, xp, rtol=tol,
                                   atol=tol * float(xp.abs().max()))
        torch.testing.assert_close(res, resp, rtol=tol, atol=0)
    x, it, _ = tpc.stencil_cg(St, b, 200, 1e-12)
    x2, it2, _ = tpc.stencil_cg(St, b, 200, 1e-12)
    assert int(it) == int(it2) == 200 and torch.equal(x, x2)


def _random_spd_stencil(H, W, g):
    """A random symmetric positive definite 9-point operator on an H x W
    grid, float64 on the card: random planes, the bonds mirrored, the
    diagonal dominant."""
    planes = torch.randn(9, H, W, generator=g, device="cuda",
                         dtype=torch.float64) * 0.1
    S = tst.StencilOp(planes=planes, dir_diag=torch.zeros_like(planes[0]),
                      slot=torch.zeros(0, dtype=torch.int64, device="cuda"),
                      H=H, W=W)
    dense = torch.stack([S.matvec(e) for e in torch.eye(
        H * W, device="cuda", dtype=torch.float64)], 1)
    sym = 0.5 * (dense + dense.T) + 3.0 * torch.eye(H * W, device="cuda",
                                                    dtype=torch.float64)
    idx = torch.arange(H * W, device="cuda").reshape(H, W)
    P = torch.zeros_like(planes)
    for k, (di, dj) in enumerate(tsk.OFFSETS):
        i0, i1, j0, j1 = max(0, -di), min(H, H - di), max(0, -dj), min(W, W - dj)
        P[k, i0:i1, j0:j1] = sym[idx[i0:i1, j0:j1],
                                 idx[i0 + di:i1 + di, j0 + dj:j1 + dj]]
    return tst.StencilOp(planes=P, dir_diag=torch.ones_like(P[0]) * 0.5,
                         slot=S.slot, H=H, W=W)


@pytest.mark.cuda
def test_kernel_h_non_square_grid_and_maxit_one():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    H, W = 37, 53
    S = _random_spd_stencil(H, W, g)
    b = torch.randn(H * W, generator=g, device="cuda", dtype=torch.float64)
    x, it, res = tpc.stencil_cg(S, b, 500, 1e-10)
    xp, itp, resp = tpc.stencil_cg_plain(S, b, 500, 1e-10)
    assert abs(int(it) - int(itp)) <= 1 and int(it) < 500
    torch.testing.assert_close(x, xp, rtol=1e-7, atol=1e-9)
    x1, it1, res1 = tpc.stencil_cg(S, b, 1, 1e-10)
    assert int(it1) == 1 and float(x1.abs().max()) == 0.0
    torch.testing.assert_close(res1, torch.linalg.vector_norm(b), rtol=1e-12,
                               atol=0)


def _c_and_d(ps, bp):
    """(kernel, plain version, operands) of kernels C and D on ps."""
    minv = tfc._jacobi_minv(ps, tfc._unblock_planes(ps), None)
    return ((tfc.whole_cg, tfc.whole_cg_plain, (bp,)),
            (tfc.whole_pcg, tfc.whole_pcg_plain, (minv, bp)))


def _hold_to_plain_over_1_and_8(ps, bp):
    """Kernels C and D against their plain versions over 1 and 8
    iterations (tol² = 0: the count is exact): CG amplifies a last-bit
    difference from iteration to iteration and the two reduce in different
    orders, so the tolerances are kernel H's."""
    eps = torch.finfo(bp.dtype).eps
    zero = bp.new_zeros(())
    for kern, plain, args in _c_and_d(ps, bp):
        for maxit, tol in ((2, 50 * eps), (9, 5e4 * eps)):
            n0 = kern.launches
            x, it, res = kern(ps, *args, maxit, zero)
            assert kern.launches == n0 + 1
            xp, itp, resp = plain(ps, *args, maxit, zero)
            assert int(it) == int(itp) == maxit
            torch.testing.assert_close(x, xp, rtol=tol,
                                       atol=tol * float(xp.abs().max()))
            torch.testing.assert_close(res, resp, rtol=tol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_c_d_match_plain_over_1_and_8_iterations(sym, dtype):
    """Kernels C and D on the persistent skeleton: against their plain
    versions over 1 and 8 iterations, K = 5 and 9; a whole solve repeats bit
    for bit; one block an SM at most."""
    _need_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nn in (1369, 40000):
        St, b = _system(nn, "cuda", dtype)
        ps = tfc.build_padded_stencil(St, sym=sym)
        bp = tfc.pad_vec(ps, b)
        _hold_to_plain_over_1_and_8(ps, bp)
        tol2 = (1e-5 if dtype == torch.float32 else 1e-8) ** 2 * torch.sum(bp * bp)
        for kern, _, args in _c_and_d(ps, bp):
            plan = tfc.plan_for(ps, bp, kern is tfc.whole_pcg)
            assert plan.grid == min(ps.H, sms) and plan.vectors
            x, it, _ = kern(ps, *args, 3000, tol2)
            x2, it2, _ = kern(ps, *args, 3000, tol2)
            assert int(it) == int(it2) < 3000 and torch.equal(x, x2)


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True])
def test_kernels_c_d_non_square_grid_and_maxit_one(sym):
    """A 37 x 53 grid (37 bands of one row, pitch 64): a solve against the
    plain version; maxit = 1 applies nothing, x = 0 and ‖r‖ = ‖b‖."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    S = _random_spd_stencil(37, 53, g)
    ps = tfc.build_padded_stencil(S, sym=sym)
    assert ps.K == (5 if sym else 9)
    bp = tfc.pad_vec(ps, torch.randn(S.n, generator=g, device="cuda",
                                     dtype=torch.float64))
    tol2 = 1e-20 * torch.sum(bp * bp)
    for kern, plain, args in _c_and_d(ps, bp):
        x, it, res = kern(ps, *args, 500, tol2)
        xp, itp, resp = plain(ps, *args, 500, tol2)
        assert abs(int(it) - int(itp)) <= 1 and int(it) < 500
        torch.testing.assert_close(x, xp, rtol=1e-7, atol=1e-9)
        x1, it1, res1 = kern(ps, *args, 1, tol2)
        assert int(it1) == 1 and float(x1.abs().max()) == 0.0
        torch.testing.assert_close(res1, torch.linalg.vector_norm(bp),
                                   rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_c_d_where_the_band_does_not_fit(dtype):
    """1000 x 1000: the planes are read from global memory (float32), and
    the vectors too (float64). Against the plain versions over 1 and 8
    iterations; a longer solve repeats bit for bit."""
    _need_card()
    St, b = _system(1000000, "cuda", dtype)
    ps = tfc.build_padded_stencil(St)
    bp = tfc.pad_vec(ps, b)
    _hold_to_plain_over_1_and_8(ps, bp)
    for kern, _, args in _c_and_d(ps, bp):
        plan = tfc.plan_for(ps, bp, kern is tfc.whole_pcg)
        assert not plan.planes and plan.vectors == (dtype == torch.float32)
        x, it, _ = kern(ps, *args, 200, bp.new_zeros(()))
        x2, it2, _ = kern(ps, *args, 200, bp.new_zeros(()))
        assert int(it) == int(it2) == 200 and torch.equal(x, x2)


# Kernel B's edge shapes: W + 1 exactly 32 (pitch 32) and just over it
# (pitch 64), H prime (no strip height divides it), rows of more than 256
# 16-byte groups (two or three segments), and 1000 x 1000.
B_SHAPES = ((31, 31), (32, 32), (37, 37), (11, 1100), (1000, 1000))


def _random_padded(H, W, K, dtype, seed=0):
    """Random planes, r and p on the padded layout of an H x W grid (zero
    ring), numpy-seeded, on the card."""
    rng = np.random.default_rng(seed)
    C = -(-(W + 1) // 32) * 32
    R = H + 2 * tfc.ROW0

    def grid(*lead):
        a = np.zeros((*lead, R, C))
        a[..., tfc.ROW0:tfc.ROW0 + H, :W] = rng.normal(size=(*lead, H, W))
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    ps = tfc.PaddedStencil(planes=grid(K), H=H, W=W, R=R, C=C, K=K)
    return ps, grid(), grid()


def _pads(ps, a):
    r0 = tfc.ROW0
    return torch.cat([a[:r0].reshape(-1), a[r0 + ps.H:].reshape(-1),
                      a[:, ps.W:].reshape(-1)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", B_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("K", [5, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_b_matches_plain_at_edge_shapes(shape, K, dtype, monkeypatch):
    """One launch a call; pn and Ap bit-equal to the plain version with
    their pads exactly zero even in memory filled with NaN before the call
    (no memset is relied on); d within rounding of the plain sum and the
    same bits over 3 calls; the blocks' packed partials (the flag words the
    last block waits on) back at 0 after each call."""
    _need_card()
    ps, r, p = _random_padded(*shape, K, dtype)
    beta = torch.tensor(0.7, dtype=dtype, device="cuda")
    pn0, ap0, d0 = tfc.cg_sweep_plain(ps, r, p, beta)
    plan = tfc.sweep_plan_for(ps, r)
    empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like",
                        lambda t, **kw: empty_like(t, **kw).fill_(float("nan")))
    ds = []
    for _ in range(3):
        n0 = tfc.cg_sweep.launches
        pn, ap, d = tfc.cg_sweep(ps, r, p, beta)
        assert tfc.cg_sweep.launches == n0 + 1
        torch.testing.assert_close(pn, pn0, rtol=0, atol=0)
        torch.testing.assert_close(ap, ap0, rtol=0, atol=0)
        assert not (_pads(ps, pn).any() or _pads(ps, ap).any())
        slots = tfc._sweep_slots(r.device, plan.segments * plan.strips
                                 * r.element_size() // 4,
                                 torch.cuda.current_stream().cuda_stream)
        assert not slots.any()
        ds.append(d)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(ds[0], d0, rtol=rtol, atol=0)
    assert all(torch.equal(d, ds[0]) for d in ds)


@pytest.mark.cuda
def test_kernel_b_one_kernel_a_call():
    """The profiler sees one device launch a call and no memset."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    ps, r, p = _random_padded(500, 500, 5, torch.float32)
    beta = torch.tensor(0.3, device="cuda")
    tfc.cg_sweep(ps, r, p, beta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            tfc.cg_sweep(ps, r, p, beta)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    assert [e.key for e in events] == [e.key for e in events
                                       if "cg_sweep_strip_kernel" in e.key]
    assert sum(e.count for e in events) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_pcg_it_within_the_plain_sweeps_envelope(dtype, monkeypatch):
    """fused_pcg through kernel B: its `it` within 5% of the range that
    fused_pcg through the plain sweep spans on b and on copies of b changed
    in their last bit (ROADMAP §3), x to the solve's accuracy; B launched
    once an iteration after the first."""
    _need_card()
    St, b = _system(2500, "cuda", dtype)
    ps = tfc.build_padded_stencil(St)
    rtol = 1e-5 if dtype == torch.float32 else 1e-8
    n0 = tfc.cg_sweep.launches
    x, it, res = tfc.fused_pcg(ps, b, maxit=2000, rtol=rtol)
    assert tfc.cg_sweep.launches - n0 == int(it) - 1
    rng = np.random.default_rng(3)
    rhs = [b]
    for idx in rng.choice(np.flatnonzero(b.cpu().numpy()), 4, replace=False):
        bb = b.clone()
        bb[idx] = torch.nextafter(bb[idx], bb[idx] * 2)
        rhs.append(bb)
    monkeypatch.setattr(tfc, "cg_sweep", tfc.cg_sweep_plain)
    its = [int(tfc.fused_pcg(ps, bb, maxit=2000, rtol=rtol)[1]) for bb in rhs]
    xp = tfc.fused_pcg(ps, b, maxit=2000, rtol=rtol)[0]
    assert 0.95 * min(its) <= int(it) <= 1.05 * max(its), (int(it), its)
    assert float(res[int(it) - 1]) <= rtol * float(torch.linalg.vector_norm(b))
    err = float(torch.linalg.vector_norm(x - xp) / torch.linalg.vector_norm(xp))
    assert err <= (1e-3 if dtype == torch.float32 else 1e-6), err
