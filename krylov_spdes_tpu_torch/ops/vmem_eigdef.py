"""Stretch-wise eigDef-PCG on the padded layout: kernel E.

Port of `krylov_spdes_tpu/ops/vmem_eigdef.py`. `solvers/defcg._eigdef_impl`
(the eigDef-PCG of defcg.jl:313-473, fused diagonal-preconditioner path)
launches a dozen kernels and reads one flag back per iteration. This module
runs whole restart-free stretches (spdim−1−ivec iterations) in ONE
persistent launch of kernel E (`csrc/eigdef_stretch.cu`) and reads back once
per stretch. Only the thick-restart iterations, which need an eigh of the
(spdim, spdim) projected matrix, run in torch, once per stretch.

The deflation algebra inside the stretch is reduced to grid arithmetic by
precomputing combined operands (all (nvec|2nvec, R, C)):

    U      = G r                       (2nvec reductions)
    r_fix  = Σ_k U_k · A1_k            A1 = (WᵀW)⁻¹ᵀ Wᵀ rows      [reorth]
    p_fix  = Σ_k U_k · B_k             B  = [−M₁KᵀM₂ Wᵀ; M₂ Wᵀ]   [deflation]

which is algebraically identical to the reference's
r ← r − W(WᵀW)⁻¹Wᵀr (defcg.jl:407) and p ← βp + z − W(WᵀAW)⁻¹WᵀAz
(defcg.jl:425-426) with z = m ⊙ r, using the same linearity identity as the
fused path of `_eigdef_impl` (WᵀA z = (WᵀA·m)r − [(WᵀA·m)W]cw). The only
numerical difference is explicit (nvec, nvec) inverses instead of Cholesky
solves.

V columns (z/√(rᵀz), defcg.jl:418-423) are appended by the kernel; the
per-iteration α, β and ‖r‖² stream to device memory so the host side
reconstructs the tridiagonal VtAV exactly as `_eigdef_impl`'s advance
branch does.

Layout: the port's `PaddedStencil` (ops/fused_cg.py), every vector an
(R, C) grid with zero pads. There is no size limit and no size switch: at
sizes where G, A1 and B outgrow the L2 the kernel streams them from HBM.

`stretch` takes the plain version for CPU tensors and launches kernel E for
CUDA tensors; `stretch.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers.base import f32_exact
from ..solvers.eig_common import thick_restart_basis
from . import cuda_build
from .fused_cg import (ROW0, PaddedStencil, _apply_plain, _check_grid, _jacobi_minv,
                       _unblock_planes, pad_vec, unpad_vec)

MAX_NVEC = 32   # csrc/eigdef_stretch.cu kMaxU = 2·MAX_NVEC


def _apply_xla(ps: PaddedStencil, x):
    """A·x on the padded grid outside the kernel (the JAX module's
    `_apply_xla`): the plain padded apply of ops/fused_cg.py."""
    return _apply_plain(ps, x)


def _gsum(a, b):
    return torch.sum(a * b)


def _combine(U, rows):
    """Σ_k U_k · rows_k, accumulated in the order k = 0, 1, ..."""
    acc = U[0] * rows[0]
    for k in range(1, rows.shape[0]):
        acc = acc + U[k] * rows[k]
    return acc


def _stretch_step(ps, minv, G, A1, B, x, r, p, rTz):
    """The vector updates of one eigDef-PCG iteration with the combined
    operands: shared by the plain stretch and the restart iteration.
    Returns (x, r, p, z, alpha, beta, rTr, rTz_new)."""
    nvec = A1.shape[0]
    ap = _apply_xla(ps, p)
    alpha = rTz / _gsum(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    U = torch.sum(G * r, dim=(1, 2))                 # (2nvec,)
    acc_p = _combine(U, B)
    r = r - _combine(U[:nvec], A1)                   # defcg.jl:407 reorth
    rTr = _gsum(r, r)
    z = minv * r
    rTz_new = _gsum(r, z)
    beta = rTz_new / rTz
    p = beta * p + z - acc_p                         # deflated direction
    return x, r, p, z, alpha, beta, rTr, rTz_new


def stretch_plain(ps: PaddedStencil, minv, G, A1, B, x, r, p, V, tol2, rTz,
                  res2_prev, nsteps: int, ivec0: int):
    """Plain PyTorch version of kernel E: up to `nsteps` advance iterations.

    minv, x, r, p: (R, C); G, B: (2nvec, R, C); A1: (nvec, R, C);
    V: (spdim, R, C), columns ivec0+1 … ivec0+cnt are appended in place and
    nothing else of V is touched. tol2, rTz, res2_prev: 0-d tensors.
    Returns (x, r, p, V, alphas, betas, res2, cnt, rTz, live): the streamed
    scalars are (spdim,) preset to 1, 0, 0; cnt (0-d int32) is the number
    of iterations run; live (0-d bool) says whether ‖r‖² is still above
    tol². The loop runs while i < nsteps and ‖r‖² > tol², ‖r‖² starting at
    res2_prev."""
    spdim = V.shape[0]
    alphas = x.new_ones(spdim)
    betas = x.new_zeros(spdim)
    res2 = x.new_zeros(spdim)
    i, cur = 0, res2_prev
    while i < nsteps and bool(cur > tol2):
        x, r, p, z, alpha, beta, rTr, rTz = _stretch_step(
            ps, minv, G, A1, B, x, r, p, rTz)
        V[ivec0 + i + 1] = z / torch.sqrt(rTz)
        alphas[i], betas[i], res2[i] = alpha, beta, rTr
        cur = rTr
        i += 1
    cnt = torch.tensor(i, dtype=torch.int32, device=x.device)
    return x, r, p, V, alphas, betas, res2, cnt, rTz, cur > tol2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("eigdef_stretch")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.eigdef_stretch_grid.argtypes = [ci] * 4
    lib.eigdef_stretch.argtypes = [ci, ci] + [vp] * 22 + [ci] * 7 + [vp]
    lib.eigdef_stretch_grid.restype = ci
    lib.eigdef_stretch.restype = ci
    return lib


def stretch(ps: PaddedStencil, minv, G, A1, B, x, r, p, V, tol2, rTz,
            res2_prev, nsteps: int, ivec0: int):
    """Kernel E on CUDA tensors, `stretch_plain` on CPU tensors; the same
    arguments and results. On the card x, r, p and V are updated in place
    (and returned); cnt and live stay on the card, for one read-back by the
    caller."""
    if x.device.type == "cpu":
        return stretch_plain(ps, minv, G, A1, B, x, r, p, V, tol2, rTz,
                             res2_prev, nsteps, ivec0)
    cuda_build.require_cuda(ps.planes, minv, G, A1, B, x, r, p, V, tol2, rTz,
                            res2_prev)
    _check_grid(ps, minv, x, r, p)
    nvec, spdim = A1.shape[0], V.shape[0]
    if nvec > MAX_NVEC:
        raise ValueError(f"kernel E takes nvec <= {MAX_NVEC}, got {nvec}")
    for name, t, rows in (("G", G, 2 * nvec), ("A1", A1, nvec),
                          ("B", B, 2 * nvec), ("V", V, spdim)):
        if t.shape != (rows, ps.R, ps.C):
            raise ValueError(f"{name}: expected ({rows}, {ps.R}, {ps.C}), "
                             f"got {tuple(t.shape)}")
    if not 0 <= nsteps <= spdim - 1 - ivec0:
        raise ValueError(f"nsteps {nsteps} leaves V (ivec0 {ivec0}, spdim "
                         f"{spdim})")
    lib = _lib()
    code = cuda_build.dtype_code(x)
    grid = lib.eigdef_stretch_grid(code, ps.K, ps.H, ps.W)
    if grid < 0:
        cuda_build.check(lib, -grid, "eigdef_stretch_grid")
    ap, accp = torch.zeros_like(x), torch.zeros_like(x)
    part = x.new_empty((2 * nvec + 3) * grid)
    U = x.new_empty(2 * nvec)
    counter = torch.zeros((), dtype=torch.int32, device=x.device)
    alphas, betas, res2 = x.new_ones(spdim), x.new_zeros(spdim), x.new_zeros(spdim)
    info = torch.zeros(2, dtype=torch.int32, device=x.device)
    rTz_out = x.new_empty(())
    c = cuda_build.ptr
    err = lib.eigdef_stretch(
        code, ps.K, c(ps.planes), c(minv), c(G), c(A1), c(B), c(x), c(r),
        c(p), c(V), c(ap), c(accp), c(part), c(U), c(counter), c(tol2),
        c(rTz), c(res2_prev), c(alphas), c(betas), c(res2), c(info),
        c(rTz_out), ps.H, ps.W, ps.C, nvec, nsteps, ivec0, grid,
        cuda_build.stream(x))
    cuda_build.check(lib, err, "eigdef_stretch")
    stretch.launches += 1
    return (x, r, p, V, alphas, betas, res2, info[0], rTz_out,
            info[1].to(torch.bool))


stretch.launches = 0


def _restart_iteration(ps, minv, G, A1, B, WtA, nvec, spdim, st, tol2):
    """One full eigDef-PCG iteration at ivec == spdim−1 (the JAX module's
    `_xla_restart_iteration`): the vector updates
    with the same combined-operand algebra as the kernel, then the thick
    restart (defcg.jl:428-436 / eigcg.jl:83-101), which needs an eigh and
    therefore runs outside the kernel. Updates `st` in place; the stop test
    and the restart's rank come back in one read. `_restart_iteration.calls`
    counts the restarts, as `stretch.launches` counts the stretches."""
    _restart_iteration.calls += 1
    it, ivec, V, VtAV = st["it"], st["ivec"], st["V"], st["VtAV"]
    x, r, p, z, alpha, beta, rTr, rTz = _stretch_step(
        ps, minv, G, A1, B, st["x"], st["r"], st["p"], st["rTz"])
    st["res_norm"][it] = torch.sqrt(rTr)
    vcol = (z / torch.sqrt(rTz)).reshape(-1)

    VtAV[ivec, ivec] += 1.0 / alpha
    V2 = V.view(spdim, -1)
    if st["first"]:
        VtAV[:nvec, nvec:] = WtA @ V2[nvec:spdim].T
    vals, QZ, nev = thick_restart_basis(VtAV, nvec, spdim)
    live, nev = (int(v) for v in torch.stack(
        [(rTr > tol2).to(torch.int64), nev]).tolist())
    V2[:2 * nvec] = QZ.T @ V2
    V2[nev] = vcol
    VtAV.zero_()
    d = torch.arange(2 * nvec, device=VtAV.device)
    VtAV[d, d] = vals
    VtAV[nev, nev] = beta / alpha
    st.update(x=x, r=r, p=p, rTz=rTz, res2=rTr, it=it + 1, ivec=nev,
              first=False, jr=True, live=bool(live))


_restart_iteration.calls = 0


def stretch_operands(ps: PaddedStencil, minv, bp, Wp):
    """Setup of a solve (once per solve): the combined operands of the
    stretches and the deflated start (defcg.jl:361-377).

    Wp: (nvec, R, C) padded deflation basis. Returns a dict with G, B
    (2nvec, R, C), A1 (nvec, R, C), WtA (nvec, R·C), WtAW, and the start
    x, r, p, z (R, C), rTz, rTr (0-d)."""
    nvec = Wp.shape[0]
    R, C = ps.R, ps.C
    Wf = Wp.reshape(nvec, R * C)
    WtA = torch.stack([_apply_xla(ps, w).reshape(-1) for w in Wp])
    WtAW = WtA @ Wf.T
    WtW = Wf @ Wf.T
    cho = torch.linalg.cholesky(WtAW)
    cho_w = torch.linalg.cholesky(WtW)
    WtAM = WtA * minv.reshape(-1)[None, :]
    Km = WtAM @ Wf.T
    eye = torch.eye(nvec, dtype=bp.dtype, device=bp.device)
    M1 = torch.cholesky_solve(eye, cho_w)             # (WᵀW)⁻¹
    M2 = torch.cholesky_solve(eye, cho)               # (WᵀAW)⁻¹
    G = torch.cat([Wf, WtAM]).reshape(2 * nvec, R, C)
    A1 = (M1 @ Wf).reshape(nvec, R, C)                # rows: reorth operand
    B = torch.cat([-(M1 @ Km.T @ M2) @ Wf, M2 @ Wf]).reshape(2 * nvec, R, C)

    # deflated initial guess + first direction
    bf = bp.reshape(-1)
    x = (Wf.T @ torch.cholesky_solve((Wf @ bf)[:, None], cho)[:, 0]).reshape(R, C)
    r = bp - _apply_xla(ps, x)
    z = minv * r
    mu = torch.cholesky_solve((WtA @ z.reshape(-1))[:, None], cho)[:, 0]
    p = z - (mu @ Wf).reshape(R, C)
    return dict(G=G, A1=A1, B=B, WtA=WtA, WtAW=WtAW, x=x, r=r, p=p, z=z,
                rTz=_gsum(r, z), rTr=_gsum(r, r))


@f32_exact
def _vmem_eigdef_impl(ps: PaddedStencil, minv, bp, Wp, nvec, spdim, maxit,
                      rtol):
    """Segmented eigDef-PCG: kernel stretches + torch restarts.

    Wp: (nvec, R, C) padded deflation basis. Same iteration and restart
    semantics as solvers.defcg._eigdef_impl (fused path)."""
    R, C = ps.R, ps.C
    dev = bp.device
    ops = stretch_operands(ps, minv, bp, Wp)
    G, A1, B, WtA, WtAW = (ops[k] for k in ("G", "A1", "B", "WtA", "WtAW"))
    x, r, p, z, rTz, rTr0 = (ops[k] for k in ("x", "r", "p", "z", "rTz",
                                              "rTr"))
    res_norm = bp.new_zeros(maxit)
    res_norm[0] = torch.sqrt(rTr0)
    tol = torch.as_tensor(rtol, dtype=bp.dtype, device=dev) * torch.sqrt(_gsum(bp, bp))
    tol2 = tol * tol

    V = bp.new_zeros((spdim, R, C))
    V[:nvec] = Wp
    V[nvec] = z / torch.sqrt(rTz)
    VtAV = bp.new_zeros((spdim, spdim))
    VtAV[:nvec, :nvec] = WtAW

    st = dict(x=x, r=r, p=p, rTz=rTz, res2=rTr0, it=1, ivec=nvec, V=V,
              VtAV=VtAV, first=True, jr=False, res_norm=res_norm,
              live=bool(rTr0 > tol2))
    while st["it"] < maxit and st["live"]:
        it, ivec = st["it"], st["ivec"]
        nsteps = min(spdim - 1 - ivec, maxit - it)
        if nsteps > 0:
            x, r, p, V, alphas, betas, res2, cnt, rTz, live = stretch(
                ps, minv, G, A1, B, st["x"], st["r"], st["p"], st["V"], tol2,
                st["rTz"], st["res2"], nsteps, ivec)
            # the one read-back of the stretch
            cnt, live = torch.stack([cnt, live.to(torch.int32)]).tolist()
            if cnt > 0:
                # residual history + the tridiagonal VtAV advances
                # (defcg.jl:415-423) from the streamed scalars
                a, b_ = alphas[:cnt], betas[:cnt]
                idx = ivec + torch.arange(cnt, device=dev)
                res_norm[it:it + cnt] = torch.sqrt(res2[:cnt])
                VtAV[idx + 1, idx + 1] = b_ / a
                VtAV[idx, idx] += 1.0 / a
                VtAV[idx, idx + 1] = -torch.sqrt(b_) / a
                st.update(x=x, r=r, p=p, rTz=rTz, res2=res2[cnt - 1],
                          it=it + cnt, ivec=ivec + cnt, jr=False,
                          live=bool(live))
        # restart iteration (only when still iterating: ivec == spdim−1)
        if st["it"] < maxit and st["live"]:
            _restart_iteration(ps, minv, G, A1, B, WtA, nvec, spdim, st, tol2)

    # post-loop harvest (defcg.jl:438-465), same as _eigdef_impl
    V2 = st["V"].view(spdim, R * C)
    m = st["ivec"]
    if not st["jr"] and m > nvec:
        if st["first"]:
            VtAV[:nvec, nvec:m] = WtA @ V2[nvec:m].T
        _, QZ, _ = thick_restart_basis(VtAV, nvec, m)
        V2[:2 * nvec] = QZ.T @ V2
    return st["x"], st["it"], res_norm, st["V"][:nvec]


def vmem_eigdefpcg(ps: PaddedStencil, b_full, W, mdiag_full=None,
                   spdim: int = 48, maxit: int = 0, rtol: float = 1e-7):
    """eigDef-PCG with a diagonal preconditioner, stretch-wise execution.

    W: (n, nvec) full-grid deflation basis (Dirichlet rows zero).
    mdiag_full: (n,) MATRIX diagonal of the preconditioner; it is inverted
    internally, like fused_pcg (defaults to A's own diagonal = Jacobi).
    This is the opposite convention from solvers.defcg.eigdefpcg's `Mdiag`,
    which takes the already-inverted diagonal.
    Returns (x_full, it, res_norm, W_new (n, nvec)) with the iteration and
    recycling semantics of solvers.defcg.eigdefpcg (defcg.jl:313-473)."""
    n = ps.H * ps.W
    nvec = W.shape[1]
    assert spdim >= 2 * nvec + 1
    maxit = n if maxit == 0 else maxit
    bp = pad_vec(ps, b_full)
    minv = _jacobi_minv(ps, _unblock_planes(ps), mdiag_full).to(bp.dtype)
    Wp = bp.new_zeros((nvec, ps.R, ps.C))
    Wp[:, ROW0:ROW0 + ps.H, :ps.W] = W.T.reshape(nvec, ps.H, ps.W)
    x, it, res, Wf = _vmem_eigdef_impl(ps, minv, bp, Wp, nvec, spdim, maxit,
                                       rtol)
    Wn = Wf[:, ROW0:ROW0 + ps.H, :ps.W].reshape(nvec, n).T.contiguous()
    return unpad_vec(ps, x), torch.tensor(it, dtype=torch.int32), res, Wn
