"""Iteratively refined PCG: working-precision Krylov iterations, certified
residual.

Port of `krylov_spdes_tpu/solvers/refine.py`. The reference hard-codes
‖r‖ ≤ 1e-7‖b‖ in float64 (RecyclingKrylovSolvers.jl:21, cg.jl:33-35), but a
plain float32 CG floors near 1e-5 relative residual. Iterative refinement
closes the gap:

    x ← 0 (df32 pair)
    repeat: r = b − A x  evaluated in float64 (ops/df32.py)
            stop when ‖r_hi‖ ≤ rtol·‖b‖     ← certified TRUE residual
            d = PCG(A, r_hi) at inner_rtol in the working dtype (the hot path)
            x ← x + d  (df32 accumulation)

The JAX package runs the stencil and sparse loops in one `lax.while_loop`;
here every loop is a host loop over sweeps. The inner PCG is the port's
`_pcg_impl`, whose A-apply on the card is kernel A for a StencilOp. Every
solver here runs with TF32 off (`f32_exact`), whatever the caller's
setting, preconditioner applies included.
"""

from __future__ import annotations

import math

import torch

from ..ops.df32 import (build_gamma_pullback, dd_residual_df32, df_add,
                        ell_residual_df32, stencil_residual_df32)
from ..ops.stencil import StencilOp
from .base import SolveResult, as_linear_op, as_precond_op, f32_exact
from .cg import _pcg_impl, pcg
from .defcg import defpcg


def _refine(A, M, b, residual, rtol, inner_rtol, inner_maxit, max_refine):
    """The sweeps of refined_pcg / refined_pcg_sparse: the stop test in b's
    dtype (‖r_hi‖ > rtol·‖b‖), as the JAX package's `while_loop` makes it."""
    zero = torch.zeros_like(b)
    bnorm = torch.linalg.vector_norm(b)
    tol = torch.tensor(rtol, dtype=b.dtype, device=b.device) * bnorm
    xh, xl = zero, zero
    rh, _ = residual(xh, xl)
    res = torch.linalg.vector_norm(rh)
    k, its = 0, 0
    while bool(res > tol) and k < max_refine:
        d, it, _ = _pcg_impl(A, M, rh, zero, inner_maxit, inner_rtol)
        xh, xl = df_add(xh, xl, d, torch.zeros_like(d))
        rh, _ = residual(xh, xl)
        res = torch.linalg.vector_norm(rh)
        k += 1
        its += it
    r = SolveResult(x=xh + xl, it=torch.tensor(its, dtype=torch.int32),
                    res_norm=res.reshape(1), W=None,
                    breakdown=bool(float(res) > rtol * float(bnorm)))
    r.refines = k
    r.x_df32 = (xh, xl)
    return r


@f32_exact
def refined_pcg(St: StencilOp, b, M=None, rtol: float = 1e-7,
                inner_rtol: float = 1e-5, inner_maxit: int = 4000,
                max_refine: int = 8):
    """PCG to the reference tolerance with working-precision iterations.

    Returns a SolveResult whose `it` is the total inner-CG iteration count
    and whose res_norm holds the certified residual; `refines` counts the
    refinement sweeps and `x_df32` is the (hi, lo) solution pair."""
    zero = torch.zeros_like(b)

    def residual(xh, xl):
        return stencil_residual_df32(St.planes, St.dir_diag, St.H, St.W, b,
                                     zero, xh, xl)

    return _refine(St.matvec, as_precond_op(M), b, residual, rtol,
                   inner_rtol, inner_maxit, max_refine)


@f32_exact
def refined_pcg_sparse(A, b, M=None, rtol: float = 1e-7,
                       inner_rtol: float = 1e-5, inner_maxit: int = 4000,
                       max_refine: int = 8, single_trace: bool = True):
    """Certified-1e-7 PCG for any fixed-sparsity SparseOp: refined_pcg's
    loop with the residual of `ell_residual_df32`.

    `single_trace` chooses, in the JAX package, between one device program
    for all sweeps and a host loop of one program a sweep (its sweep-level
    form bounds the time of one dispatch). The port runs every sweep from
    the host either way, so both values give the same `it`, `refines` and
    certified residual; the argument stays so that callers of either
    package read alike."""
    zero = torch.zeros_like(b)

    def residual(xh, xl):
        return ell_residual_df32(A, b, zero, xh, xl)

    return _refine(as_linear_op(A), as_precond_op(M), b, residual, rtol,
                   inner_rtol, inner_maxit, max_refine)


def _contracts(res, prev):
    """False when a sweep failed to contract the residual by half (or gave
    a non-finite one): the inner solver broke down, and the caller restores
    its best iterate and stops."""
    return not (res > 0.5 * prev or not math.isfinite(res))


@f32_exact
def refined_dd_pcg(plan, S, op, b_I, b_G, A_II, A_IG, A_GGd, M=None,
                   rtol: float = 1e-7, inner_rtol: float = 1e-5,
                   inner_maxit: int = 2000, max_refine: int = 8, pull=None):
    """Schur-DD solve certified at the reference tolerance.

    Each sweep condenses the full-system residual (r_I, r_Γ), evaluated in
    float64 (`dd_residual_df32`), through the Schur machinery of
    fem/schur.py, solves the interface correction with PCG on `op` (S, or
    the assembled-Sd apply) at inner_rtol, back-substitutes the interiors
    and accumulates in df32, until the full-system residual is certified
    below rtol·‖(b_I, b_Γ)‖. A sweep that contracts by less than half
    restores the best iterate and stops (`breakdown` then reports it).

    plan/S: the DD assembly plan and its SchurOperator; A_II/A_IG/A_GGd:
    the raw assembled blocks; M: the interface preconditioner; pull: the
    pullback table (`build_gamma_pullback`), a per-plan constant. Returns a
    SolveResult on u_Γ: `it` the total inner iterations, `refines` the
    sweeps, `res_norm[0]` the certified absolute full residual, `x_df32`
    and `u_I` the interface and interior df32 pairs, `bnorm` ‖(b_I, b_Γ)‖."""
    from ..fem.schur import get_schur_rhs, get_subdomain_solutions
    im, gm = plan.imask, plan.gmask
    A_IIm = A_II * im[:, :, None] * im[:, None, :]
    A_IGm = A_IG * im[:, :, None] * gm[:, None, :]
    A_GGm = A_GGd * gm[:, :, None] * gm[:, None, :]
    b_Im = b_I * im
    if pull is None:
        pull = build_gamma_pullback(S.gammad_to_gamma, S.gmask, S.n_gamma)
    bnorm = float(torch.sqrt(torch.sum(b_Im * b_Im) + torch.sum(b_G * b_G)))

    uIh = uIl = torch.zeros_like(b_Im)
    uGh = uGl = torch.zeros_like(b_G)
    its, best, prev, k = 0, None, math.inf, 0
    for k in range(max_refine + 1):
        (rIh, _), (rGh, _) = dd_residual_df32(
            A_IIm, A_IGm, A_GGm, S.gammad_to_gamma, S.gmask, pull, b_Im,
            b_G, uIh, uIl, uGh, uGl)
        rIh = rIh * im
        res = float(torch.sqrt(torch.sum(rIh * rIh) + torch.sum(rGh * rGh)))
        if best is None or res < best[0]:
            best = (res, uIh, uIl, uGh, uGl)
        if res <= rtol * bnorm or k == max_refine:
            break
        if not _contracts(res, prev):
            res, uIh, uIl, uGh, uGl = best
            break
        prev = res
        d = pcg(op, get_schur_rhs(S, rIh, rGh), M=M, rtol=inner_rtol,
                maxit=inner_maxit)
        d_I = get_subdomain_solutions(S, d.x, rIh)
        uGh, uGl = df_add(uGh, uGl, d.x, torch.zeros_like(d.x))
        uIh, uIl = df_add(uIh, uIl, d_I, torch.zeros_like(d_I))
        its += int(d.it)

    r = SolveResult(x=uGh + uGl, it=torch.tensor(its, dtype=torch.int32),
                    res_norm=torch.tensor([res], dtype=torch.float64),
                    W=None, breakdown=bool(res > rtol * bnorm))
    r.refines = k
    r.x_df32 = (uGh, uGl)
    r.u_I = (uIh, uIl)
    r.bnorm = bnorm
    return r


@f32_exact
def refined_recycled_solve(A, b, first_solve, correct_W=None, M=None,
                           rtol: float = 1e-7, inner_rtol: float = 1e-5,
                           inner_maxit: int = 2000, max_refine: int = 8):
    """Certified-1e-7 wrapper around a recycling solve.

    `first_solve()` runs the method's full solve (pcg, eigpcg, eigdefpcg,
    defpcg: any solve of the port that returns a SolveResult) at inner_rtol;
    the sweeps then solve A d = r on the float64-evaluated true residual
    with Def-PCG deflated by the basis the first solve returned (or
    `correct_W`), or with PCG when there is none. W is not harvested again
    during the corrections: the basis handed on is the first solve's. A
    sweep that contracts by less than half restores the best iterate and
    stops. A must be a SparseOp (the residual rides its ELL view).

    Returns the first solve's result with x replaced by the refined iterate,
    `it` the total iterations, and `refines`, `x_df32`, `bnorm`."""
    bnorm = float(torch.linalg.vector_norm(b))
    r0 = first_solve()
    W = r0.W if correct_W is None else correct_W
    xh = r0.x
    xl = torch.zeros_like(xh)
    its = int(r0.it)
    zero = torch.zeros_like(b)
    best, prev, k = None, math.inf, 0
    for k in range(max_refine + 1):
        rh, _ = ell_residual_df32(A, b, zero, xh, xl)
        res = float(torch.linalg.vector_norm(rh))
        if best is None or res < best[0]:
            best = (res, xh, xl)
        if res <= rtol * bnorm or k == max_refine:
            break
        if not _contracts(res, prev):
            res, xh, xl = best
            break
        prev = res
        if W is not None:
            d = defpcg(A, rh, W=W, M=M, rtol=inner_rtol, maxit=inner_maxit)
        else:
            d = pcg(A, rh, M=M, rtol=inner_rtol, maxit=inner_maxit)
        xh, xl = df_add(xh, xl, d.x, torch.zeros_like(d.x))
        its += int(d.it)

    out = SolveResult(x=xh + xl, it=torch.tensor(its, dtype=torch.int32),
                      res_norm=torch.tensor([res], dtype=torch.float64),
                      W=r0.W, breakdown=bool(res > rtol * bnorm))
    out.refines = k
    out.x_df32 = (xh, xl)
    out.bnorm = bnorm
    return out
