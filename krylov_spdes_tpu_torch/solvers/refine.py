"""Iteratively refined PCG: working-precision Krylov iterations, certified
residual.

Port of `krylov_spdes_tpu/solvers/refine.py::refined_pcg`. The reference
hard-codes ‖r‖ ≤ 1e-7‖b‖ in float64 (RecyclingKrylovSolvers.jl:21,
cg.jl:33-35), but a plain float32 CG floors near 1e-5 relative residual.
Iterative refinement closes the gap:

    x ← 0 (df32 pair)
    repeat: r = b − A x  evaluated in float64 (ops/df32.py)
            stop when ‖r_hi‖ ≤ rtol·‖b‖     ← certified TRUE residual
            d = PCG(A, r_hi) at inner_rtol in the working dtype (the hot path)
            x ← x + d  (df32 accumulation)

The JAX package runs the loop in one `lax.while_loop`; here it is a host
loop over sweeps. The inner PCG is the port's `_pcg_impl`, whose A-apply on
the card is kernel A, as `_refined_impl` composes `_pcg_impl` with
`stencil_matvec`.
"""

from __future__ import annotations

import torch

from ..ops.df32 import df_add, stencil_residual_df32
from ..ops.stencil import StencilOp
from .base import SolveResult, as_precond_op, f32_exact
from .cg import _pcg_impl


@f32_exact
def refined_pcg(St: StencilOp, b, M=None, rtol: float = 1e-7,
                inner_rtol: float = 1e-5, inner_maxit: int = 4000,
                max_refine: int = 8):
    """PCG to the reference tolerance with working-precision iterations.

    Returns a SolveResult whose `it` is the total inner-CG iteration count
    and whose res_norm holds the certified residual; `refines` counts the
    refinement sweeps and `x_df32` is the (hi, lo) solution pair."""
    Mfn = as_precond_op(M)
    zero = torch.zeros_like(b)
    bnorm = torch.linalg.vector_norm(b)
    tol = torch.tensor(rtol, dtype=b.dtype, device=b.device) * bnorm

    def residual(xh, xl):
        return stencil_residual_df32(St.planes, St.dir_diag, St.H, St.W, b,
                                     zero, xh, xl)

    xh, xl = zero, zero
    rh, _ = residual(xh, xl)
    res = torch.linalg.vector_norm(rh)
    k, its = 0, 0
    while bool(res > tol) and k < max_refine:
        d, it, _ = _pcg_impl(St.matvec, Mfn, rh, zero, inner_maxit,
                             inner_rtol)
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
