"""Linear-operator protocol and solver result types.

Port of `krylov_spdes_tpu/solvers/base.py`. The reference relies on Julia
duck typing: solvers accept `A::Union{SparseMatrixCSC, FunctionMap}` and
preconditioners are "anything supporting `M \\ r`" (cg.jl:14-17). Here:
anything convertible to an `x -> A x` callable on tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch


def f32_exact(fn):
    """Run `fn` with TF32 off for float32 matrix products.

    The JAX package forces HIGHEST matmul precision around contractions that
    build projectors (deflation Gram matrices, basis restarts, DD
    condensations): at reduced precision they carry ~1e-3 relative error and
    the projected iteration diverges. On the card TF32 plays the part of the
    TPU's bf16 passes, so it stays off inside `fn` (cuBLAS and cuDNN), and
    the previous settings are restored afterwards."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*a, **k)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    return wrapped


def _identity(r):
    return r


def as_linear_op(A) -> Callable:
    """Normalize an operator to an `x -> A x` callable: an object with a
    `matvec` (SparseOp, StencilOp), a dense 2-D tensor, or a callable."""
    if callable(getattr(A, "matvec", None)):
        return A.matvec
    if isinstance(A, torch.Tensor) and A.ndim == 2:
        return lambda x: A @ x
    if callable(A):
        return A
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")


def as_precond_op(M) -> Callable:
    """Normalize a preconditioner to an `r -> M^{-1} r` callable."""
    if M is None:
        return _identity
    if isinstance(M, torch.Tensor) and M.ndim == 2:
        # Dense M^{-1} given explicitly.
        return lambda r: M @ r
    if callable(M):
        return M
    raise TypeError(f"cannot interpret {type(M)} as a preconditioner")


def apply_block(fn, X):
    """fn applied to every column of X (n, k) in one call, the port's form of
    the JAX package's `jax.vmap(fn)`: the operators and preconditioners of
    the port (SparseOp, dense tensors, jacobi_precond, amg_precond) take an
    (n, k) block as well as a vector. A callable that does not is refused
    rather than looped over k single applies."""
    Y = fn(X)
    if Y.shape != X.shape:
        raise TypeError(f"{fn!r} does not take an (n, k) block: it returned "
                        f"{tuple(Y.shape)} for {tuple(X.shape)}")
    return Y


@dataclasses.dataclass
class SolveResult:
    """x: solution; it: number of recorded residual norms, matching the
    reference's `it` (initial residual counts as 1, cf. cg.jl:35-47);
    res_norm: (maxit,) padded residual-norm history — entries at index >= it
    are zero. Use `history()` for the trimmed view."""
    x: torch.Tensor
    it: torch.Tensor
    res_norm: torch.Tensor
    W: torch.Tensor | None = None  # recycled deflation basis, when produced
    # Set by the certified wrappers (solvers/refine.py) when the exit residual
    # exceeds the certification tolerance: a huge-but-finite floor is a
    # breakdown too, not only NaN/Inf.
    breakdown: bool = False

    def history(self):
        return self.res_norm.detach().cpu().numpy()[:int(self.it)]

    @property
    def failed(self) -> bool:
        """True when the solve broke down (NaN/Inf residual) or a certified
        wrapper exited above its tolerance (`breakdown`). The reference
        throws and its example scripts discard and retry the chain
        (Example09..._Functions.jl:358-360)."""
        if self.breakdown:
            return True
        h = self.history()
        return bool(h.size == 0 or not np.isfinite(h[-1]))

    def converged(self, b, rtol: float = 1e-7) -> bool:
        h = self.history()
        bnorm = float(torch.linalg.vector_norm(torch.as_tensor(b)))
        return bool(h.size and np.isfinite(h[-1]) and h[-1] <= rtol * bnorm)


def check_w_rank(W, frac: float = 0.9) -> bool:
    """Deflation-basis health guard: True when rank(W) >= frac * nvec
    (the reference's chain-abort criterion, Example09..._Functions.jl:358).
    Host-side, with numpy's rank tolerance."""
    W = W.detach().cpu().numpy() if torch.is_tensor(W) else np.asarray(W)
    return bool(np.linalg.matrix_rank(W) >= frac * W.shape[1])
