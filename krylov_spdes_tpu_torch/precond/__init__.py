"""Preconditioners of the port (mirrors krylov_spdes_tpu/precond)."""

from .simple import jacobi_precond, sparse_diagonal  # noqa: F401
