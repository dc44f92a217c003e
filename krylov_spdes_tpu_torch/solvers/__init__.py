"""Solvers of the port (mirrors krylov_spdes_tpu/solvers)."""

from .base import SolveResult  # noqa: F401
from .cg import cg, pcg  # noqa: F401
from .refine import refined_pcg  # noqa: F401
