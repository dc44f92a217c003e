"""Solvers of the port (mirrors krylov_spdes_tpu/solvers)."""

from .base import SolveResult, check_w_rank  # noqa: F401
from .cg import cg, pcg  # noqa: F401
from .eigcg import eigcg, eigpcg  # noqa: F401
from .defcg import defcg, defpcg, eigdefcg, eigdefpcg  # noqa: F401
from .initcg import initcg, initpcg  # noqa: F401
from .refine import refined_pcg  # noqa: F401
