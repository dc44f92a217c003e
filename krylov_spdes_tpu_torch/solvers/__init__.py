"""Solvers of the port (mirrors krylov_spdes_tpu/solvers)."""

from .base import SolveResult, check_w_rank  # noqa: F401
from .cg import cg, pcg  # noqa: F401
from .eigcg import eigcg, eigpcg  # noqa: F401
from .defcg import defcg, defpcg, eigdefcg, eigdefpcg  # noqa: F401
from .initcg import initcg, initpcg  # noqa: F401
from .lanczos import lanczos  # noqa: F401
from .recyclers import (  # noqa: F401
    rrdefpcg, rrpcg, hrdefpcg, hrpcg,
    trrrdefpcg, trrrpcg, trhrdefpcg, trhrpcg,
    lotrrrdefpcg, lotrrrpcg, lotrhrdefpcg, lotrhrpcg)
from .recycler_state import Recycler, prepare_recycler  # noqa: F401
from .block_cg import block_pcg  # noqa: F401
from .pipelined_cg import pipelined_pcg  # noqa: F401
from .refine import (refined_dd_pcg, refined_pcg,  # noqa: F401
                     refined_pcg_sparse, refined_recycled_solve)
