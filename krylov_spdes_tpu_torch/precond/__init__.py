"""Preconditioners of the port (mirrors krylov_spdes_tpu/precond)."""

from .simple import jacobi_precond, chebyshev_precond, sparse_diagonal  # noqa
from .block_jacobi import (prepare_block_jacobi_plan,  # noqa
                           block_jacobi_precond)
from .cholesky import get_cholesky, get_cholesky32, get_cholesky16  # noqa
from .amg import amg_precond, amg_setup  # noqa
from .dd_preconds import (prepare_lorasc_precond, prepare_ddlr_precond,  # noqa
                          prepare_nn_induced_precond, assemble_gamma_matrix)
