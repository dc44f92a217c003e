"""KL layer of the port (mirrors krylov_spdes_tpu/kl)."""

from .covariance import cov_exp, cov_matrix, cov_sexp, make_cov  # noqa: F401
from .single import mass_covariance_operator, solve_kl  # noqa: F401
from .dd import (set_kl_subdomains, solve_local_kls,  # noqa: F401
                 assemble_reduced_covariance, solve_global_reduced_kl,
                 compute_dd_kl, draw_dd)
from .synthesis import (draw, get_kl_coordinates, set_field,  # noqa: F401
                        trim_and_order)
from .helper import get_root_filename, suggest_parameters  # noqa: F401
from .lobpcg import lobpcg_generalized  # noqa: F401
