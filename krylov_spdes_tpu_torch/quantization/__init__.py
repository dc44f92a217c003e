"""Quantization of the latent space and preconditioner banks of the port
(mirrors krylov_spdes_tpu/quantization)."""

from .quantizers import (clvq, deterministic_grid, distortion,  # noqa: F401
                         get_gain_sequence, get_quantizer, kmeans,
                         nearest_centroid)
from .precond_bank import (build_centroidal_preconds,  # noqa: F401
                           select_nearest, shepard_interpolating_precond,
                           truncated_kl_precond)
