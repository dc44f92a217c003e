"""Metrics, persistence and spectral diagnostics of the port (mirrors
krylov_spdes_tpu/utils)."""

from .metrics import (PhaseMetrics, printlnln, profiler_trace,  # noqa: F401
                      space_println)
from .persistence import (load_chain_checkpoint,  # noqa: F401
                          load_deflated_system, load_system,
                          save_chain_checkpoint, save_deflated_system,
                          save_system)
from .diagnostics import condition_estimate, preconditioned_spectrum  # noqa: F401
