"""PyTorch + CUDA port of `krylov_spdes_tpu`, for one NVIDIA Hopper card.

The JAX package stays the reference; this package mirrors its module layout
(`fem/`, `ops/`, `solvers/`, `precond/`, `samplers/`, `kl/`, `chains.py`, `dd_chains.py`) so each counterpart is easy to find.
It imports torch, numpy and scipy only, never jax or `krylov_spdes_tpu`.
The Pallas kernels of the JAX package become hand-written CUDA C++ kernels
under `csrc/`, built with nvcc at first use (`ops/cuda_build.py`).

Entry points default to `config.device` ("cuda"); the CPU is used only when
the caller passes it, and then every kernel wrapper runs its plain PyTorch
version.
"""

from . import config as _config  # noqa: F401
from . import (chains, dd_chains, entry, fem, kl, ops, precond,  # noqa: F401
               samplers, solvers)

__version__ = "0.1.0"
