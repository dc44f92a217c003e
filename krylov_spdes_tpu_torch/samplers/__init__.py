"""Samplers of the port (mirrors krylov_spdes_tpu/samplers)."""

from .samplers import (SamplerState, draw, metropolis_step,  # noqa: F401
                       prepare_hybrid_sampler, prepare_mc_sampler,
                       prepare_mcmc_sampler, set_xi, synthesize)
