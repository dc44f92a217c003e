"""MC / MCMC / hybrid samplers of the KL latent vector.

Port of `krylov_spdes_tpu/samplers/samplers.py` (reference:
Fem/Samplers.jl:1-322). A sampler is a `SamplerState` dataclass of tensors
and plain functions that return a new state; the state carries an explicit
`torch.Generator` where the JAX package carries a PRNG key. torch's Philox
stream is not `jax.random`'s, so the accept/reject arithmetic lives in
`metropolis_step`, a pure function of (ξ, normals, uniform) that can be fed
the numbers another stream drew.

Semantics, as in the JAX package:
- MC: ξ ~ N(0, I_m) iid per draw (Samplers.jl:76-83).
- MCMC: random-walk Metropolis with proposal variance ϑ² = 2.38²σ²/m
  (Samplers.jl:139), acceptance ratio on the prior only
  (α = exp((‖ξ‖²-‖χ‖²)/2σ²), Samplers.jl:173-177); rejections loop inside
  the draw and each draw returns the number of proposals it consumed
  (Samplers.jl:165-199). The loop is a host loop: one accept flag is read
  back per proposal.
- Hybrid: the first m_mcmc modes by MCMC, the remaining modes iid N(0,1)
  refreshed every draw (Samplers.jl:208-322).
- Field synthesis: g = Σ_k √λ_k ξ_k ψ_k as one matvec (Samplers.jl:44-48).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import resolve


@dataclasses.dataclass
class SamplerState:
    xi: torch.Tensor        # (m,) latent vector
    g: torch.Tensor         # (nnode,) current field realization
    gen: torch.Generator    # random stream (the JAX package's key)
    sqrt_lam: torch.Tensor  # (m,) √Λ
    psi: torch.Tensor       # (nnode, m) KL modes
    kind: str               # "mc" | "mcmc" | "hybrid"
    m_mcmc: int             # modes sampled by MCMC (hybrid); m for pure MCMC
    sigma2: float           # prior variance σ²

    @property
    def m(self) -> int:
        return self.sqrt_lam.shape[0]


def synthesize(sqrt_lam, psi, xi):
    """g = Ψ (√Λ ⊙ ξ): the KL field synthesis matvec."""
    return psi @ (sqrt_lam * xi)


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _normal(gen, shape, ref):
    return torch.randn(shape, generator=gen, dtype=ref.dtype, device=ref.device)


def _prepare(kind, lam, psi, seed, m_mcmc=None, sigma2=1.0, device=None,
             dtype=None):
    device, dtype = resolve(device, dtype)
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    psi = torch.as_tensor(psi, dtype=dtype, device=device)
    m = lam.shape[0]
    gen = seed if isinstance(seed, torch.Generator) else make_generator(
        seed, device)
    xi = _normal(gen, (m,), psi) * math.sqrt(sigma2)
    sqrt_lam = torch.sqrt(lam)
    return SamplerState(
        xi=xi, g=synthesize(sqrt_lam, psi, xi), gen=gen, sqrt_lam=sqrt_lam,
        psi=psi, kind=kind, m_mcmc=int(m if m_mcmc is None else m_mcmc),
        sigma2=float(sigma2))


def prepare_mc_sampler(lam, psi, key=0, device=None, dtype=None) -> SamplerState:
    """`key` is the seed of the state's generator (or a generator)."""
    return _prepare("mc", lam, psi, key, device=device, dtype=dtype)


def prepare_mcmc_sampler(lam, psi, key=0, device=None,
                         dtype=None) -> SamplerState:
    return _prepare("mcmc", lam, psi, key, device=device, dtype=dtype)


def prepare_hybrid_sampler(lam, psi, m_mcmc: int, key=0, device=None,
                           dtype=None) -> SamplerState:
    return _prepare("hybrid", lam, psi, key, m_mcmc=m_mcmc, device=device,
                    dtype=dtype)


def _draw_mc(state: SamplerState):
    xi = _normal(state.gen, state.xi.shape, state.xi)
    g = synthesize(state.sqrt_lam, state.psi, xi)
    return dataclasses.replace(state, xi=xi, g=g), 1


def metropolis_step(xi_head, normal, u, m_mcmc: int, sigma2: float):
    """One random-walk Metropolis proposal on the first m_mcmc modes.

    xi_head: (m_mcmc,) current modes; normal: (m_mcmc,) standard normals;
    u: 0-d uniform in [0, 1). Returns (χ, accepted) with
    χ = ξ + ϑ·normal, ϑ² = 2.38²σ²/m_mcmc (Samplers.jl:139), and
    accepted = u ≤ min(1, exp((‖ξ‖² − ‖χ‖²)/2σ²)) as a 0-d bool tensor."""
    theta = 2.38 ** 2 * sigma2 / m_mcmc
    sq_xi = torch.sum(xi_head ** 2)
    chi = xi_head + normal * math.sqrt(theta)
    sq_chi = torch.sum(chi ** 2)
    alpha = torch.where(sq_xi < sq_chi,
                        torch.exp((sq_xi - sq_chi) / (2 * sigma2)),
                        torch.ones_like(sq_chi))
    return chi, u <= alpha


def _stream(state: SamplerState):
    """(normals, uniform) pairs for the proposals, from the state's
    generator."""
    while True:
        normal = _normal(state.gen, (state.m_mcmc,), state.xi)
        u = torch.rand((), generator=state.gen, dtype=state.xi.dtype,
                       device=state.xi.device)
        yield normal, u


def _draw_mcmc(state: SamplerState, proposals=None, tail=None):
    """One accepted Metropolis move. `proposals`, an iterator of (normals,
    uniform) pairs, and `tail`, the hybrid sampler's refreshed modes, take
    the place of the state's generator when given (the parity tests feed
    the numbers another stream drew)."""
    m_mcmc = state.m_mcmc
    head = state.xi[:m_mcmc]
    cnt = 0
    for normal, u in (_stream(state) if proposals is None else proposals):
        chi, accepted = metropolis_step(head, normal, u, m_mcmc, state.sigma2)
        cnt += 1
        if bool(accepted):
            break
    xi = state.xi.clone()
    xi[:m_mcmc] = chi
    if state.kind == "hybrid" and m_mcmc < state.m:
        xi[m_mcmc:] = (_normal(state.gen, (state.m - m_mcmc,), state.xi)
                       if tail is None else tail)
    g = synthesize(state.sqrt_lam, state.psi, xi)
    return dataclasses.replace(state, xi=xi, g=g), cnt


def draw(state: SamplerState):
    """Advance the sampler one realization. Returns (new_state, n_proposals)."""
    if state.kind == "mc":
        return _draw_mc(state)
    return _draw_mcmc(state)


def set_xi(state: SamplerState, xi):
    """Force a given latent vector (reference `set!`, Samplers.jl:96-103)."""
    xi = torch.as_tensor(xi, dtype=state.xi.dtype, device=state.xi.device)
    return dataclasses.replace(
        state, xi=xi, g=synthesize(state.sqrt_lam, state.psi, xi))
