"""Voronoi quantization of the stochastic (KL-latent) space.

Port of `krylov_spdes_tpu/quantization/quantizers.py` (reference:
Example12_Quantization_Functions.jl:29-60, Example13_CLVQ_Functions.jl:23-92,
Example20..._Functions.jl:56-93):

- k-means (Lloyd) on latent samples under the reference's three metrics:
  "L2-full" (√Λ-weighted), "L2-10%" (the leading modes covering 10% of the
  eigenvalue mass), "cdf" (the Gaussian CDF transform); a Lloyd sweep is
  one (ns, P) distance product and one one-hot product;
- CLVQ (competitive-learning VQ), a loop over the sample stream in order
  with the gain sequence γ_t = γ0·α/(t^c + β) (Example13:45-51);
- the deterministic ±s grid codebook (Example20:56-80);
- distortion, the mean squared distance to the nearest centroid.

Where the JAX package draws from `jax.random`, these take a
`torch.Generator` or the drawn values themselves (`idx0=`, `X=`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve


def _transform(X, lam, distance):
    """Map latent N(0,1) samples X (ns, m) into the quantization metric
    space. Returns (Xt, inv), inv mapping centroids back to ξ-space."""
    lam = torch.as_tensor(lam, dtype=X.dtype, device=X.device)
    if distance == "L2-full":
        s = torch.sqrt(lam)
        return X * s, lambda C: C / s
    if distance == "L2-10%":
        # the reference thresholds the raw cumsum at 0.1 (Example12:45,
        # `findfirst(x -> x >= 0.1, cumsum(Λ))`)
        csum = np.cumsum(lam.cpu().numpy())
        k = min(int(np.searchsorted(csum, 0.1) + 1), len(csum))
        s = torch.sqrt(lam[:k])
        return X[:, :k] * s, lambda C: C / s
    if distance in ("cdf", "cdf-full"):
        return (torch.special.ndtr(X),
                lambda C: torch.special.ndtri(C.clamp(1e-12, 1 - 1e-12)))
    raise ValueError(f"unknown distance {distance!r}")


def _sq_dists(X, C):
    """(ns, P) squared distances, expanded as the JAX package does."""
    return (torch.sum(X ** 2, 1)[:, None] - 2 * X @ C.T
            + torch.sum(C ** 2, 1)[None, :])


def _lloyd(Xt, C0, iters: int):
    """`iters` Lloyd sweeps from C0. Returns (C, mean cost of each sweep)."""
    C, hist = C0, []
    for _ in range(iters):
        d2 = _sq_dists(Xt, C)
        one = F.one_hot(torch.argmin(d2, dim=1), C.shape[0]).to(Xt.dtype)
        counts = one.sum(0)
        sums = one.T @ Xt
        C = torch.where(counts[:, None] > 0, sums / counts[:, None], C)
        hist.append(torch.min(d2, dim=1).values.mean())
    return C, torch.stack(hist)


def kmeans(X, P: int, iters: int = 50, generator=None, idx0=None):
    """Lloyd k-means on pre-transformed samples X (ns, m), from the P
    samples idx0 (distinct indices; drawn without replacement from
    `generator`, seeded 0 when None, as the JAX package's default key).
    Returns (C, the last sweep's cost)."""
    if idx0 is None:
        if generator is None:
            generator = torch.Generator(device=X.device).manual_seed(0)
        idx0 = torch.randperm(X.shape[0], generator=generator,
                              device=X.device)[:P]
    idx0 = torch.as_tensor(idx0, dtype=torch.int64, device=X.device)
    C, hist = _lloyd(X, X[idx0], iters)
    return C, hist[-1]


def get_quantizer(n: int, P: int, lam, distance: str = "L2-full",
                  generator=None, iters: int = 50, X=None, idx0=None,
                  device=None, dtype=None):
    """Sample n latent points (standard normal from `generator`, or the
    given X (n, m)), k-means them under `distance` (get_quantizer,
    Example12:29-60); the k-means start is drawn from the same generator
    (seeded 987654321 when None, as the JAX package's default key) unless
    idx0 is given. Returns (X, the centroids in ξ-space, the assignment of
    each sample, its squared distance)."""
    device, dtype = resolve(device, dtype)
    if generator is None and (X is None or idx0 is None):
        generator = torch.Generator(device=device).manual_seed(987_654_321)
    if X is None:
        X = torch.randn(n, len(lam), generator=generator, dtype=dtype,
                        device=device)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    Xt, inv = _transform(X, lam, distance)
    C, _ = kmeans(Xt, P, iters=iters, generator=generator, idx0=idx0)
    d2 = _sq_dists(Xt, C)
    return X, inv(C), torch.argmin(d2, dim=1), torch.min(d2, dim=1).values


def get_gain_sequence(g0: float, alpha: float, beta: float, c: float,
                      ns: int, device=None, dtype=None):
    """γ_t = γ0·α/(t^c + β), t = 1..ns (Example13_CLVQ_Functions.jl:45-51)."""
    device, dtype = resolve(device, dtype)
    t = torch.arange(1, ns + 1, dtype=dtype, device=device)
    return g0 * alpha / (t ** c + beta)


def clvq(X, C0, gains):
    """Competitive-learning VQ: stream the samples in order, pulling the
    winning centroid towards each (Example13:71-92). X (ns, m), C0 (P, m),
    gains (ns,). Returns (C, the winner's squared distance at each step).
    A host loop of ns steps (the JAX package's `lax.scan`)."""
    C = C0.clone()
    costs = []
    for x, g in zip(X, gains):
        d2 = torch.sum((C - x[None, :]) ** 2, dim=1)
        p = torch.argmin(d2)
        C[p] = C[p] + (-g * (C[p] - x))
        costs.append(d2[p])
    return C, torch.stack(costs)


def distortion(X, C):
    """Mean squared distance to the nearest centroid (Example13:54-69)."""
    return torch.mean(torch.min(_sq_dists(X, C), dim=1).values)


def deterministic_grid(nKL: int, s: float, lam):
    """±s hypercube codebook and its centre (get_deterministic_grid,
    Example20:56-80), on the host. Returns (eta (P, nKL) √Λ-scaled,
    xi (P, nKL))."""
    P = 2 ** nKL + 1
    xi = np.zeros((P, nKL))
    for p in range(1, P):
        bits = np.array([(p - 1) >> (nKL - 1 - k) & 1 for k in range(nKL)])
        xi[p] = np.where(bits == 0, -s, s)
    lam = lam.cpu().numpy() if torch.is_tensor(lam) else np.asarray(lam)
    eta = np.sqrt(lam[:nKL]) * xi
    return eta, xi


def nearest_centroid(xi, centroids_xi, lam):
    """√Λ-weighted nearest centroid of a latent point (Example12:146-153).
    centroids_xi (P, m) in ξ-space, xi (m,). Returns (index, distance)."""
    w = torch.sqrt(torch.as_tensor(lam, dtype=xi.dtype, device=xi.device))
    d2 = torch.sum(((centroids_xi - xi[None, :]) * w[None, :]) ** 2, dim=1)
    p = torch.argmin(d2)
    return p, torch.sqrt(d2[p])
