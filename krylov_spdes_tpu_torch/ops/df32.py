"""Double-float32 (df32) arithmetic and the certified residuals.

Port of `krylov_spdes_tpu/ops/df32.py`. The TPU has no
float64, so the JAX package evaluates b − A x with error-free transforms in
float32 (TwoSum, Veltkamp-split TwoProd). Those need every product and sum
to round to float32 on its own. The JAX package's caveat (df32.py:13-23)
holds here too: nvcc contracts mul+add into an FMA unless told otherwise,
and so may a fused torch op. Eager torch elementwise ops round one by one;
`strict_f32_rounding` probes that on a device.

The H100 has native float64, so the port evaluates the certified residual
the way the JAX package does on a backend that is not strict: in float64
(`_f64`, `_split_pair`, df32.py:69-86), for the stencil, the ELL and the
full DD system alike. The df32 pair is kept for the accumulation of x in
solvers/refine.py; the error-free contractions (`df_contract`,
`df_matvec`) are kept for their own sake, as eager host loops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .stencil_kernel import OFFSETS

_SPLIT = 4097.0        # 2**12 + 1, Veltkamp constant for f32 (24-bit mantissa)


def strict_f32_rounding(device=None) -> bool:
    """True when torch's elementwise float32 ops on `device` round every
    product and sum: pick (a, b, h) where fma(a, b, h) and round(round(a*b)
    + h) differ, and compare a*b + h with the strictly rounded value."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=512).astype(np.float32)
    b = rng.normal(size=512).astype(np.float32)
    p = (a * b).astype(np.float32)
    h = (-p + (rng.normal(size=512) * 1e-9).astype(np.float32)).astype(
        np.float32)
    t = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    got = (t(a) * t(b) + t(h)).cpu().numpy()
    return bool(np.array_equal(got, (p + h).astype(np.float32)))


def _f64(x):
    return x.to(torch.float64)


def _split_pair(r64, like):
    """f64 value -> (hi, lo) pair in like's dtype (exact two-term split)."""
    rh = r64.to(like.dtype)
    rl = (r64 - rh.to(torch.float64)).to(like.dtype)
    return rh, rl


def two_sum(a, b):
    """s + e == a + b exactly (Knuth's branch-free TwoSum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _veltkamp(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker product, FMA-free)."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl) in df32 (Dekker/Knuth add, |xl| <= ulp(xh))."""
    sh, se = two_sum(xh, yh)
    se = se + (xl + yl)
    h = sh + se
    return h, se - (h - sh)


def df_from(x):
    return x, torch.zeros_like(x)


def df_neg(xh, xl):
    return -xh, -xl


def df_dot_accumulate(acc_h, acc_l, a, b):
    """acc += a*b elementwise in df32 (a, b plain float32 tensors)."""
    p, pe = two_prod(a, b)
    return df_add(acc_h, acc_l, p, pe)


def df_contract(A, xh, xl):
    """y = Σ_n A[..., n] · x[..., n] in df32, batched over A's leading axes.

    (xh, xl) broadcasts against A (a batched matvec passes x as
    (..., 1, n)). The hi·hi products are TwoProds and the sum a df32 sum in
    the order of n, so y carries ~n·eps² relative error. The JAX package's
    `lax.scan` over n is a host loop of eager ops here (each rounds on its
    own): meant for checks, not for a solve loop."""
    xh = torch.broadcast_to(xh, A.shape)
    xl = torch.broadcast_to(xl, A.shape)
    h = A.new_zeros(A.shape[:-1])
    lo = h
    for i in range(A.shape[-1]):
        a = A[..., i]
        h, lo = df_dot_accumulate(h, lo, a, xh[..., i])
        h, lo = df_add(h, lo, a * xl[..., i], torch.zeros_like(h))
    return h, lo


def df_matvec(A, xh, xl):
    """Batched df32 dense matvec: A (..., m, n) · x (..., n) → (..., m)."""
    return df_contract(A, xh[..., None, :], xl[..., None, :])


def ell_residual_df32(A, bh, bl, xh, xl):
    """r = b − A x for any fixed-sparsity SparseOp (its ELL view), evaluated
    in float64 and returned as a (hi, lo) pair in bh's dtype."""
    data_pad = F.pad(_f64(A.data), (0, 1))
    d = data_pad[A.ell_idx]
    x64 = _f64(xh) + _f64(xl)
    r64 = _f64(bh) + _f64(bl) - torch.sum(d * x64[A.ell_cols], dim=1)
    return _split_pair(r64, bh)


def build_gamma_pullback(gammad_to_gamma, gmask, n_gamma: int):
    """For each Γ node, the flat (dom·nG + slot) indices of the local slots
    that contribute to it, ascending, padded to the largest multiplicity
    with ndom·nG (a trailing zero slot): the inverse of the DD interface
    scatter, so that the Γ sum of `dd_residual_df32` runs in a fixed order.
    The same table as `fem/schur.py::gamma_gather_table` (host-built)."""
    from ..fem.schur import gamma_gather_table
    return gamma_gather_table(gammad_to_gamma, gmask, n_gamma)


def dd_residual_df32(A_II, A_IG, A_GGd, gammad_to_gamma, gmask, pullback,
                     b_I, b_G, uIh, uIl, uGh, uGl):
    """Full DD-system residual for the Schur-condensed solve:

        r_I = b_I − A_II u_I − A_IΓ u_Γ|d          (per subdomain)
        r_Γ = b_Γ − Σ_d scatter_d(A_IΓᵀ u_I + A_ΓΓd u_Γ|d)

    When u_I solves the interior systems exactly, ‖(r_I, r_Γ)‖ is the
    interface residual ‖b_s − S u_Γ‖, so certifying the full system is the
    stronger form of the reference's criterion. Evaluated in float64; the
    sum over subdomains runs through the pullback table in its fixed order
    (`fem/schur.py::gamma_sum`), so the residual repeats bit for bit.
    Returns ((rI_h, rI_l), (rG_h, rG_l)) in b's dtype."""
    from ..fem.schur import gamma_sum
    uI64 = _f64(uIh) + _f64(uIl)
    uG64 = _f64(uGh) + _f64(uGl)
    gm64 = _f64(gmask)
    xd64 = uG64[gammad_to_gamma] * gm64
    mv = lambda M, v: (_f64(M) @ v[..., None])[..., 0]  # noqa: E731
    rI64 = _f64(b_I) - mv(A_II, uI64) - mv(A_IG, xd64)
    sd64 = (mv(A_IG.transpose(-1, -2), uI64) + mv(A_GGd, xd64)) * gm64
    rG64 = _f64(b_G) - gamma_sum(pullback, sd64 * gm64)
    return _split_pair(rI64, b_I), _split_pair(rG64, b_G)


def stencil_residual_df32(planes, dir_diag, H: int, W: int, bh, bl, xh, xl):
    """r = b − A x for a 9-plane stencil operator, evaluated in float64.

    planes/dir_diag are in the working dtype; x and b are df32 pairs (flat
    vectors). Returns the residual as a (hi, lo) pair in bh's dtype."""
    x64 = (_f64(xh) + _f64(xl)).reshape(H, W)
    xp64 = F.pad(x64, (1, 1, 1, 1))
    acc = _f64(bh).reshape(H, W) + _f64(bl).reshape(H, W)
    p064 = _f64(planes[0]) + _f64(dir_diag)
    for k, (di, dj) in enumerate(OFFSETS):
        pk = p064 if k == 0 else _f64(planes[k])
        sh = x64 if k == 0 else xp64[1 + di:1 + di + H, 1 + dj:1 + dj + W]
        acc = acc - pk * sh
    return _split_pair(acc.reshape(-1), bh)
