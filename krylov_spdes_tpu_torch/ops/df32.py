"""Double-float32 (df32) arithmetic and the certified stencil residual.

Port of the stencil part of `krylov_spdes_tpu/ops/df32.py`. The TPU has no
float64, so the JAX package evaluates b − A x with error-free transforms in
float32 (TwoSum, Veltkamp-split TwoProd). Those need every product and sum
to round to float32 on its own. The JAX package's caveat (df32.py:13-23)
holds here too: nvcc contracts mul+add into an FMA unless told otherwise,
and so may a fused torch op. Eager torch elementwise ops round one by one;
`strict_f32_rounding` probes that on a device.

The H100 has native float64, so the port evaluates the certified residual
the way the JAX package does on a backend that is not strict: in float64
(`_f64`, `_split_pair`, df32.py:69-86). The df32 pair is kept for the
accumulation of x in solvers/refine.py.
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
