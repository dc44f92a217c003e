"""Smoothed-aggregation AMG where every level is a 9-point stencil operator:
setup and apply on the device, no gathers.

Port of `krylov_spdes_tpu/precond/stencil_amg.py` (reference:
AlgebraicMultigrid.jl's smoothed aggregation at Example01_EllipticPde.jl:56,
Example06_PcgStochasticEllipticPde.jl:117). On a structured (H, W) node
grid, aggregate 3 × 3 node blocks: the smoothed prolongator
P = (I − σ D⁻¹A) T has a 5 × 5 footprint per coarse node, so the Galerkin
coarse operator A_c = PᵀAP couples only neighbouring aggregates and is
another 9-point stencil on the (⌈H/3⌉, ⌈W/3⌉) grid, at every level. Every
smoother sweep, restriction and prolongation is plane arithmetic.

The setup is a computation on the planes' values alone (a rebuild per
realization reads no host data): σ = ω / ρ(D⁻¹A) by a power method from a
fixed start; the 9 coarse planes are extracted by applying the matrix-free
PᵀAP to the 9 mod-3 comb vectors (the coarse stencil reaches ±1 < 3, so
each application reveals one coefficient a node); the coarsest level is
materialised, factorised and inverted explicitly.

Dirichlet nodes (identity rows of the stencil operator) get zero
aggregation weight (a `live` mask through the levels), so coarse
corrections never touch them, and blocks with no live node get an identity
diagonal on the coarse level.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stencil import OFFSETS, StencilOp


def _plane_matvec(planes, x2):
    """y = A x for a 9-plane stencil (planes (9, H, W), the full diagonal in
    planes[0]) over x2 (..., H, W)."""
    H, W = x2.shape[-2:]
    xp = F.pad(x2, (1, 1, 1, 1))
    y = planes[0] * x2
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        y = y + planes[k] * xp[..., 1 + di:1 + di + H, 1 + dj:1 + dj + W]
    return y


def _upsample3(xc, H: int, W: int):
    return xc.repeat_interleave(3, dim=-2).repeat_interleave(3, dim=-1)[
        ..., :H, :W]


def _downsample3(xf):
    H, W = xf.shape[-2:]
    Hp, Wp = -(-H // 3) * 3, -(-W // 3) * 3
    xp = F.pad(xf, (0, Wp - W, 0, Hp - H))
    return xp.reshape(*xf.shape[:-2], Hp // 3, 3, Wp // 3, 3).sum(
        dim=(-3, -1))


def _power_rho(planes, dinv, iters: int = 12):
    """ρ(D⁻¹A) by a fixed number of power iterations from a fixed start."""
    H, W = dinv.shape
    v_np = np.sin(0.7 * np.arange(H * W) + 0.3).reshape(H, W)
    v = torch.as_tensor(v_np / np.linalg.norm(v_np), dtype=dinv.dtype,
                        device=dinv.device)
    lam = torch.ones((), dtype=dinv.dtype, device=dinv.device)
    for _ in range(iters):
        w = dinv * _plane_matvec(planes, v)
        lam = torch.linalg.vector_norm(w)
        v = w / (lam + 1e-30)
    return lam


def _level_ops(planes, dinv, sigma, wf, H: int, W: int):
    """Matrix-free P, Pᵀ and A_c applies of one level (wf: the live
    upsampling weights)."""
    def P_apply(xc):
        u = _upsample3(xc, H, W) * wf
        return u - sigma * dinv * _plane_matvec(planes, u)

    def Pt_apply(xf):
        return _downsample3(
            (xf - sigma * _plane_matvec(planes, dinv * xf)) * wf)

    def Ac_apply(xc):
        return Pt_apply(_plane_matvec(planes, P_apply(xc)))

    return P_apply, Pt_apply, Ac_apply


def _extract_coarse_planes(Ac_apply, Hc: int, Wc: int, like):
    """The 9 coarse stencil planes from 9 comb applications:
    plane_k[X, Y] = (A_c e_{a,b})[X, Y] with a = (X + di_k) % 3,
    b = (Y + dj_k) % 3; the selection factorises over rows and columns
    into two small einsums."""
    xr = np.arange(Hc) % 3
    yr = np.arange(Wc) % 3
    rowmask = np.arange(3)[:, None] == xr[None, :]              # (3, Hc)
    colmask = np.arange(3)[:, None] == yr[None, :]              # (3, Wc)
    t = lambda a: torch.as_tensor(a.astype(np.float64),  # noqa: E731
                                  dtype=like.dtype, device=like.device)
    combs = t((rowmask[:, None, :, None] * colmask[None, :, None, :])
              .reshape(9, Hc, Wc))
    ys = Ac_apply(combs).reshape(3, 3, Hc, Wc)
    rowsel = np.zeros((9, 3, Hc))
    colsel = np.zeros((9, 3, Wc))
    for k, (di, dj) in enumerate(OFFSETS):
        rowsel[k, (xr + di) % 3, np.arange(Hc)] = 1.0
        colsel[k, (yr + dj) % 3, np.arange(Wc)] = 1.0
    s = torch.einsum("kax,abxy->kbxy", t(rowsel), ys)
    return torch.einsum("kby,kbxy->kxy", t(colsel), s)


def stencil_amg_setup(planes, live, H: int, W: int, *, max_coarse: int = 100,
                      max_levels: int = 12, omega: float = 4.0 / 3.0):
    """Build the all-stencil SA-AMG hierarchy on the planes' device.

    planes: (9, H, W) stiffness planes with the full diagonal in planes[0]
            (the identity rows of Dirichlet nodes included);
    live:   (H, W) 1 on free nodes, 0 on Dirichlet nodes."""
    levels = []
    while (H * W > max_coarse and len(levels) < max_levels - 1
           and min(H, W) >= 3):
        Hc, Wc = -(-H // 3), -(-W // 3)
        dinv = 1.0 / planes[0]
        sigma = omega / _power_rho(planes, dinv)
        counts = _downsample3(live)
        wf = live * _upsample3(
            torch.where(counts > 0,
                        1.0 / torch.sqrt(torch.clamp(counts, min=1.0)), 0.0),
            H, W)
        _, _, Ac_apply = _level_ops(planes, dinv, sigma, wf, H, W)
        planes_c = _extract_coarse_planes(Ac_apply, Hc, Wc, planes)
        # empty aggregates (all-Dirichlet 3 × 3 blocks) become identity rows
        planes_c[0] += (counts == 0).to(planes.dtype)
        levels.append(dict(planes=planes, dinv=dinv, sigma=sigma, wf=wf))
        planes, live, H, W = planes_c, (counts > 0).to(planes.dtype), Hc, Wc
    # the coarsest level, materialised and inverted explicitly: its solve
    # in the V-cycle is one (n, n) product
    n = H * W
    eye = torch.eye(n, dtype=planes.dtype, device=planes.device)
    Acoarse = _plane_matvec(planes, eye.reshape(n, H, W)).reshape(n, n)
    Areg = Acoarse.T + 1e-6 * torch.trace(Acoarse) / n * eye
    L = torch.linalg.cholesky(Areg)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return dict(levels=tuple(levels), coarse_inv=Linv.T @ Linv)


def _vcycle(npre, npost, shapes, hier, r):
    """One V-cycle; `shapes` holds (H, W) of every level, the coarsest
    included."""
    levels = hier["levels"]

    def smooth(lev, x, b, nsweep):
        for _ in range(nsweep):
            x = x + lev["sigma"] * lev["dinv"] * (
                b - _plane_matvec(lev["planes"], x))
        return x

    def down(level, b):
        if level == len(levels):
            return (hier["coarse_inv"] @ b.reshape(-1)).reshape(b.shape)
        lev = levels[level]
        H, W = shapes[level]
        P_apply, Pt_apply, _ = _level_ops(lev["planes"], lev["dinv"],
                                          lev["sigma"], lev["wf"], H, W)
        x = smooth(lev, torch.zeros_like(b), b, npre)
        xc = down(level + 1, Pt_apply(b - _plane_matvec(lev["planes"], x)))
        x = x + P_apply(xc)
        return smooth(lev, x, b, npost)

    H0, W0 = shapes[0]
    return down(0, r.reshape(H0, W0)).reshape(-1)


def _hier_shapes(H: int, W: int, n_levels: int):
    shapes = [(H, W)]
    for _ in range(n_levels):
        H, W = -(-H // 3), -(-W // 3)
        shapes.append((H, W))
    return tuple(shapes)


def stencil_amg_precond(S: StencilOp, *, max_coarse: int = 100,
                        max_levels: int = 12, omega: float = 4.0 / 3.0,
                        npre: int = 1, npost: int = 1):
    """SA-AMG preconditioner of a StencilOp (AMGPreconditioner analogue,
    Example01_EllipticPde.jl:56); call it again on a refilled StencilOp
    (`with_csr_data`) to rebuild per realization on the device."""
    planes = S.planes.clone()
    planes[0] += S.dir_diag
    hier = stencil_amg_setup(planes, 1.0 - S.dir_diag, S.H, S.W,
                             max_coarse=max_coarse, max_levels=max_levels,
                             omega=omega)
    shapes = _hier_shapes(S.H, S.W, len(hier["levels"]))
    return functools.partial(_vcycle, npre, npost, shapes, hier)
