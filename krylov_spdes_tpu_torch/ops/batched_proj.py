"""The deflation projections of the batched recycler as kernels of their
own: kernels F and G.

Port of `krylov_spdes_tpu/ops/batched_proj.py`. As in the JAX package no
solver calls them (`solvers/batched.py` keeps its einsums); they are entry
points of their own, the starting point if the projections ever move to a
reduced-precision G, where a custom kernel controls the cast placement.

  gemv_rows(G, r)               U[b, k] = Σ_n G[b, k, n] r[b, n]
  fused_reorth(G, C, r, m, nvec)
      t_c = Σ_k C[b, c·nvec + k] G[b, k, :]   (c = 0, 1)
      r' = r − t_0 ; z = m ⊙ r' ; t_1
      plus the r'ᵀr' and r'ᵀz reductions, in ONE pass over G's first nvec
      rows (= Wᵀ).

The CUDA kernels (`csrc/batched_proj.cu`) take any n; `pad_n` stays for
callers that pad (zero padding: contributions vanish). Each wrapper takes
its plain version for CPU tensors and launches its kernel for CUDA tensors;
`<wrapper>.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build


def pad_n(x, n_pad: int):
    """Zero-pad the trailing axis to n_pad."""
    return F.pad(x, (0, n_pad - x.shape[-1]))


def gemv_rows_plain(G, r):
    """U = G @ r batched: G (B, K, n), r (B, n) -> (B, K)."""
    return torch.sum(G * r[:, None, :], dim=-1)


def fused_reorth_plain(G, C, r, mdiag, nvec: int):
    """Plain version of kernel G, the combinations accumulated in the order
    k = 0, 1, ... as the kernel does. Returns (r', z, t1, r'ᵀr', r'ᵀz)."""
    t0 = C[:, 0, None] * G[:, 0]
    t1 = C[:, nvec, None] * G[:, 0]
    for k in range(1, nvec):
        t0 = t0 + C[:, k, None] * G[:, k]
        t1 = t1 + C[:, nvec + k, None] * G[:, k]
    rp = r - t0
    z = mdiag * rp
    return rp, z, t1, torch.sum(rp * rp, dim=1), torch.sum(rp * z, dim=1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("batched_proj")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.gemv_rows_chunks.argtypes = [cl]
    lib.gemv_rows.argtypes = [ci] + [vp] * 4 + [ci, ci, cl, vp]
    lib.fused_reorth_blocks.argtypes = [cl]
    lib.fused_reorth.argtypes = [ci] + [vp] * 9 + [ci, ci, ci, cl, vp]
    for fn in (lib.gemv_rows_chunks, lib.gemv_rows, lib.fused_reorth_blocks,
               lib.fused_reorth):
        fn.restype = ci
    return lib


def gemv_rows(G, r):
    """Kernel F on CUDA tensors, its plain version on CPU tensors."""
    if G.device.type == "cpu":
        return gemv_rows_plain(G, r)
    cuda_build.require_cuda(G, r)
    B, K, n = G.shape
    if r.shape != (B, n):
        raise ValueError(f"gemv_rows: G {tuple(G.shape)}, r {tuple(r.shape)}")
    lib = _lib()
    part = G.new_empty(B * K * lib.gemv_rows_chunks(n))
    U = G.new_empty((B, K))
    c = cuda_build.ptr
    err = lib.gemv_rows(cuda_build.dtype_code(G), c(G), c(r), c(part), c(U),
                        B, K, n, cuda_build.stream(G))
    cuda_build.check(lib, err, "gemv_rows")
    gemv_rows.launches += 1
    return U


gemv_rows.launches = 0


def fused_reorth(G, C, r, mdiag, nvec: int):
    """Kernel G on CUDA tensors, its plain version on CPU tensors.

    G (B, K >= nvec, n); C (B, 2·nvec) flat [c0 | c1]; r, mdiag (B, n).
    Returns (r', z, t1, r'ᵀr' (B,), r'ᵀz (B,))."""
    if G.device.type == "cpu":
        return fused_reorth_plain(G, C, r, mdiag, nvec)
    cuda_build.require_cuda(G, C, r, mdiag)
    B, K, n = G.shape
    if (K < nvec or C.shape != (B, 2 * nvec) or r.shape != (B, n)
            or mdiag.shape != (B, n)):
        raise ValueError(f"fused_reorth: G {tuple(G.shape)}, C "
                         f"{tuple(C.shape)}, r {tuple(r.shape)}, mdiag "
                         f"{tuple(mdiag.shape)}, nvec {nvec}")
    lib = _lib()
    rp, z, t1 = torch.empty_like(r), torch.empty_like(r), torch.empty_like(r)
    part = r.new_empty(2 * B * lib.fused_reorth_blocks(n))
    sums = r.new_empty((2, B))
    c = cuda_build.ptr
    err = lib.fused_reorth(cuda_build.dtype_code(r), c(G), c(C), c(r),
                           c(mdiag), c(rp), c(z), c(t1), c(part), c(sums), B,
                           K, nvec, n, cuda_build.stream(r))
    cuda_build.check(lib, err, "fused_reorth")
    fused_reorth.launches += 1
    return rp, z, t1, sums[0], sums[1]


fused_reorth.launches = 0
