"""System and deflation persistence, and chain checkpoints.

Port of `krylov_spdes_tpu/utils/persistence.py` (reference:
Utils/DeflationUtils.jl:12-108, the JLD dumps of (A, b, W) of failed
deflated solves; SURVEY.md §5's checkpoint and resume). Everything is plain
NPZ with the JAX package's field names, so a system or deflated system that
either package saves loads in the other.

A chain checkpoint keeps the fields `xi, g, key, W, sample_idx, iters`. The
port's sampler carries a `torch.Generator` where the JAX package carries a
PRNG key, so `key` holds the generator's state (`get_state()`, uint8) and a
port checkpoint resumes a port chain exactly. A JAX checkpoint's `key` (a
uint32 PRNG key) cannot seed a torch generator: `load_chain_checkpoint`
refuses such a file unless the caller passes the generator to resume with
(`generator=`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _coo(A) -> dict:
    """A SparseOp's triplets under the JAX package's names and dtypes (its
    indices are int32)."""
    return dict(rows=_np(A.rows).astype(np.int32),
                cols=_np(A.indices).astype(np.int32), vals=_np(A.data))


def _dirs(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def save_system(path: str, A, b) -> None:
    """Dump a sparse system (a SparseOp) as COO triplets and its right-hand
    side (save_system analogue, DeflationUtils.jl:12-43)."""
    _dirs(path)
    np.savez(path, **_coo(A), b=_np(b), shape=np.asarray(A.shape))


def _csr(d):
    from scipy.sparse import csr_matrix
    return csr_matrix((d["vals"], (d["rows"], d["cols"])),
                      shape=tuple(d["shape"]))


def load_system(path: str):
    """Returns (scipy csr_matrix, b) on the host, as the JAX package does
    (`ops.sparse.from_scipy` puts A on a device)."""
    d = np.load(path)
    return _csr(d), d["b"]


def save_deflated_system(path: str, A, b, W) -> None:
    """(A, b, W) failure fixture (save_deflated_system,
    DeflationUtils.jl:46-78)."""
    _dirs(path)
    np.savez(path, **_coo(A), b=_np(b), W=_np(W), shape=np.asarray(A.shape))


def load_deflated_system(path: str):
    d = np.load(path)
    return _csr(d), d["b"], d["W"]


def save_chain_checkpoint(path: str, sampler_state, W, sample_idx: int,
                          iters) -> None:
    """Checkpoint an MCMC chain: the latent state, the generator's state
    (under `key`) and the deflation basis."""
    _dirs(path)
    np.savez(path,
             xi=_np(sampler_state.xi),
             g=_np(sampler_state.g),
             key=sampler_state.gen.get_state().numpy(),
             W=_np(W),
             sample_idx=sample_idx,
             iters=_np(iters))


def load_chain_checkpoint(path: str, template_state, generator=None):
    """Restore into a SamplerState with the template's static fields, on its
    device and in its dtype. Returns (state, W, sample_idx, iters), W a
    tensor beside the state.

    The state's generator is restored from `key` when the file holds a
    torch generator's state. A file saved by the JAX package holds a PRNG
    key instead, which no torch generator can continue: it raises
    ValueError unless `generator` is given, which then becomes the state's
    (as does a given generator for a port checkpoint)."""
    d = np.load(path)
    if generator is None:
        key = d["key"]
        if key.dtype != np.uint8:
            raise ValueError(
                f"{path}: 'key' is a {key.dtype} PRNG key of the JAX "
                "package, not a torch generator's state; pass generator= "
                "to resume this chain with a torch generator")
        generator = torch.Generator(device=template_state.xi.device)
        generator.set_state(torch.from_numpy(key.copy()))
    ref = template_state.xi
    t = lambda a: torch.as_tensor(a, dtype=ref.dtype, device=ref.device)  # noqa: E731
    state = dataclasses.replace(template_state, xi=t(d["xi"]), g=t(d["g"]),
                                gen=generator)
    W = torch.as_tensor(d["W"], device=ref.device)
    return state, W, int(d["sample_idx"]), d["iters"]
