"""The sharded Schur operator as explicit calls: the halo exchange as a
real collective.

Port of `krylov_spdes_tpu/parallel/schur_sharded.py`. The reference
sketched (and never enabled) a distributed Schur matvec (`Sx = @distributed
(+) for idom...`, Fem/EllipticPdePllDomainDecomposition.jl:1-19). Each rank
owns a dom share of the batched blocks, computes its local Γ contributions,
and the partition-of-unity sum over subdomains, the DD halo exchange, is
ONE `psum` over the dom ranks. Interface vectors (n_Γ ≪ n) stay whole on
every rank, so the collective moves only Γ-sized data.

In the JAX package this is the explicit `shard_map` twin of the
GSPMD-annotated operator of `parallel/sharding.py`. Multi-controller torch
has one form for both: the operator of `shard_schur_operator`.
"""

from __future__ import annotations

from ..fem.schur import get_schur_rhs
from .sharding import Mesh, shard_schur_operator


def sharded_schur_matvec(mesh: Mesh, S):
    """Callable x -> S x with the dom axis split over the mesh's 'dom'
    ranks and one psum as the Γ exchange."""
    return shard_schur_operator(S, mesh).matvec


def sharded_schur_rhs(mesh: Mesh, S, b_I, b_G):
    """b_schur with the interior condensation split over the dom ranks and
    one psum; b_I is the global (ndom, nI) block."""
    return get_schur_rhs(shard_schur_operator(S, mesh), b_I, b_G)
