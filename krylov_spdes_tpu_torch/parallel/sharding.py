"""The (dom × chain) mesh of ranks and its collectives.

Port of `krylov_spdes_tpu/parallel/sharding.py`, the replacement of the
reference's Julia Distributed master-worker layer (SURVEY.md §2.2). The two
units of distribution are

- the `dom` axis of the batched DD blocks (subdomain task parallelism, P3):
  local Schur work runs where its blocks live and the Γ scatter-add becomes
  a sum over ranks, the halo exchange the reference only sketched (P5,
  Fem/EllipticPdePllDomainDecomposition.jl:1-19);
- the `chain` axis of embarrassingly parallel MCMC chains (P4).

JAX is single-controller: one process runs `shard_map` over a device mesh
and `lax.psum` is the collective. `torch.distributed` is multi-controller:
every rank runs the same program on its shard. So:

- `Mesh` lays the ranks out as `jax.devices().reshape(n_dom, n_chain)` does:
  rank r sits at dom r // n_chain and chain r % n_chain, with one process
  group for each row and column.
- `psum` is an all-gather over the axis's group followed by a sum in rank
  order, not an `all_reduce`, whose ring order differs between NCCL and
  gloo and between world sizes: every rank gets the same bits, and a run
  repeats bit for bit. Its operands are Γ-sized vectors or the reduced KL
  matrix, so the gathered copy is cheap; the mesh counts the calls and the
  bytes each rank receives.
- Global in, global out: a sharded step takes the whole state on every
  rank and returns it whole on every rank (`all_gather_cat`), as a JAX
  global array is whole to its caller.

gloo runs these collectives on CUDA tensors itself (it stages them through
host memory), so no collective here copies to the host by hand.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch
import torch.distributed as dist

from ..fem.schur import gamma_gather_table

AXES = ("dom", "chain")


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (dom × chain) grid of the default process
    group, and its process group along each axis."""
    n_dom: int
    n_chain: int
    rank: int
    groups: dict          # axis -> the group of this rank's row or column
    psum_calls: int = 0
    psum_bytes: int = 0   # received by this rank, its own part included

    @property
    def shape(self) -> dict:
        return {"dom": self.n_dom, "chain": self.n_chain}

    @property
    def size(self) -> int:
        return self.n_dom * self.n_chain

    @staticmethod
    def _axes(axis) -> tuple:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        assert axes in (("dom",), ("chain",), AXES), axes
        return axes

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def index(self, axis) -> int:
        """This rank's coordinate along `axis` (both axes: row-major, the
        rank itself)."""
        coord = {"dom": self.rank // self.n_chain,
                 "chain": self.rank % self.n_chain}
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + coord[a]
        return idx

    def group(self, axis):
        axes = self._axes(axis)
        return dist.group.WORLD if axes == AXES else self.groups[axes[0]]

    def block(self, axis, n: int) -> slice:
        """This rank's contiguous share of n items split evenly along
        `axis` (`PartitionSpec(axis)`)."""
        size = self.axis_size(axis)
        assert n % size == 0, f"{n} items do not split over {size} ranks"
        per = n // size
        i = self.index(axis)
        return slice(i * per, (i + 1) * per)


def make_mesh(n_dom: int | None = None, n_chain: int = 1) -> Mesh:
    """Mesh over the ranks of the default process group. Every rank calls
    it, with the same arguments, since it creates the row and column
    groups."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_dom is None:
        n_dom = world // n_chain
    assert n_dom * n_chain == world, f"{world} ranks != {n_dom} x {n_chain}"
    members = {
        "dom": [[d * n_chain + c for d in range(n_dom)]
                for c in range(n_chain)],
        "chain": [[d * n_chain + c for c in range(n_chain)]
                  for d in range(n_dom)]}
    groups = {}
    for axis, lists in members.items():
        for ranks in lists:
            g = dist.group.WORLD if len(ranks) == world else \
                dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(n_dom=n_dom, n_chain=n_chain, rank=rank, groups=groups)


def _gather(x, mesh: Mesh, axis) -> list:
    """x of every rank along `axis`, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return parts


def psum(x, mesh: Mesh, axis="dom"):
    """Σ of x over the ranks along `axis`, summed in rank order: the same
    bits on every rank and in every run (`lax.psum`'s counterpart)."""
    parts = _gather(x, mesh, axis)
    mesh.psum_calls += 1
    mesh.psum_bytes += len(parts) * x.numel() * x.element_size()
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def all_gather_cat(x, mesh: Mesh, axis="chain"):
    """The ranks' blocks along `axis` concatenated on the leading axis, in
    rank order: a sharded result made whole on every rank."""
    return torch.cat(_gather(x, mesh, axis))


def shard_schur_operator(S, mesh: Mesh):
    """The rank's share of the batched DD blocks along the 'dom' axis, with
    its Γ gather table and a `psum` over the dom ranks: `schur_matvec`,
    `get_schur_rhs` (of a global b_I), the assembled operator and the NN
    apply of `fem/schur.py` then sum every Γ part over the ranks, so
    `pcg(S, b_s, M=prepare_neumann_neumann_schur_precond(S))` runs
    unchanged. Γ-sized tensors stay whole on every rank, as the JAX
    package keeps them replicated."""
    ndom = S.gammad_to_gamma.shape[0]
    doms = mesh.block("dom", ndom)
    local = {f.name: getattr(S, f.name)[doms] for f in dataclasses.fields(S)
             if f.name not in ("gamma_cnt", "gamma_gather")
             and isinstance(getattr(S, f.name), torch.Tensor)
             and getattr(S, f.name).shape[:1] == (ndom,)}
    return dataclasses.replace(
        S, **local, gamma_gather=gamma_gather_table(
            local["gammad_to_gamma"], local["gmask"], S.n_gamma),
        psum=partial(psum, mesh=mesh, axis="dom"), doms=doms)


def shard_dd_plan(plan, mesh: Mesh):
    """The assembly plan stays whole on every rank (the JAX package
    replicates it: element data is small beside the blocks)."""
    return plan


def replicated(x, mesh: Mesh):
    """Every rank holds all of x."""
    return x


def chain_sharded(x, mesh: Mesh):
    """This rank's block of x's leading chain axis."""
    return x[mesh.block("chain", x.shape[0])]
