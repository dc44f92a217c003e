"""Carry the JAX package's state over to the port.

The JAX package's dataclasses and the port's share their field names, so
state crosses as a dict of numpy arrays: `numpy_fields(obj)` reads one from
either side (a JAX array or a torch tensor becomes a numpy array, static
fields stay as they are), and the constructors below build the port's
object from one. A round trip port → numpy_fields → port is exact.

    St = convert.stencil_op(**convert.numpy_fields(St_jax), device="cpu")
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import resolve
from .dd_chains import ShardedDDPlan
from .fem.bc import DirichletMaps
from .fem.dd import DDAssemblyPlan, DDPartition
from .fem.dd_stencil import DDStencilPlan
from .fem.schur import SchurOperator, SchurOperatorBT
from .fem.stencil_assembly import StencilAssemblyPlan
from .ops.fused_cg import PaddedStencil, build_padded_stencil
from .ops.sparse import SparseOp
from .ops.stencil import StencilOp


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "__array__"):
        return np.asarray(v)
    return v


def numpy_fields(obj) -> dict:
    """{field name: numpy array or static value} of a dataclass instance."""
    return {f.name: _np(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _val(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _idx(a, device):
    return torch.tensor(np.asarray(a).astype(np.int64), device=device)


def stencil_op(planes, dir_diag, slot, H, W, device=None, dtype=None) -> StencilOp:
    device, dtype = resolve(device, dtype)
    return StencilOp(planes=_val(planes, device, dtype),
                     dir_diag=_val(dir_diag, device, dtype),
                     slot=_idx(slot, device), H=int(H), W=int(W))


def stencil_assembly_plan(factors, bfactors, b_fixed, dir_diag, free_mask, H,
                          W, terms, bterms, device=None,
                          dtype=None) -> StencilAssemblyPlan:
    device, dtype = resolve(device, dtype)
    v = lambda a: _val(a, device, dtype)  # noqa: E731
    return StencilAssemblyPlan(
        factors=v(factors), bfactors=v(bfactors), b_fixed=v(b_fixed),
        dir_diag=v(dir_diag), free_mask=v(free_mask), H=int(H), W=int(W),
        terms=tuple(tuple(int(e) for e in t) for t in terms),
        bterms=tuple(tuple(int(e) for e in t) for t in bterms))


def sparse_op(data, indptr, indices, rows, ell_idx, ell_cols, n_rows, n_cols,
              device=None, dtype=None) -> SparseOp:
    device, dtype = resolve(device, dtype)
    return SparseOp(data=_val(data, device, dtype),
                    indptr=_idx(indptr, device), indices=_idx(indices, device),
                    rows=_idx(rows, device), ell_idx=_idx(ell_idx, device),
                    ell_cols=_idx(ell_cols, device), n_rows=int(n_rows),
                    n_cols=int(n_cols))


def dirichlet_maps(free_g2l, dir_g2l, free_l2g, dir_l2g,
                   is_dirichlet) -> DirichletMaps:
    """Host-side numpy index maps, as in both packages."""
    return DirichletMaps(np.asarray(free_g2l), np.asarray(dir_g2l),
                         np.asarray(free_l2g), np.asarray(dir_l2g),
                         np.asarray(is_dirichlet))


def dd_partition(**fields) -> DDPartition:
    """Host-side numpy index tables, as in both packages:
    `dd_partition(**numpy_fields(part_j))`."""
    names = {f.name for f in dataclasses.fields(DDPartition)}
    return DDPartition(**{k: (np.asarray(v) if isinstance(v, np.ndarray)
                              else int(v))
                          for k, v in fields.items() if k in names})


_DD_INDEX = {"cells", "eflat", "tgt", "tgt_dom", "tgt_loc", "bI_slot", "bI_elem",
             "bG_slot", "bG_elem", "sizes_I", "sizes_G", "h_arr", "w_arr",
             "gg_tgt", "gg_ceidx", "gamma_idx", "ig_src", "ig_tgt", "g2g",
             "gammad_to_gamma", "perm", "iperm", "idx_D", "idx_E", "sel_D",
             "sel_E"}


def _dd_fields(cls, fields, device, dtype):
    """The constructor arguments of `cls` from a dict of numpy fields:
    index tables as int64, values in `dtype`, static fields as they are,
    derived fields (rebuilt by the port's `__post_init__`) dropped."""
    out = {}
    for f in dataclasses.fields(cls):
        if not f.init or f.name not in fields:
            continue
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            out[f.name] = (_idx(v, device) if f.name in _DD_INDEX
                           else _val(v, device, dtype))
        elif isinstance(v, (tuple, list)):
            out[f.name] = tuple(int(e) for e in v)
        elif v is not None and not dataclasses.is_dataclass(v):
            out[f.name] = int(v)
    return out


def dd_assembly_plan(device=None, dtype=None, **fields) -> DDAssemblyPlan:
    """The general DD refill plan from the numpy fields of the JAX package's
    (`dd_assembly_plan(**numpy_fields(plan_j))`); the (tgt_dom, tgt_loc)
    pairs carry across as they are."""
    device, dtype = resolve(device, dtype)
    return DDAssemblyPlan(**_dd_fields(DDAssemblyPlan, fields, device, dtype))


def sharded_dd_plan(device=None, dtype=None, **fields):
    """The port's ShardedDDPlan from the numpy fields of the JAX package's
    (`sharded_dd_plan(**numpy_fields(splan_j))`): the padded per-shard
    tables as they are, index tables as int64."""
    device, dtype = resolve(device, dtype)
    return ShardedDDPlan(**_dd_fields(ShardedDDPlan, fields, device, dtype))


def dd_stencil_plan(device=None, dtype=None, **fields) -> DDStencilPlan:
    """The stencil DD refill plan from the numpy fields of the JAX
    package's; its `splan` field is that package's StencilAssemblyPlan (or
    its numpy fields)."""
    device, dtype = resolve(device, dtype)
    splan = fields["splan"]
    if not isinstance(splan, dict):
        splan = numpy_fields(splan)
    return DDStencilPlan(
        splan=stencil_assembly_plan(**splan, device=device, dtype=dtype),
        **_dd_fields(DDStencilPlan, fields, device, dtype))


def schur_operator(device=None, dtype=None, **fields):
    """The port's SchurOperator (dense interior factors, field `A_II_L`) or
    SchurOperatorBT (block-tridiagonal factors, fields `Linv`, `G`) from the
    numpy fields of the JAX package's."""
    device, dtype = resolve(device, dtype)
    cls = SchurOperatorBT if "Linv" in fields else SchurOperator
    return cls(**_dd_fields(cls, fields, device, dtype))


def padded_stencil(planes, dir_diag, H, W, sym=None, device=None,
                   dtype=None) -> PaddedStencil:
    """The port's PaddedStencil from the 9-plane source of the JAX package's
    (the two layouts differ: the TPU's is pre-blocked in 8-row/128-lane
    tiles, Hopper's is not). `sym` as in build_padded_stencil."""
    return build_padded_stencil(
        stencil_op(planes, dir_diag, np.zeros(0, np.int64), H, W, device,
                   dtype), sym=sym)


def sampler_state(xi, g, sqrt_lam, psi, kind, m_mcmc, sigma2, seed=0,
                  key=None, device=None, dtype=None):
    """The port's SamplerState from the numpy fields of the JAX package's
    (`sampler_state(**numpy_fields(state_j))`). The JAX key has no
    counterpart and is dropped: the state's generator is seeded with
    `seed`."""
    from .samplers.samplers import SamplerState, make_generator
    device, dtype = resolve(device, dtype)
    v = lambda a: _val(a, device, dtype)  # noqa: E731
    return SamplerState(xi=v(xi), g=v(g), gen=make_generator(seed, device),
                        sqrt_lam=v(sqrt_lam), psi=v(psi), kind=str(kind),
                        m_mcmc=int(m_mcmc), sigma2=float(sigma2))


def deflation_basis(W, device=None, dtype=None) -> torch.Tensor:
    """A deflation basis W (n, nvec) as a contiguous tensor of the port."""
    device, dtype = resolve(device, dtype)
    return _val(W, device, dtype).contiguous()


def padded_grids(ps: PaddedStencil, rows, device=None, dtype=None):
    """Full-grid vectors → the port's padded layout.

    rows: (k, n) array of k full-grid vectors: the G, A1, B or V operands of
    a stretch (or one vector, k = 1), each taken off the JAX package's
    8-row/128-lane padded layout with that package's `unpad_vec`. Returns a
    (k, R, C) tensor on the port's layout, through the port's `pad_vec`."""
    from .ops.fused_cg import pad_vec
    device, dtype = resolve(device, dtype)
    return torch.stack([pad_vec(ps, _val(row, device, dtype))
                        for row in np.asarray(rows)])


def full_rows(ps: PaddedStencil, grids) -> np.ndarray:
    """The inverse of `padded_grids`: (k, R, C) padded grids of the port →
    (k, n) numpy full-grid vectors, through the port's `unpad_vec`."""
    from .ops.fused_cg import unpad_vec
    return np.stack([_np(unpad_vec(ps, g)) for g in grids])


def banded_op(D, E, perm, iperm, n, m, device=None, dtype=None):
    """The port's BandedOp from the numpy fields of the JAX package's
    (`banded_op(**numpy_fields(op_j))`)."""
    from .ops.banded import BandedOp
    device, dtype = resolve(device, dtype)
    return BandedOp(D=_val(D, device, dtype), E=_val(E, device, dtype),
                    perm=_idx(perm, device), iperm=_idx(iperm, device),
                    n=int(n), m=int(m))


def amg_hierarchy(levels, coarse_L, perm0=None, device=None, dtype=None):
    """The port's AMG hierarchy (`precond/amg.py::amg_setup`'s dict) from the
    JAX package's: its levels (dicts of A, P, R and dinv; A a SparseOp, or a
    BandedOp in a banded hierarchy, either as the JAX object or its numpy
    fields), the coarse Cholesky factor and, for a banded hierarchy, perm0 =
    (perm, iperm) of level 0."""
    device, dtype = resolve(device, dtype)

    def op(a):
        f = a if isinstance(a, dict) else numpy_fields(a)
        return (banded_op if "D" in f else sparse_op)(**f, device=device,
                                                      dtype=dtype)

    return dict(levels=tuple(dict(A=op(lev["A"]), P=op(lev["P"]),
                                  R=op(lev["R"]),
                                  dinv=_val(lev["dinv"], device, dtype))
                             for lev in levels),
                coarse_L=_val(coarse_L, device, dtype),
                perm0=None if perm0 is None else tuple(
                    _idx(_np(p), device) for p in perm0))


def banded_interior_tables(perm, iperm, nb, m, bw):
    """The port's BandedInteriorTables (host tables, as in both packages)
    from the numpy fields of the JAX package's."""
    from .fem.dd_banded import BandedInteriorTables
    return BandedInteriorTables(perm=np.asarray(perm), iperm=np.asarray(iperm),
                                nb=int(nb), m=int(m), bw=np.asarray(bw))


def schur_operator_banded(device=None, dtype=None, **fields):
    """The port's SchurOperatorBandedInt from the numpy fields of the JAX
    package's."""
    from .fem.dd_banded import SchurOperatorBandedInt
    device, dtype = resolve(device, dtype)
    return SchurOperatorBandedInt(**_dd_fields(SchurOperatorBandedInt, fields,
                                               device, dtype))


def banded_refill_plan(device=None, dtype=None, **fields):
    """The port's BandedRefillPlan from the numpy fields of the JAX
    package's; its fixed-order scatters are derived on construction."""
    from .fem.dd_banded import BandedRefillPlan
    device, dtype = resolve(device, dtype)
    return BandedRefillPlan(**_dd_fields(BandedRefillPlan, fields, device,
                                         dtype))


def lorasc_state(E, Sig, S, part, maps, LG):
    """The port's LORASC apply on the port's SchurOperator S from the
    correction pairs E (n_Γ, nev), weights Sig and dense A_ΓΓ Cholesky
    factor LG of a JAX package build (the `E`, `Sig` and `gamma_solve`
    arguments of its apply), in S's dtype and on its device."""
    from functools import partial
    from .precond.dd_preconds import _dense_gamma_solve, lorasc_from_state
    dev, dt = S.A_IG.device, S.A_IG.dtype
    return lorasc_from_state(S, part, maps,
                             partial(_dense_gamma_solve, _val(LG, dev, dt)),
                             _val(E, dev, dt), _val(Sig, dev, dt))


def block_jacobi_plan(sel, blk, ii, jj, starts, sizes, nb, bmax, n,
                      device=None):
    """The port's BlockJacobiPlan from the numpy fields of the JAX
    package's (`block_jacobi_plan(**numpy_fields(plan_j))`)."""
    from .precond.block_jacobi import BlockJacobiPlan
    device, _ = resolve(device)
    return BlockJacobiPlan(sel=_idx(sel, device), blk=_idx(blk, device),
                           ii=_idx(ii, device), jj=_idx(jj, device),
                           starts=np.asarray(starts), sizes=np.asarray(sizes),
                           nb=int(nb), bmax=int(bmax), n=int(n))


def recycler(W, sample_idx=0, healthy=True, device=None, dtype=None):
    """The port's Recycler from the numpy fields of the JAX package's
    (`recycler(**numpy_fields(rec_j))`)."""
    from .solvers.recycler_state import Recycler
    return Recycler(W=deflation_basis(W, device, dtype),
                    sample_idx=int(sample_idx), healthy=bool(healthy))


def kl_subdomains(ndom, n_max, nodes, node_mask, n_nodes, centers, areas,
                  M_local, cnt, device=None, dtype=None):
    """The port's KLSubdomains from the numpy fields of the JAX package's:
    host tables as numpy, the local mass matrices on `device`."""
    from .kl.dd import KLSubdomains
    device, dtype = resolve(device, dtype)
    return KLSubdomains(ndom=int(ndom), n_max=int(n_max),
                        nodes=np.asarray(nodes),
                        node_mask=np.asarray(node_mask),
                        n_nodes=np.asarray(n_nodes),
                        centers=np.asarray(centers), areas=np.asarray(areas),
                        M_local=_val(M_local, device, dtype),
                        cnt=np.asarray(cnt))


def kl_dom_tables(**fields):
    """The port's KLDomTables (host tables, as in both packages) from the
    numpy fields of the JAX package's."""
    from .kl.dd_device import KLDomTables
    return KLDomTables(**{f.name: (int(fields[f.name])
                                   if f.name in ("ndom", "n_max", "nel_max")
                                   else np.asarray(fields[f.name]))
                          for f in dataclasses.fields(KLDomTables)})
